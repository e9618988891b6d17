"""Shared kernel constants (counterpart of ``repro.kernels.common``)."""

from __future__ import annotations

NEG_INF = -1e30


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b

