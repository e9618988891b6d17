"""Architecture/shape registry.

``get_config(arch)`` / ``get_reduced(arch)`` return the full and smoke-test
configs; ``SHAPES`` holds the four assigned input-shape cells; ``CELLS``
enumerates the 40 (arch x shape) dry-run cells with their run/skip status.
"""

from __future__ import annotations

from typing import List, Tuple

from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, round_up

from . import (
    command_r_plus_104b,
    qwen3_0_6b,
    starcoder2_7b,
    qwen3_32b,
    deepseek_moe_16b,
    mixtral_8x22b,
    mamba2_370m,
    jamba_1_5_large_398b,
    qwen2_vl_72b,
    whisper_base,
)

_MODULES = {
    "command-r-plus-104b": command_r_plus_104b,
    "qwen3-0.6b": qwen3_0_6b,
    "starcoder2-7b": starcoder2_7b,
    "qwen3-32b": qwen3_32b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "mamba2-370m": mamba2_370m,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "whisper-base": whisper_base,
}

ARCHS: List[str] = list(_MODULES.keys())


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return _MODULES[arch].REDUCED


def cell_status(arch: str, shape: str) -> Tuple[bool, str]:
    """(runs, reason).  long_500k only runs for sub-quadratic-decode archs."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k KV decode is quadratic-family (DESIGN.md skip)"
    return True, ""


def cells() -> List[dict]:
    """All 40 (arch x shape) cells with run/skip status."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            runs, reason = cell_status(arch, shape)
            out.append({"arch": arch, "shape": shape, "runs": runs, "reason": reason})
    return out


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "ARCHS", "get_config", "get_reduced", "cells", "cell_status", "round_up",
]
