"""Shared kernel constants (counterpart of ``repro.kernels.common``) and the
launch counter every ``ops.py`` wrapper bumps."""

from __future__ import annotations

import threading

NEG_INF = -1e30

# the shards of a tensor-parallel program launch from one thread each
# (``distributed.sharding.ShardGroup``): a bare ``+= 1`` on a function
# attribute could lose counts between its read and its write
_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, route=None, *, by: str = "route_launches") -> None:
    """Add one to ``wrapper.launches`` and, with ``route``, to
    ``getattr(wrapper, by)[route]``, under one lock."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        if route is not None:
            getattr(wrapper, by)[route] += 1


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
