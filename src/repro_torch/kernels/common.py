"""Shared kernel constants (counterpart of ``repro.kernels.common``), the
launch counter every ``ops.py`` wrapper bumps (and the tallies that count
a captured CUDA graph's launches once a replay), and the cost sinks a
wrapper's ``meta`` route reports its kernel's work to.

A cost sink is an object with ``add_kernel(name, flops, n_bytes)`` and
``add_collective(op, wire_bytes, raw_bytes)``: the counter of
``distributed.op_static.analyze`` while it runs.  A kernel on ``meta``
tensors launches nothing; its wrapper returns empty outputs of the right
shapes and adds its kernel's own ``cost`` to the open sinks instead."""

from __future__ import annotations

import threading

NEG_INF = -1e30

# the shards of a tensor-parallel program launch from one thread each
# (``distributed.sharding.ShardGroup``): a bare ``+= 1`` on a function
# attribute could lose counts between its read and its write
_LAUNCH_LOCK = threading.Lock()

# open launch tallies: what a captured CUDA graph launches each replay,
# counted while its capture runs the wrappers once
_TALLIES: list = []


def count_launch(wrapper, route=None, *, by: str = "route_launches") -> None:
    """Add one to ``wrapper.launches`` and, with ``route``, to
    ``getattr(wrapper, by)[route]``, under one lock; and one to the same
    key of every open tally (:func:`open_launch_tally`)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        if route is not None:
            getattr(wrapper, by)[route] += 1
        for tally in _TALLIES:
            key = (wrapper, route, by)
            tally[key] = tally.get(key, 0) + 1


def open_launch_tally() -> dict:
    """Start counting launches into a new tally, ``{(wrapper, route, by):
    n}``, until :func:`close_launch_tally`."""
    tally: dict = {}
    with _LAUNCH_LOCK:
        _TALLIES.append(tally)
    return tally


def close_launch_tally(tally: dict) -> None:
    with _LAUNCH_LOCK:
        _TALLIES.remove(tally)


def add_launches(tally: dict) -> None:
    """Count a tally's launches again, under the lock: a replay of a
    captured graph runs them without running their wrappers."""
    with _LAUNCH_LOCK:
        for (wrapper, route, by), n in tally.items():
            wrapper.launches += n
            if route is not None:
                getattr(wrapper, by)[route] += n


_COST_SINKS: list = []             # open cost sinks, innermost last


def open_cost_sink(sink) -> None:
    with _LAUNCH_LOCK:
        _COST_SINKS.append(sink)


def close_cost_sink(sink) -> None:
    with _LAUNCH_LOCK:
        _COST_SINKS.remove(sink)


def cost_sinks() -> list:
    """The open cost sinks (a copy).  With none open (every run outside
    ``op_static.analyze``) it returns at once, without the lock."""
    if not _COST_SINKS:
        return []
    with _LAUNCH_LOCK:
        return list(_COST_SINKS)


def record_kernel(wrapper, cost) -> None:
    """Add a kernel's ``cost = (flops, bytes)`` on its wrapper's name to
    every open sink (the ``meta`` route of an ``ops.py`` wrapper)."""
    flops, n_bytes = cost
    for sink in cost_sinks():
        sink.add_kernel(wrapper.__name__, flops, n_bytes)


def record_collective(op: str, wire_bytes: float, raw_bytes: float) -> None:
    """Add one collective's bytes a device (``distributed.ShardGroup``'s
    sums) to every open sink."""
    for sink in cost_sinks():
        sink.add_collective(op, wire_bytes, raw_bytes)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def attended_pairs(Sq: int, Sk: int, *, causal: bool = True,
                   window=None, q_offset: int = 0) -> int:
    """(query row, key) pairs a mask lets through: row i is position
    ``q_offset + i``; causal keeps keys at or before it, ``window`` the last
    ``window`` of those.  The useful work of a flash-style kernel."""
    import numpy as np

    if not causal:
        return Sq * Sk
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, Sk - 1)
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())
