"""Static cost of a program: FLOPs, bytes, collectives and peak live
memory, counted over the aten ops it dispatches on ``meta`` tensors.

Counterpart of ``repro.distributed.hlo_static``.  The reference parses a
compiled XLA module; the port runs ``fn`` once on ``meta`` tensors (shapes
and dtypes, no data, no device) inside a ``TorchDispatchMode`` that sees
every aten op, and counts:

* **flops** — 2·M·N·K for each ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``
  (einsums and ``@`` reach these), and convolutions by the reference's rule
  (2 · output elements · kernel elements a output feature; the formulas of
  ``torch.utils.flop_counter``).  No elementwise op counts, as the
  reference counts none.
* **bytes** — Σ (operand + result bytes) of every aten op, each distinct
  tensor once, except the ops that move no data: views and reshapes,
  ``empty*``, ``detach``, ``alias``, ``arange`` and the like, which mirror
  the reference's ``_NO_TRAFFIC``.  As there, a gather reads and writes its
  result (2 × result) and a scatter or ``index_put_`` its update (2 ×
  update), not the whole buffer.  In eager mode each aten op is one kernel,
  so this is the reference's "top-level instruction" rule; it is an
  **unfused upper bound**, not XLA's fused count, and is never held against
  XLA's bytes.
* **kernels** — a hand-written kernel's wrapper (``kernels/*/ops.py``) on
  ``meta`` tensors launches nothing and reports its kernel's own
  ``cost(...) -> (flops, bytes)``: the useful work (causal pairs, valid
  K/V rows) and the bytes of the bound column of PERF.md §6.
* **collectives** — the sums of a ``ShardGroup`` (``TPShardPolicy``'s two a
  layer), each shard's call its own ring all-reduce wire bytes
  2·size·(N−1)/N in ``collective_bytes`` and its size in
  ``raw_collective_bytes``.  Totals are summed over the shards, as flops
  and bytes are summed over the whole program.  An SPMD policy on a mesh
  description (``distributed.spmd``) records through the same
  ``record_collective`` what one device would send: every all-gather,
  all-reduce and, in a train step's backward, each adjoint's
  reduce-scatter or sum, so a backward's collectives are counted where
  autograd runs them.
* **peak_live_bytes** — the largest sum of live ``meta`` storages during
  the run: the arguments' storages plus every storage an op made, each
  counted from its first appearance until its last reference dies (a
  ``weakref.finalize`` on the storage; views share their base's storage,
  and tensors autograd saves keep theirs alive).  It is what a caching
  allocator would need at least, without its rounding and fragmentation.

No trip counts are needed: Python loops run every layer, which is the
counterpart of the ``while`` bodies ``hlo_static`` multiplies by their trip
counts.  The totals are of the whole program as traced (one card's view);
the dry-run divides them over a mesh's chips.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels.common import close_cost_sink, open_cost_sink
from .op_analysis import CollectiveStats, tensor_bytes

# ops that move no data: views and metadata (the reference's bitcast,
# reshape, tuple, get-tuple-element), allocation without a write
# (parameter), iota, scalar reads.  Views are also caught by
# ``OpOverload.is_view``.
_NO_TRAFFIC = {
    "_unsafe_view", "view", "reshape", "expand", "detach", "alias",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "empty_permuted", "arange", "_local_scalar_dense",
    "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size",
}
# read the gathered elements and write them: 2 x result
_GATHER = {"index", "gather", "index_select", "embedding", "take"}
# write an update into a buffer in place: 2 x update (the argument's index)
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
            "index_add_": 3, "index_copy": 3, "index_copy_": 3}
_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}


def _dot_flops(name: str, args, out) -> float:
    """2·M·N·K of a matrix product: the product of the result's dims and
    the contracted dim (the left operand's last)."""
    lhs = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _conv_flops(func, args, kwargs, out) -> float:
    """A convolution's (or its backward's) FLOPs by
    ``torch.utils.flop_counter``'s formula: 2 · output elements · the
    kernel's elements a output feature, the reference's rule."""
    from torch.utils.flop_counter import flop_registry

    return float(flop_registry[func._overloadpacket](*args, **kwargs,
                                                     out_val=out))


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0           # ring wire bytes, all devices
    raw_collective_bytes: float = 0.0       # Σ operand sizes
    collective_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    #: name -> [calls, flops, bytes] of each hand-written kernel reached
    kernels: Dict[str, list] = dataclasses.field(default_factory=dict)
    ops: int = 0                            # aten ops seen
    trace_s: float = 0.0                    # wall seconds of the run
    #: ids of the argument tensors some op read (directly or through a
    #: view); the others, unread, are what ``jax.jit`` drops from a
    #: program's arguments
    read_args: set = dataclasses.field(default_factory=set)

    def collective_stats(self) -> CollectiveStats:
        return CollectiveStats(bytes_by_op=dict(self.collective_by_op),
                               count_by_op=dict(self.collective_count))


class _Counter:
    """The cost sink of one :func:`analyze` run: the totals, the live
    storage ledger, and a dispatch mode for each thread the program runs
    on (``thread_mode``; ``ShardGroup`` enters one in its workers)."""

    def __init__(self):
        self.totals = CostTotals()
        self._lock = threading.Lock()
        self._live: Dict[int, int] = {}     # storage id -> bytes
        self._live_bytes = 0
        self._read = set()                  # storage ids some op read

    # -- live storages ---------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        storage = t.untyped_storage()
        key = storage._cdata
        with self._lock:
            if key in self._live:
                return
            n = storage.nbytes()
            self._live[key] = n
            self._live_bytes += n
            self.totals.peak_live_bytes = max(self.totals.peak_live_bytes,
                                              self._live_bytes)
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            n = self._live.pop(key, None)
            if n is not None:
                self._live_bytes -= n

    # -- the cost sink interface (kernels.common) ---------------------------
    def add_kernel(self, name: str, flops: float, n_bytes: float) -> None:
        with self._lock:
            t = self.totals
            t.flops += flops
            t.bytes += n_bytes
            row = t.kernels.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += n_bytes

    def add_collective(self, op: str, wire: float, raw: float) -> None:
        with self._lock:
            t = self.totals
            t.collective_bytes += wire
            t.raw_collective_bytes += raw
            t.collective_by_op[op] = t.collective_by_op.get(op, 0.0) + wire
            t.collective_count[op] = t.collective_count.get(op, 0) + 1

    def thread_mode(self) -> "_CountingMode":
        return _CountingMode(self)

    # -- one aten op ------------------------------------------------------
    def add_op(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        flops = 0.0
        if name in _DOTS:
            flops = _dot_flops(name, args, out)
        elif name in _CONVS:
            flops = _conv_flops(func, args, kwargs, out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n_bytes = 0
        if not (func.is_view or name in _NO_TRAFFIC):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if name in _GATHER:
                n_bytes = 2 * sum(tensor_bytes(t) for t in outs)
            elif name in _SCATTER:
                pos = _SCATTER[name]
                upd = args[pos] if len(args) > pos else None
                if not isinstance(upd, torch.Tensor):   # a scalar scatter
                    upd = args[pos - 1]
                n_bytes = 2 * tensor_bytes(upd)
            else:
                n_bytes = sum(tensor_bytes(t) for t in
                              {id(t): t for t in ins + outs}.values())
            for t in ins:
                if t.device.type == "meta":
                    self._read.add(t.untyped_storage()._cdata)
        with self._lock:
            self.totals.ops += 1
            self.totals.flops += flops
            self.totals.bytes += n_bytes
        for t in outs:
            self.track(t)


class _CountingMode(TorchDispatchMode):
    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter.add_op(func, args, kwargs, out)
        return out


def analyze(fn, *args, **kwargs) -> CostTotals:
    """Run ``fn(*args, **kwargs)`` once and count its cost.  The arguments'
    tensors should be on the ``meta`` device (``launch.cells`` makes them
    so): then nothing is computed and the kernels' wrappers take their
    ``meta`` routes."""
    counter = _Counter()
    inputs = [t for t in tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
    for t in inputs:
        counter.track(t)
    open_cost_sink(counter)
    t0 = time.perf_counter()
    try:
        with counter.thread_mode():
            out = fn(*args, **kwargs)
        del out
    finally:
        close_cost_sink(counter)
    totals = counter.totals
    totals.trace_s = time.perf_counter() - t0
    totals.read_args = {id(t) for t in inputs if t.device.type == "meta"
                        and t.untyped_storage()._cdata in counter._read}
    return totals


__all__ = ["CostTotals", "analyze"]
