"""Runtime SPMD sharding over a ``torch.distributed`` process group: the
parameter placement, the activation policy and the collectives under it.

Counterpart of the runtime half of ``repro.distributed.sharding``
(``param_shardings``, ``ActivationPolicy``, ``make_policy``; its
``shard_map_compat`` has no counterpart, as every rank here runs its own
program on its own blocks, the fully manual form of ``shard_map``).  The
reference compiles one GSPMD program over a device mesh and turns each
sharding constraint into whatever collectives the partitioner picks; the
port runs one process a device (``launch.spmd.run_ranks``), each holding
this rank's block of every argument, and the policy turns the reference's
rules into explicit collectives over the sub-groups of a process mesh
(``launch.mesh.make_host_mesh``):

* **batch** over the data axes (``batch_shard``): each ("pod", "data")
  group holds only its rows, so ``"hidden"``, ``"residual"`` and
  ``"hidden_decode"`` are the identity;
* **gathers at the start of each layer** (:meth:`ActivationPolicy.layer`):
  the layer's ``"data"`` (FSDP) blocks, and any ``"model"`` block the layer
  cannot use split, are all-gathered; one gathered layer is alive at a
  time;
* **whole heads on each "model" rank** (``n_kv_heads % model == 0``):
  attention runs on the rank's heads and ``"attn_out"`` is summed over
  ``"model"``;
* **heads that do not divide "model"** (``kv_len_sharded``): q, k, v and
  ``wo`` run whole on every model rank, the decode cache's length axis is
  split over ``"model"`` (``cache_specs``), :meth:`kv_slot_update` writes
  the new row only on the rank that owns slot ``cur_pos % C``, and each
  rank's attention over its slots is merged across ``"model"`` from the
  decode kernel's ``(m, l)`` (:meth:`merge_attention`);
* **the MLP** output-channel-sharded where ``d_ff`` divides ``"model"``,
  ``"mlp_out"`` summed over it; sums are taken in f32 and cast back, as
  ``TPShardPolicy`` does;
* **vocab-parallel** embedding (:meth:`embed`: a masked local gather, then
  an f32 sum over ``"model"``: one shard contributes each row, so the sum
  is exact) and ``"logits"`` (each model rank's vocab slice, all-gathered
  over ``"model"`` before the vocab mask and ``select_token``).

On a mesh **description** (no process group: the dry-run's production
meshes) the policy issues nothing: the program is the global one, as
traced without a policy, and each hook records the collective it would
issue with the bytes one device would move (``record_collective``, read
by ``distributed.op_static``).  A collective's bytes are the ring's: an
all-reduce of S bytes over n ranks sends 2 S (n - 1) / n a rank, an
all-gather of S-byte blocks (n - 1) S.  On a process mesh the same
numbers are counted from the tensors sent, so both agree
(``tests/test_torch_spmd.py``).

gloo moves CPU tensors: a CUDA tensor goes through host memory (a copy
each way, which waits for the card); an all-gather moves raw bytes, so any
dtype travels.  Only the pure-attention dense families are covered
(:func:`policy_supported`); MoE (with its ``"moe_ecap"`` rule), SSM,
hybrid, VLM and audio are refused by name.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..kernels.common import record_collective
from ..models.attention import KVCacheView
from .sharding import (
    P, _Div, _swiglu_tp_perm, batch_shard, mesh_axis_size, param_specs,
    permute_wi, spec_map, tp_supported,
)


# ---------------------------------------------------------------------------
# Collectives over a process mesh
# ---------------------------------------------------------------------------


def ring_wire_bytes(op: str, operand_bytes: float, n: int) -> float:
    """Bytes one rank sends in a ring collective over ``n`` ranks: an
    all-reduce of an S-byte operand 2 S (n - 1) / n, an all-gather of
    S-byte blocks (n - 1) S."""
    if op == "all-gather":
        return float((n - 1) * operand_bytes)
    return 2.0 * operand_bytes * (n - 1) / n


@dataclasses.dataclass
class CollectiveLog:
    """What one rank's collectives moved, by site (a policy hook or a
    caller's label): calls, ring wire bytes (:func:`ring_wire_bytes`), and
    the host seconds spent in them on a process mesh (staging to the host
    included)."""

    count: Dict[str, int] = dataclasses.field(default_factory=dict)
    wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def add(self, site: str, wire: float) -> None:
        self.count[site] = self.count.get(site, 0) + 1
        self.wire[site] = self.wire.get(site, 0.0) + wire

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire.values())

    def reset(self) -> None:
        self.count.clear()
        self.wire.clear()
        self.seconds = 0.0


def _note(op: str, operand_bytes: float, n: int, site: str,
          log: Optional[CollectiveLog]) -> None:
    wire = ring_wire_bytes(op, operand_bytes, n)
    record_collective(op, wire, operand_bytes)
    if log is not None:
        log.add(site, wire)


_REDUCE_OPS = ("sum", "max")


def mesh_all_reduce(x: torch.Tensor, mesh, axis: str, *, op: str = "sum",
                    log: Optional[CollectiveLog] = None,
                    site: str = "all-reduce") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over the ranks along ``axis`` of
    a process mesh, a new tensor on ``x``'s device in ``x``'s dtype (the
    sum in that dtype: callers that want f32 pass f32).  ``x`` is left as
    it is."""
    import torch.distributed as dist

    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduction {op!r}; expected one of "
                         f"{_REDUCE_OPS}")
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    _note("all-reduce", x.numel() * x.element_size(), n, site, log)
    t0 = time.perf_counter()
    host = x.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(host, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group(axis))
    out = host.to(x.device)
    if log is not None:
        log.seconds += time.perf_counter() - t0
    return out


def mesh_all_gather(x: torch.Tensor, mesh, axis: str, dim: int, *,
                    log: Optional[CollectiveLog] = None,
                    site: str = "all-gather") -> torch.Tensor:
    """The ranks' blocks along ``axis`` concatenated on ``dim`` in rank
    order (every block has ``x``'s shape), on ``x``'s device.  The blocks
    travel as raw bytes, so any dtype is exact."""
    import torch.distributed as dist

    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    _note("all-gather", x.numel() * x.element_size(), n, site, log)
    t0 = time.perf_counter()
    host = x.detach().to("cpu").contiguous()
    raw = host.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=mesh.group(axis))
    out = torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                    dim=dim).to(x.device)
    if log is not None:
        log.seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Placing trees: this rank's block of each leaf, and back
# ---------------------------------------------------------------------------


def _axes(entry):
    return () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))


def block_of(leaf: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` on a process mesh, a
    new contiguous tensor.  A dimension split over a tuple of axes is split
    row-major over them, as JAX's ``PartitionSpec`` splits it."""
    out = leaf
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = math.prod(mesh_axis_size(mesh, a) for a in axes)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(
                f"{n} ranks over {axes} do not divide axis {dim} of a leaf of "
                f"shape {tuple(leaf.shape)}")
        idx = 0
        for a in axes:
            idx = idx * mesh_axis_size(mesh, a) + mesh.coord(a)
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_block(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` (:func:`block_of`'s
    inverse): all-gathers over each axis ``spec`` names, the innermost axis
    of a tuple first."""
    out = block
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            out = mesh_all_gather(out, mesh, a, dim)
    return out


def shard_tree(tree, spec_tree, mesh):
    """:func:`block_of` over a tree and its spec tree (``None`` leaves and
    ``None`` specs stay ``None``)."""
    return spec_map(lambda s, t: None if t is None else block_of(t, s, mesh),
                    spec_tree, tree)


def gather_tree(tree, spec_tree, mesh):
    """:func:`gather_block` over a tree of blocks and its spec tree."""
    return spec_map(
        lambda s, t: None if t is None else gather_block(t, s, mesh),
        spec_tree, tree)


def _wi_perm(cfg, mesh) -> Optional[np.ndarray]:
    """The column permutation of swiglu's packed ``[gate | up]`` ``wi``
    under a "model" split (``_swiglu_tp_perm``), or None where ``wi`` is
    not split over whole features (``d_ff % model != 0``: then the MLP is
    gathered whole, see :meth:`ActivationPolicy.layer`)."""
    m = mesh_axis_size(mesh, "model")
    if cfg.mlp_kind != "swiglu" or m == 1 or cfg.d_ff % m:
        return None
    return _swiglu_tp_perm(cfg.d_ff, m)


def param_shardings(cfg, mesh, params, *, fsdp: bool = True,
                    moe_ep: bool = True):
    """This rank's block of every leaf of the full parameter tree
    ``params`` (the weight bridge's or ``init_params``'s) under
    ``param_specs(cfg, mesh, fsdp=, moe_ep=)``: "model" over the width,
    "data" (FSDP) over the other dimension, replicated over "pod".
    swiglu's packed ``wi`` is first put into per-rank ``[gate_i | up_i]``
    column blocks (``_swiglu_tp_perm``), as the tensor-parallel path does:
    a plain split would hand rank 0 only gate columns.
    :func:`gather_param_shards` is its inverse."""
    perm = _wi_perm(cfg, mesh)
    if perm is not None:
        params = permute_wi(params, perm)
    return shard_tree(params, param_specs(cfg, mesh, fsdp=fsdp,
                                          moe_ep=moe_ep), mesh)


def gather_param_shards(cfg, mesh, shards, *, fsdp: bool = True,
                        moe_ep: bool = True):
    """The full parameter tree from every rank's :func:`param_shardings`
    blocks, bit for bit: all-gathers, then ``wi``'s permutation undone."""
    full = gather_tree(shards, param_specs(cfg, mesh, fsdp=fsdp,
                                           moe_ep=moe_ep), mesh)
    perm = _wi_perm(cfg, mesh)
    if perm is not None:
        full = permute_wi(full, np.argsort(perm))
    return full


# ---------------------------------------------------------------------------
# The activation policy
# ---------------------------------------------------------------------------


def policy_supported(cfg) -> Optional[str]:
    """None where :func:`make_policy` covers ``cfg``'s family, else why
    not: the pure-attention dense families only (``tp_supported``'s rule);
    MoE with its ``"moe_ecap"`` rule, SSM, hybrid, VLM and audio are the
    next item of ROADMAP.md Queue 1."""
    return tp_supported(cfg)


class ActivationPolicy:
    """The ``policy=`` of the model's prefill, ``prefill_kv`` and
    ``decode_step`` (and so of ``make_prefill_step`` and
    ``make_serve_step``) on one rank of a mesh; the module docstring says
    what each hook does.  ``log`` counts this rank's collectives
    (:class:`CollectiveLog`)."""

    def __init__(self, cfg, mesh, *, batch: int, fsdp: bool = True):
        why = policy_supported(cfg)
        if why is not None:
            raise ValueError(
                f"make_policy does not cover {cfg.name}: {why} (the policy "
                f"for the MoE, SSM, hybrid, VLM and audio families is "
                f"ROADMAP.md Queue 1's next item)")
        dv = _Div(mesh)
        self.mesh = mesh
        self.model = dv.model
        self.batch_axes = batch_shard(mesh, batch)
        self.batch_split = math.prod(mesh_axis_size(mesh, a)
                                     for a in (self.batch_axes or ()))
        self.vocab_parallel = (dv.m(cfg.vocab_padded) is not None
                               and dv.model > 1)
        self.kv_len_sharded = cfg.n_kv_heads % dv.model != 0 and dv.model > 1
        self.heads_split = dv.model > 1 and not self.kv_len_sharded
        self.mlp_split = dv.model > 1 and cfg.d_ff % dv.model == 0
        self.live = mesh.is_process_mesh
        self.log = CollectiveLog()
        # each period position's spec tree without the stacked-blocks axis,
        # and whether any of its leaves is gathered at all
        self._layer_specs = [
            spec_map(lambda s: P(*s[1:]), blk)
            for blk in param_specs(cfg, mesh, fsdp=fsdp)["blocks"]]
        self._gathers = [self._layer_gathers(sp) for sp in self._layer_specs]

    # -- issuing or recording one collective ---------------------------------
    def _local_bytes(self, x, split: int = 1, itemsize=None) -> float:
        """A device's bytes of the global activation ``x`` on a mesh
        description: its batch rows, further cut ``split`` ways, at
        ``itemsize`` bytes an element (``x``'s own by default)."""
        return (x.numel() * (itemsize or x.element_size())
                / self.batch_split / split)

    def _sum(self, x, site: str):
        """The sum over "model" of a batch-sharded activation, in f32, cast
        back to ``x``'s dtype."""
        if not self.live:
            _note("all-reduce", self._local_bytes(x, itemsize=4), self.model,
                  site, self.log)
            return x
        xf = x if x.dtype == torch.float32 else x.float()
        return mesh_all_reduce(xf, self.mesh, "model", log=self.log,
                               site=site).to(x.dtype)

    # -- hooks ---------------------------------------------------------------
    def __call__(self, x, name: str):
        if ((name == "attn_out" and self.heads_split)
                or (name == "mlp_out" and self.mlp_split)):
            return self._sum(x, name)
        if name == "logits" and self.vocab_parallel:
            if not self.live:
                _note("all-gather", self._local_bytes(x, self.model),
                      self.model, name, self.log)
                return x
            return mesh_all_gather(x, self.mesh, "model", x.dim() - 1,
                                   log=self.log, site=name)
        return x

    def layer_cfg(self, cfg):
        """The config a layer runs with: the rank's heads where they are
        split over "model", else ``cfg``."""
        if not self.heads_split:
            return cfg
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // self.model,
                                   n_kv_heads=cfg.n_kv_heads // self.model)

    def layer(self, lp: Dict[str, Any], p: int) -> Dict[str, Any]:
        """The usable parameters of one layer at period position ``p``
        from this rank's blocks: each leaf's "data" (FSDP) blocks gathered,
        then its "model" blocks where the layer cannot use them split
        (attention under ``kv_len_sharded``; an MLP whose ``d_ff`` does not
        divide "model").  On a mesh description ``lp`` is the whole layer:
        only the bytes are recorded."""
        if not self._gathers[p]:
            return lp
        specs = self._layer_specs[p]
        return {key: spec_map(
                    lambda s, t, key=key: self._gather_leaf(t, s, key),
                    specs[key], sub)
                for key, sub in lp.items()}

    def _todo(self, spec: P, key: str):
        """(dim, axis) of each gather a leaf of ``spec`` under the layer's
        ``key`` ("attn", "mlp", a norm) needs, on axes of more than one
        rank."""
        keep_model = {"attn": self.heads_split,
                      "mlp": self.mlp_split}.get(key, False)
        return [(dim, a) for dim, entry in enumerate(spec) for a in _axes(entry)
                if mesh_axis_size(self.mesh, a) > 1
                and (a == "data" or (a == "model" and not keep_model))]

    def _layer_gathers(self, specs) -> bool:
        found = []
        for key, sub in specs.items():
            spec_map(lambda s, key=key: found.extend(self._todo(s, key)), sub)
        return bool(found)

    def _gather_leaf(self, t, spec: P, key: str):
        todo = self._todo(spec, key)
        if not todo:
            return t
        split = math.prod(mesh_axis_size(self.mesh, a)
                          for entry in spec for a in _axes(entry))
        for dim, a in sorted(todo, key=lambda da: da[1] != "data"):
            n = mesh_axis_size(self.mesh, a)
            if self.live:
                t = mesh_all_gather(t, self.mesh, a, dim, log=self.log,
                                    site=f"gather-{a}")
            else:
                _note("all-gather", t.numel() * t.element_size() / split, n,
                      f"gather-{a}", self.log)
            split //= n
        return t

    def embed(self, table, ids):
        """The vocab-parallel lookup of ``ids`` in this rank's rows of the
        table (``table`` (Vp / model, d); the whole table where the vocab
        does not divide "model"): a masked local gather, then an f32 sum
        over "model", cast back to the table's dtype."""
        if not self.vocab_parallel:
            return table[ids.long()]
        if not self.live:
            out = table[ids.long()]
            _note("all-reduce", self._local_bytes(out, itemsize=4),
                  self.model, "embed", self.log)
            return out
        vloc = table.shape[0]
        local = ids.long() - self.mesh.coord("model") * vloc
        ok = (local >= 0) & (local < vloc)
        out = table[local.clamp(0, vloc - 1)]
        out = torch.where(ok[..., None], out.float(), 0.0)
        return mesh_all_reduce(out, self.mesh, "model", log=self.log,
                               site="embed").to(table.dtype)

    # -- the length-sharded decode cache -------------------------------------
    def _cache_block(self, C: int) -> int:
        if C % self.model:
            raise ValueError(
                f"a decode cache of {C} slots does not split over "
                f"model={self.model}: kv_len_sharded needs C % model == 0 "
                f"(the cache is not padded)")
        return C // self.model

    def kv_block(self, cfg, max_len: int):
        """The ring slots ``(lo, hi)`` this rank's prefill seeds, as
        ``cache_specs`` places a length-sharded cache (the block of C /
        model slots at its "model" coordinate), or None: the whole ring
        (heads split, or a mesh description, whose program is global)."""
        if not self.kv_len_sharded:
            return None
        from ..serving.kv_cache import cache_len

        c = self._cache_block(cache_len(cfg, max_len))
        if not self.live:
            return None
        lo = self.mesh.coord("model") * c
        return lo, lo + c

    def kv_slot_update(self, cache: KVCacheView, k_new, v_new, cur_pos) -> None:
        """Write the new token's K/V (B, Hkv, dh) and position into a
        length-sharded cache in place: only the rank whose block ``[lo, lo +
        C / model)`` holds slot ``cur_pos % C`` writes it, every other rank
        rewrites what it holds.  On a mesh description the cache is the
        whole ring and the write is the plain one."""
        B, c = cache.k.shape[0], cache.k.shape[1]
        bidx = torch.arange(B, device=cache.k.device)
        if not self.live:
            self._cache_block(c)
            slot = (cur_pos % c).long()
            cache.k.index_put_((bidx, slot), k_new)
            cache.v.index_put_((bidx, slot), v_new)
            cache.pos.index_put_((bidx, slot), cur_pos.to(torch.int32))
            return
        C = c * self.model
        slot = (cur_pos.long() % C) - self.mesh.coord("model") * c
        ok = (slot >= 0) & (slot < c)
        safe = slot.clamp(0, c - 1)
        cache.k.index_put_((bidx, safe), torch.where(
            ok[:, None, None], k_new, cache.k[bidx, safe]))
        cache.v.index_put_((bidx, safe), torch.where(
            ok[:, None, None], v_new, cache.v[bidx, safe]))
        cache.pos.index_put_((bidx, safe), torch.where(
            ok, cur_pos.to(torch.int32), cache.pos[bidx, safe]))

    @property
    def gathers_layers(self) -> bool:
        """Whether any layer's parameters are gathered before use (FSDP
        blocks, or "model" blocks a layer cannot use split)."""
        return any(self._gathers)

    @property
    def merges_length_shards(self) -> bool:
        """Whether decode attention over this rank's slots must return its
        ``(m, l)`` for :meth:`merge_attention` (a process mesh under
        ``kv_len_sharded``)."""
        return self.kv_len_sharded and self.live

    def merge_attention(self, out, m=None, l=None):
        """Each row's attention over the whole cache from every model
        rank's output over its slots (B, H, dh) and its ``(m, l)`` (f32 (B,
        H), the decode kernel's ``return_stats``): ``m* = max_r m_r`` (a MAX
        all-reduce), then ``sum_r e^(m_r - m*) l_r out_r / sum_r e^(m_r -
        m*) l_r`` (one f32 SUM all-reduce of numerator and denominator
        packed together), cast to ``out``'s dtype.  The NEG_INF = -1e30
        convention makes a rank with no valid slot weigh 0 and a row with
        none anywhere the mean of V over all C slots
        (``kernels.decode_attention.ref.decode_attention_merge_ref``).  On
        a mesh description ``out`` is already the whole cache's: the two
        all-reduces are recorded."""
        if not self.live:
            B, H, dh = out.shape
            per_row = B * H * 4 / self.batch_split
            _note("all-reduce", per_row, self.model, "attn-merge-max",
                  self.log)
            _note("all-reduce", per_row * (dh + 1), self.model,
                  "attn-merge-sum", self.log)
            return out
        m_star = mesh_all_reduce(m, self.mesh, "model", op="max",
                                 log=self.log, site="attn-merge-max")
        w = torch.exp(m - m_star) * l
        packed = torch.cat([w[..., None] * out.float(), w[..., None]], dim=-1)
        total = mesh_all_reduce(packed, self.mesh, "model", log=self.log,
                                site="attn-merge-sum")
        return (total[..., :-1] / total[..., -1:]).to(out.dtype)


def make_policy(cfg, mesh, *, batch: int,
                fsdp: bool = True) -> ActivationPolicy:
    """The activation policy of ``cfg`` on ``mesh`` for a global batch of
    ``batch`` rows, the reference's ``make_policy``: ``kv_len_sharded`` when
    the kv heads do not divide "model" (and "model" is more than one),
    ``vocab_parallel`` when the padded vocab does.  ``fsdp`` says how the
    parameters were placed (``param_shardings``' keyword): with it, each
    layer's "data" blocks are gathered before use.  The reference's
    ``moe_ep`` has no counterpart: it picks the MoE layout, and MoE is not
    covered yet."""
    return ActivationPolicy(cfg, mesh, batch=batch, fsdp=fsdp)


def shard_batch(x: torch.Tensor, mesh, batch_axes, *, dim: int = 0):
    """This rank's rows of a global batch tensor under ``batch_axes``
    (``batch_shard``'s axes, or None: every rank holds every row)."""
    spec = [None] * x.dim()
    spec[dim] = batch_axes
    return block_of(x, P(*spec), mesh)


def gather_batch(x: torch.Tensor, mesh, batch_axes, *, dim: int = 0):
    """The global batch from every rank's rows (:func:`shard_batch`'s
    inverse)."""
    spec = [None] * x.dim()
    spec[dim] = batch_axes
    return gather_block(x, P(*spec), mesh)


__all__ = [
    "ActivationPolicy", "CollectiveLog", "block_of", "gather_batch",
    "gather_block", "gather_param_shards", "gather_tree", "make_policy",
    "mesh_all_gather", "mesh_all_reduce", "param_shardings",
    "policy_supported", "ring_wire_bytes", "shard_batch", "shard_tree",
]
