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
* **MoE**, with ``moe_ep`` and the experts dividing "model" (the
  reference's ``"moe_ecap"`` case): each rank holds ``E / model`` experts
  (``expert_block``), routes the same tokens into all E buckets (the
  router is replicated, so every rank drops the same assignments), runs
  its own buckets, empty ones too, and combines their outputs; else
  **expert-TP**: each expert's ``[gate | up]`` columns (permuted per
  expert, as the MLP's are) and ``wo`` rows over "model".  Either way the
  partial outputs and the shared experts' output-split MLP are summed once
  at ``"mlp_out"``;
* **SSM heads** over "model" where they divide it (Mamba-2 and the
  hybrid's SSM layers; :meth:`ActivationPolicy.ssm_block`): ``wz``, ``wx``,
  ``wdt`` column-split, ``out_proj`` row-split and summed at
  ``"attn_out"``; the rank cuts the replicated ``A_log``, ``D``,
  ``dt_bias``, norm scale and ``conv_w`` to its heads and channels; B and
  C (``wb``, ``wc``) are split where the groups divide "model", else
  gathered, and each rank then reads the groups of its heads
  (``ssm_groups``); the gated norm's sum of squares is all-reduced in f32
  (``"ssm-norm"``) and divided by the whole ``d_inner``.  The rank's decode
  state is its heads' ``ssm`` and a conv window of its channels, where
  ``cache_specs`` replicates the window (:meth:`ActivationPolicy.
  shard_caches` and ``gather_caches`` place and gather caches).  SSM heads
  that do not divide "model" are gathered and run whole on every rank;
* **VLM and audio**: the caller places ``extra_embeds`` and the (3, B, S)
  M-RoPE positions by ``train_batch_specs``; the audio encoder runs under
  the policy as decoder layers do, and the cross-attention's K/V are the
  rank's heads (whole where the kv heads do not divide "model"), its output
  summed at ``"cross_out"``;
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

**Serving state** (``serving.ContinuousBatcher(..., policy=...)``, and the
``serving.engine`` programs it builds):

* the slot, page and draft bookkeeping (``SlotState``, ``PageState``:
  table, free stack, ``free_top``, quota, pinned; ``DraftState``) is
  whole and bit-equal on every rank: every rank runs the same page
  faults, grants, frees, drafts and acceptance on the same values;
* the model runs on the rank's rows of the slots (:meth:`ActivationPolicy.
  row_block`, the slots split as ``batch_shard`` splits them), and what
  the bookkeeping reads of its output (the chosen tokens and the finite
  flag of each row; a verify window's tokens and flags) is all-gathered
  over the data axes, one collective a step (:meth:`gather_rows`; the
  logits stay on their rank);
* a dense ring is the rank's slots and heads (``cache_specs``; its length
  block under ``kv_len_sharded``); a dense admission runs its bucket whole
  on every data group and each keeps the rows of its own slots, so no
  ring crosses the data axes;
* the **page pool** ``(nb, P + 1, ps, Hkv, dh)`` holds the rank's kv heads
  over "model" and is whole over the data axes: a prefix page written by
  one data group's admission is read by slots of another.  So every pool
  write is all-gathered over the data axes first (:meth:`pool_rows`: the
  new K/V rows with their (page, offset) targets, one collective a layer
  of a decode step or verify window; the prompt K/V of a paged admission,
  whose bucket is split by its own size, ``batch_shard(mesh, n)``, one
  collective a period position), and every rank writes every row;
* host decisions read from the wall clock (the watchdog's trip, deadline
  shedding) are agreed by a MAX over the world first (:meth:`agree_max`),
  so the ranks' ledgers never part;
* under ``kv_len_sharded`` the paged decode and verify programs keep the
  reference's refusal (its length-sharded slot write serves dense rings
  only); the dense batcher runs on the length-sharded ring.

gloo moves CPU tensors: a CUDA tensor goes through host memory (a copy
each way, which waits for the card); an all-gather moves raw bytes, so any
dtype travels.  Every family and every serving program is covered;
training over the data and model axes is not (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.common import record_collective
from ..models.attention import KVCacheView, PagedKVView
from ..models.ssm import SSMState, ssm_dims
from ..models.transformer import (
    Caches, LayerSpec, init_caches, init_paged_caches, n_blocks,
    period_structure,
)
from .sharding import (
    P, _swiglu_tp_perm, batch_shard, cache_specs, mesh_axis_size, param_specs,
    spec_map,
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


def _shared_d_ff(cfg) -> int:
    """Width of the shared experts' one MLP (0 without them)."""
    m = cfg.moe
    return m.n_shared_experts * (m.shared_d_ff or m.expert_d_ff)


def _swiglu_perms(cfg, mesh, moe_ep: bool) -> Dict[str, np.ndarray]:
    """The column permutation (``_swiglu_tp_perm``) of each packed ``[gate
    | up]`` ``wi`` the policy uses split over "model": "mlp" (the dense
    MLP, the audio encoder's too), "experts" (every expert's ``wi`` under
    expert-TP, the layout when ``moe_ep`` is off or the experts do not
    divide "model") and "shared" (the shared experts' MLP).  A ``wi`` whose
    features do not divide "model" has none: the policy gathers it whole
    (:meth:`ActivationPolicy.layer`)."""
    m = mesh_axis_size(mesh, "model")
    out: Dict[str, np.ndarray] = {}
    if m == 1:
        return out
    if cfg.mlp_kind == "swiglu" and cfg.d_ff % m == 0:
        out["mlp"] = _swiglu_tp_perm(cfg.d_ff, m)
    mo = cfg.moe
    if mo is not None:
        if not (moe_ep and mo.n_experts % m == 0) and mo.expert_d_ff % m == 0:
            out["experts"] = _swiglu_tp_perm(mo.expert_d_ff, m)
        d_sh = _shared_d_ff(cfg)
        if d_sh and d_sh % m == 0:
            out["shared"] = _swiglu_tp_perm(d_sh, m)
    return out


def _permute(params, perms, *, inverse: bool = False):
    """``params`` with each packed ``wi`` that ``perms`` names taken in its
    column order (``inverse`` undoes it): one copy of each such leaf, on
    its device; every other leaf is the input's tensor."""
    if not perms:
        return params

    def take(wi, perm):
        perm = np.argsort(perm) if inverse else perm
        return wi[..., torch.from_numpy(perm).to(wi.device)]

    def layer(lp):
        lp = dict(lp)
        if "mlp" in lp and "mlp" in perms:
            lp["mlp"] = dict(lp["mlp"], wi=take(lp["mlp"]["wi"], perms["mlp"]))
        if "moe" in lp:
            moe = dict(lp["moe"])
            if "experts" in perms:
                moe["wi"] = take(moe["wi"], perms["experts"])
            if "shared" in perms:
                moe["shared"] = dict(moe["shared"], wi=take(
                    moe["shared"]["wi"], perms["shared"]))
            lp["moe"] = moe
        return lp

    out = dict(params)
    out["blocks"] = [layer(lp) for lp in params["blocks"]]
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], blocks=[
            layer(lp) for lp in params["encoder"]["blocks"]])
    return out


def param_shardings(cfg, mesh, params, *, fsdp: bool = True,
                    moe_ep: bool = True):
    """This rank's block of every leaf of the full parameter tree
    ``params`` (the weight bridge's or ``init_params``'s) under
    ``param_specs(cfg, mesh, fsdp=, moe_ep=)``: "model" over the width (or
    the experts), "data" (FSDP) over the other dimension, replicated over
    "pod".  Each packed swiglu ``wi`` split over whole features is first
    put into per-rank ``[gate_i | up_i]`` column blocks
    (``_swiglu_tp_perm``; per expert under expert-TP), as the
    tensor-parallel path does: a plain split would hand rank 0 only gate
    columns.  :func:`gather_param_shards` is its inverse."""
    return shard_tree(_permute(params, _swiglu_perms(cfg, mesh, moe_ep)),
                      param_specs(cfg, mesh, fsdp=fsdp, moe_ep=moe_ep), mesh)


def gather_param_shards(cfg, mesh, shards, *, fsdp: bool = True,
                        moe_ep: bool = True):
    """The full parameter tree from every rank's :func:`param_shardings`
    blocks, bit for bit: all-gathers, then the permutations undone."""
    full = gather_tree(shards, param_specs(cfg, mesh, fsdp=fsdp,
                                           moe_ep=moe_ep), mesh)
    return _permute(full, _swiglu_perms(cfg, mesh, moe_ep), inverse=True)


# ---------------------------------------------------------------------------
# The activation policy
# ---------------------------------------------------------------------------


def policy_supported(cfg) -> Optional[str]:
    """None: :func:`make_policy` covers every family (pure attention,
    MoE, SSM, hybrid, VLM and audio).  What it cannot place it refuses by
    name where it meets it: a length-sharded decode cache whose length
    does not split over "model" (:meth:`ActivationPolicy.kv_block`)."""
    return None


class SSMBlock(NamedTuple):
    """One "model" rank's share of every SSM layer: its heads ``[h0, h1)``
    and the channels of ``xBC`` (the causal conv's input, ``[x | B | C]``,
    ``d_inner + 2 G N`` wide) it computes: its heads' x channels, and the
    B and C channels of its groups where the groups split over "model",
    of all G groups where they do not."""

    heads: Tuple[int, int]
    channels: np.ndarray


def _head_groups(h0: int, h1: int, nh: int, G: int):
    """Which of the G groups of B and C heads ``h0 .. h1 - 1`` read (head
    ``h`` reads group ``h // (nh / G)``), as an index that keeps that map
    under the scan's own ``h_local // (nh_local / groups)``: a slice where
    every group of the range holds as many of these heads, else one group
    a head."""
    rep = nh // G
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    counts = {min(h1, (g + 1) * rep) - max(h0, g * rep) for g in range(g0, g1)}
    if len(counts) == 1:
        return slice(g0, g1)
    return [h // rep for h in range(h0, h1)]


_ENCODER_LAYER = LayerSpec(mixer="attn", mlp="mlp")


class ActivationPolicy:
    """The ``policy=`` of the model's prefill, ``prefill_kv``,
    ``prefix_prefill``, ``decode_step`` (dense and paged), ``verify_step``
    and audio encoder, and so of every ``serving.engine`` program and of
    ``ContinuousBatcher``, on one rank of a mesh; the module docstring
    says what each hook does.  ``log`` counts this rank's collectives
    (:class:`CollectiveLog`)."""

    def __init__(self, cfg, mesh, *, batch: int, fsdp: bool = True,
                 moe_ep: bool = True):
        m = mesh_axis_size(mesh, "model")
        self.cfg = cfg
        self.mesh = mesh
        self.model = m
        self.batch = batch
        self.batch_axes = batch_shard(mesh, batch)
        self.batch_split = math.prod(mesh_axis_size(mesh, a)
                                     for a in (self.batch_axes or ()))
        self.vocab_parallel = m > 1 and cfg.vocab_padded % m == 0
        self.kv_len_sharded = (cfg.family != "ssm" and m > 1
                               and cfg.n_kv_heads % m != 0)
        self.heads_split = m > 1 and cfg.n_kv_heads % m == 0
        self.mlp_split = m > 1 and cfg.d_ff % m == 0
        self.ssm_split = self.ssm_groups_split = False
        if cfg.ssm is not None:
            nh = cfg.ssm.n_ssm_heads(cfg.d_model)
            self.ssm_split = m > 1 and nh % m == 0
            self.ssm_groups_split = (self.ssm_split
                                     and cfg.ssm.n_groups % m == 0)
        self.moe_split = self.moe_ep = False
        if cfg.moe is not None:
            ep = moe_ep and cfg.moe.n_experts % m == 0
            self.moe_split = (m > 1 and (ep or cfg.moe.expert_d_ff % m == 0)
                              and _shared_d_ff(cfg) % m == 0)
            self.moe_ep = self.moe_split and ep
        self.live = mesh.is_process_mesh
        self.log = CollectiveLog()
        # this rank's experts, SSM heads and their groups (a description's
        # program is the global one: none)
        self.expert_block = None
        self.ssm_groups = None
        self._ssm_block = None
        if self.live:
            c = mesh.coord("model")
            if self.moe_ep:
                e = cfg.moe.n_experts // m
                self.expert_block = (c * e, (c + 1) * e)
            if self.ssm_split:
                self._ssm_block = self.ssm_block(c)
                if not self.ssm_groups_split:
                    self.ssm_groups = _head_groups(
                        *self._ssm_block.heads, nh, cfg.ssm.n_groups)
        self._channel_index: Dict[torch.device, torch.Tensor] = {}
        # each period position's spec tree without the stacked-blocks axis
        # (and the audio encoder's), and whether any of its leaves is
        # gathered at all
        specs = param_specs(cfg, mesh, fsdp=fsdp, moe_ep=moe_ep)
        self._structure = period_structure(cfg)
        self._layer_specs = [spec_map(lambda s: P(*s[1:]), blk)
                             for blk in specs["blocks"]]
        self._gathers = [self._layer_gathers(sp) for sp in self._layer_specs]
        self._enc_specs = (spec_map(lambda s: P(*s[1:]),
                                    specs["encoder"]["blocks"][0])
                           if "encoder" in specs else None)
        self._enc_gathers = (self._enc_specs is not None
                             and self._layer_gathers(self._enc_specs))
        # which of the running layer's outputs are partial sums
        self._sums: Dict[str, bool] = {}

    # -- issuing or recording one collective ---------------------------------
    def _local_bytes(self, x, split: int = 1, itemsize=None) -> float:
        """A device's bytes of the global activation ``x`` on a mesh
        description: its batch rows, further cut ``split`` ways, at
        ``itemsize`` bytes an element (``x``'s own by default)."""
        return (x.numel() * (itemsize or x.element_size())
                / self.batch_split / split)

    def model_sum(self, x, site: str):
        """The sum over "model" of a batch-sharded activation, in f32, cast
        back to ``x``'s dtype (on a mesh description, recorded and
        returned)."""
        if not self.live:
            _note("all-reduce", self._local_bytes(x, itemsize=4), self.model,
                  site, self.log)
            return x
        xf = x if x.dtype == torch.float32 else x.float()
        return mesh_all_reduce(xf, self.mesh, "model", log=self.log,
                               site=site).to(x.dtype)

    # -- hooks ---------------------------------------------------------------
    # -- hooks ---------------------------------------------------------------
    def __call__(self, x, name: str):
        if self._sums.get(name):
            return self.model_sum(x, name)
        if name == "logits" and self.vocab_parallel:
            if not self.live:
                _note("all-gather", self._local_bytes(x, self.model),
                      self.model, name, self.log)
                return x
            return mesh_all_gather(x, self.mesh, "model", x.dim() - 1,
                                   log=self.log, site=name)
        return x

    def layer_cfg(self, cfg):
        """The config an attention layer runs with: the rank's heads where
        they are split over "model" on a process mesh, else ``cfg`` (a mesh
        description's program is the global one; SSM and MoE layers read
        their widths from their blocks)."""
        if not (self.heads_split and self.live):
            return cfg
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // self.model,
                                   n_kv_heads=cfg.n_kv_heads // self.model)

    def layer(self, lp: Dict[str, Any], p: int, *,
              encoder: bool = False) -> Dict[str, Any]:
        """The usable parameters of one layer at period position ``p`` (of
        the audio encoder with ``encoder``) from this rank's blocks (all of
        the layer's keys, or some): each leaf's "data" (FSDP) blocks
        gathered, then its "model" blocks where the layer cannot use them
        split (attention under ``kv_len_sharded``; an MLP whose ``d_ff``
        does not divide "model"; SSM heads that do not divide it, or its B
        and C where the groups do not; a MoE neither layout splits), and
        an SSM's replicated leaves cut to the rank's heads and channels
        (:meth:`ssm_block`).  Sets which of the layer's outputs the hooks
        sum.  On a mesh description ``lp`` is the whole layer: only the
        bytes are recorded."""
        spec = _ENCODER_LAYER if encoder else self._structure[p]
        self._sums = {
            "attn_out": (self.heads_split if spec.mixer == "attn"
                         else self.ssm_split),
            "mlp_out": {"mlp": self.mlp_split,
                        "moe": self.moe_split}.get(spec.mlp, False),
            "cross_out": self.heads_split,
        }
        specs = self._enc_specs if encoder else self._layer_specs[p]
        if self._enc_gathers if encoder else self._gathers[p]:
            lp = {key: {name: spec_map(
                        lambda s, t, keep=self._keeps_model(key, name):
                        self._gather_leaf(t, s, keep), specs[key][name], sub)
                        for name, sub in part.items()}
                  for key, part in lp.items()}
        if self._ssm_block is not None and "ssm" in lp:
            lp = dict(lp, ssm=self._ssm_local(lp["ssm"]))
        return lp

    def _keeps_model(self, key: str, name: str) -> bool:
        """Whether leaf ``name`` of the layer's ``key`` is used split over
        "model"."""
        if key in ("attn", "cross"):
            return self.heads_split
        if key == "mlp":
            return self.mlp_split
        if key == "moe":
            return self.moe_split
        if key == "ssm":
            return self.ssm_split and (self.ssm_groups_split
                                       or name not in ("wb", "wc"))
        return False

    def _todo(self, spec: P, keep_model: bool):
        """(dim, axis) of each gather a leaf of ``spec`` needs, on axes of
        more than one rank."""
        return [(dim, a) for dim, entry in enumerate(spec) for a in _axes(entry)
                if mesh_axis_size(self.mesh, a) > 1
                and (a == "data" or (a == "model" and not keep_model))]

    def _layer_gathers(self, specs) -> bool:
        found = []
        for key, part in specs.items():
            for name, sub in part.items():
                keep = self._keeps_model(key, name)
                spec_map(lambda s, keep=keep: found.extend(self._todo(s, keep)),
                         sub)
        return bool(found)

    def _gather_leaf(self, t, spec: P, keep_model: bool):
        todo = self._todo(spec, keep_model)
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

    # -- the SSM's heads -----------------------------------------------------
    def ssm_block(self, rank: Optional[int] = None) -> Optional[SSMBlock]:
        """The heads and ``xBC`` channels of "model" rank ``rank`` (this
        rank's by default), or None where every rank runs all heads (they do
        not divide "model", or a mesh description).  Its decode state is
        that block: ``ssm`` (B, nh / model, hd, N), as ``cache_specs``
        splits it, and the conv window (B, K - 1, its channels), where
        ``cache_specs`` replicates the window whole
        (:meth:`shard_caches`)."""
        if rank is None:
            return self._ssm_block
        s, d = self.cfg.ssm, self.cfg.d_model
        d_in, nh = s.d_inner(d), s.n_ssm_heads(d)
        k, gn = nh // self.model, s.n_groups * s.d_state
        h0, h1 = rank * k, (rank + 1) * k
        bc = np.arange(gn)
        if self.ssm_groups_split:
            g = gn // self.model
            bc = bc[rank * g:(rank + 1) * g]
        x = np.arange(h0 * s.head_dim, h1 * s.head_dim)
        return SSMBlock((h0, h1), np.concatenate([x, d_in + bc,
                                                  d_in + gn + bc]))

    def _ssm_local(self, sp: Dict[str, Any]) -> Dict[str, Any]:
        """An SSM layer's replicated leaves cut to this rank's heads: its
        slice of ``A_log``, ``D``, ``dt_bias`` and the norm's scale, and
        ``conv_w``'s columns of its channels."""
        (h0, h1), channels = self._ssm_block
        hd = self.cfg.ssm.head_dim
        conv_w = sp["conv_w"]
        idx = self._channel_index.get(conv_w.device)
        if idx is None:
            idx = torch.from_numpy(channels).to(conv_w.device)
            self._channel_index[conv_w.device] = idx
        return dict(sp, A_log=sp["A_log"][h0:h1], D=sp["D"][h0:h1],
                    dt_bias=sp["dt_bias"][h0:h1], conv_w=conv_w[:, idx],
                    norm={"scale": sp["norm"]["scale"][h0 * hd:h1 * hd]})

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
        return any(self._gathers) or self._enc_gathers

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

    # -- serving state: the rank's rows, the whole pool ----------------------
    def row_axes(self, n: Optional[int] = None):
        """The data axes that split a batch of ``n`` rows (``batch_shard``'s;
        the policy's own batch, the slots, by default), or None."""
        return self.batch_axes if n is None else batch_shard(self.mesh, n)

    def row_block(self, n: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """This rank's rows ``[lo, hi)`` of a batch of ``n`` rows (the
        policy's batch by default) as :meth:`row_axes` splits it, or None
        where every rank holds all of them (the rows do not split, or a mesh
        description, whose program is the global one)."""
        axes = self.row_axes(n)
        if not self.live or axes is None:
            return None
        split, idx = 1, 0
        for a in _axes(axes):
            size = mesh_axis_size(self.mesh, a)
            split *= size
            idx = idx * size + self.mesh.coord(a)
        size = (self.batch if n is None else n) // split
        return idx * size, (idx + 1) * size

    def _rows(self, parts, n, dim: int, site: str):
        """Every part (this rank's rows of a batch of ``n`` rows on ``dim``)
        with the other data groups' rows, in one all-gather a data axis:
        the parts travel packed as raw bytes, row by row.  On a mesh
        description the rows are already the whole batch's."""
        axes = self.row_axes(n)
        if axes is None or not self.live:
            return parts
        rows = parts[0].shape[dim]
        flat = [p.movedim(dim, 0).contiguous().reshape(rows, -1)
                .view(torch.uint8) for p in parts]
        packed = torch.cat(flat, dim=1)
        for a in reversed(_axes(axes)):
            packed = mesh_all_gather(packed, self.mesh, a, 0, log=self.log,
                                     site=site)
        out, col = [], 0
        for p, f in zip(parts, flat):
            piece = packed[:, col:col + f.shape[1]].contiguous().view(p.dtype)
            rest = p.movedim(dim, 0).shape[1:]
            out.append(piece.reshape((packed.shape[0],) + tuple(rest))
                       .movedim(0, dim))
            col += f.shape[1]
        return tuple(out)

    def gather_rows(self, *parts, n: Optional[int] = None, dim: int = 0):
        """What the serving bookkeeping reads of the model's output on this
        rank's rows (the chosen tokens, each row's finite flag), all-gathered
        over the data axes that split a batch of ``n`` rows, in one
        collective (site ``"rows"``): the parts, whole, as a tuple."""
        return self._rows(parts, n, dim, "rows")

    def pool_rows(self, *parts, n: Optional[int] = None, dim: int = 0):
        """A pool write's rows from every data group, before the write: the
        new K/V of this rank's rows and their (page, offset) targets (a
        decode step's or verify window's; the admission's prompt K/V with
        ``n`` its bucket and ``dim`` 1), all-gathered over the data axes in
        one collective (site ``"pool-kv"``), so every data group's pool
        stays the whole pool (the module docstring)."""
        return self._rows(parts, n, dim, "pool-kv")

    def agree_max(self, value: float) -> float:
        """The largest of every rank's ``value`` (one MAX all-reduce over the
        world, site ``"agree"``): a host decision read from the wall clock,
        taken alike on every rank.  On a mesh description ``value``."""
        if not self.live:
            return value
        import torch.distributed as dist

        _note("all-reduce", 8, self.mesh.size, "agree", self.log)
        t0 = time.perf_counter()
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        self.log.seconds += time.perf_counter() - t0
        return float(t[0])

    def _local_rows(self) -> int:
        blk = self.row_block()
        return self.batch if blk is None else blk[1] - blk[0]

    def _ssm_zeros(self, rows: int, device) -> Dict[str, SSMState]:
        """Zeroed SSM decode states of ``rows`` slots at the rank's layout:
        its heads' ``ssm`` and a conv window of its channels
        (:meth:`ssm_block`)."""
        from ..device import resolve_device, torch_dtype

        device = resolve_device(device)
        out: Dict[str, SSMState] = {}
        for p, spec in enumerate(self._structure):
            if spec.mixer != "ssm":
                continue
            s = self.cfg.ssm
            d_in, nh, d_bc = ssm_dims(self.cfg)
            ch = (d_in + d_bc if self._ssm_block is None
                  else len(self._ssm_block.channels))
            nh_l = nh // self.model if self._ssm_block is not None else nh
            nb = n_blocks(self.cfg)
            out[str(p)] = SSMState(
                conv=torch.zeros((nb, rows, s.d_conv - 1, ch),
                                 dtype=torch_dtype(self.cfg.dtype),
                                 device=device),
                ssm=torch.zeros((nb, rows, nh_l, s.head_dim, s.d_state),
                                dtype=torch.float32, device=device))
        return out

    def init_caches(self, max_len: int, *, device="cuda") -> Caches:
        """The rank's zeroed dense decode caches for the policy's batch (a
        batcher's slots), as :meth:`shard_caches` places whole ones: its
        rows, its kv heads (the ring's block of C / model slots under
        ``kv_len_sharded``), its SSM heads and conv channels, the audio
        cross K/V at its heads.  Made at that size: no whole cache exists."""
        from ..serving.kv_cache import cache_len

        C = cache_len(self.cfg, max_len)
        if self.kv_len_sharded:
            C = self._cache_block(C)
        rows = self._local_rows()
        caches = init_caches(self.layer_cfg(self.cfg), rows, C, device=device)
        return caches._replace(ssm=self._ssm_zeros(rows, device))

    def init_paged_caches(self, n_pages: int, page_size: int, *,
                          device="cuda") -> Caches:
        """The rank's zeroed page pool (its kv heads, whole over the data
        axes) and the SSM decode states of its slots."""
        rows = self._local_rows()
        caches = init_paged_caches(self.layer_cfg(self.cfg), rows, n_pages,
                                   page_size, device=device)
        return caches._replace(ssm=self._ssm_zeros(rows, device))

    # -- placing decode caches ----------------------------------------------
    def _kv_specs(self, kv, specs):
        """``cache_specs``' spec of each attention cache, and of a page pool
        its kv heads over "model" where they are split, whole over the data
        axes (the module docstring)."""
        pool = P(None, None, None, "model" if self.heads_split else None, None)
        return {p: PagedKVView(k=pool, v=pool)
                if isinstance(view, PagedKVView) else specs.kv[p]
                for p, view in kv.items()}

    def _cross_spec(self) -> P:
        """The audio cross K/V (nb, B, S_enc, Hkv, dh) as the rank holds
        them: its rows, and its heads where they are split (``cache_specs``
        replicates the heads)."""
        return P(None, self.batch_axes, None,
                 "model" if self.heads_split else None, None)

    def shard_caches(self, caches):
        """This rank's blocks of whole (single-process) decode caches as its
        programs hold them: ``cache_specs``' blocks, except that each SSM
        conv window holds the rank's channels (:meth:`ssm_block`), the
        audio cross K/V the rank's heads where they are split, and a page
        pool the rank's heads, whole over the data axes.  A process mesh
        only."""
        specs = cache_specs(self.cfg, self.mesh, batch=self.batch)
        rows = P(None, self.batch_axes, None, None)
        ssm = {}
        for p, st in caches.ssm.items():
            conv = block_of(st.conv, rows, self.mesh)
            if self._ssm_block is not None:
                conv = conv[..., torch.from_numpy(self._ssm_block.channels)
                            .to(conv.device)]
            ssm[p] = SSMState(conv=conv, ssm=block_of(st.ssm, specs.ssm[p].ssm,
                                                      self.mesh))
        cross = None if caches.cross is None else {
            p: tuple(block_of(t, self._cross_spec(), self.mesh) for t in kv)
            for p, kv in caches.cross.items()}
        return Caches(kv=shard_tree(caches.kv, self._kv_specs(caches.kv, specs),
                                    self.mesh), ssm=ssm, cross=cross)

    def gather_caches(self, caches):
        """The whole decode caches from every rank's blocks
        (:meth:`shard_caches`' inverse): what the single process holds."""
        specs = cache_specs(self.cfg, self.mesh, batch=self.batch)
        rows = P(None, self.batch_axes, None, None)
        ssm = {}
        for p, st in caches.ssm.items():
            conv = gather_block(st.conv, rows, self.mesh)
            if self._ssm_block is not None:
                s = self.cfg.ssm
                width = s.d_inner(self.cfg.d_model) + 2 * s.n_groups * s.d_state
                parts = mesh_all_gather(conv, self.mesh, "model", conv.dim() - 1)
                whole = conv.new_zeros(conv.shape[:-1] + (width,))
                c = conv.shape[-1]
                for r in range(self.model):
                    idx = torch.from_numpy(self.ssm_block(r).channels)
                    whole[..., idx.to(conv.device)] = parts[..., r * c:(r + 1) * c]
                conv = whole
            ssm[p] = SSMState(conv=conv, ssm=gather_block(
                st.ssm, specs.ssm[p].ssm, self.mesh))
        cross = None if caches.cross is None else {
            p: tuple(gather_block(t, self._cross_spec(), self.mesh) for t in kv)
            for p, kv in caches.cross.items()}
        return Caches(kv=gather_tree(caches.kv,
                                     self._kv_specs(caches.kv, specs),
                                     self.mesh), ssm=ssm, cross=cross)


def make_policy(cfg, mesh, *, batch: int, fsdp: bool = True,
                moe_ep: bool = True) -> ActivationPolicy:
    """The activation policy of ``cfg`` on ``mesh`` for a global batch of
    ``batch`` rows, the reference's ``make_policy``: ``kv_len_sharded`` when
    the kv heads do not divide "model" (and "model" is more than one; never
    for the SSM family, which has no attention), ``vocab_parallel`` when
    the padded vocab does.  ``fsdp`` and ``moe_ep`` say how the parameters
    were placed (``param_shardings``' keywords): with ``fsdp``, each
    layer's "data" blocks are gathered before use; ``moe_ep`` puts the
    experts over "model" where they divide it (the reference's
    ``"moe_ecap"`` case), else each expert's width (expert-TP)."""
    return ActivationPolicy(cfg, mesh, batch=batch, fsdp=fsdp, moe_ep=moe_ep)


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
    "ActivationPolicy", "CollectiveLog", "SSMBlock", "block_of", "gather_batch",
    "gather_block", "gather_param_shards", "gather_tree", "make_policy",
    "mesh_all_gather", "mesh_all_reduce", "param_shardings",
    "policy_supported", "ring_wire_bytes", "shard_batch", "shard_tree",
]
