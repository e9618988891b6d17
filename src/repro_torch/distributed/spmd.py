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

**Training** (``training.make_train_step(policy=...)``): each rank holds
its ``param_shardings`` blocks of the params and of the AdamW moments and
its ``shard_batch`` rows; the reference's GSPMD program derives every
backward collective, and here each forward collective carries its adjoint
(:func:`with_adjoint`, an ``autograd.Function``), as Megatron pairs them:

* an FSDP gather over "data" is reduce-scattered (summed) over "data" in
  the backward, each data group's rows adding to the gradient (where the
  batch is not split over "data", the rank's own block of a gradient every
  rank holds whole);
* a gather over "model" of a block used whole on the same rows
  (attention under ``kv_len_sharded``, an MLP whose ``d_ff`` does not
  divide "model", SSM heads that do not) takes the rank's own block, with
  no sum; B and C gathered whole but read by the rank's own heads only are
  reduce-scattered over "model";
* a sum over "model" whose consumer is replicated (``"attn_out"``,
  ``"mlp_out"``, ``"cross_out"``, ``embed``, the vocab-parallel loss's sums)
  has the identity backward; the SSM norm's ``"ssm-norm"``, whose consumer
  is split, sums again;
* **entry hooks**, the identity in the forward pass (so serving does not
  change), sum each rank's part of a gradient over "model" in the backward
  where a replicated tensor enters split compute: ``"attn_in"`` (the
  normed input of attention or the SSM), ``"mlp_in"`` (of the MLP and the
  MoE's experts), ``"moe_weights"`` (the MoE's combine weights: the
  replicated router then gets its whole gradient), ``"cross_in"`` and
  ``"enc_in"`` (the decoder's cross-attention and the encoder output its
  K/V are made from) and ``"logits_in"`` (the final hidden state before
  the vocab-parallel logits).  The reference has no such names: GSPMD
  derives them;
* after the backward (:meth:`ActivationPolicy.reduce_grads`), each leaf's
  gradient is summed over the data axes that split the batch unless its
  FSDP reduce-scatter did, and a leaf whole on every "model" rank but read
  only by split compute (``q_norm``/``k_norm`` on split heads, the SSM
  leaves :meth:`ActivationPolicy._ssm_local` cuts) over "model" too;
* the loss is the rank's rows' summed loss over the whole batch's count of
  valid labels (``global_count``), vocab-parallel where the vocab splits
  (``models.transformer._vocab_parallel_loss``: row maxima and sums over
  "model", never the logits gathered); the MoE aux loss reads the whole
  batch's expert counts and probabilities (``batch_sum``);
* clipping reads the whole tree's norm (:meth:`ActivationPolicy.
  global_norm`: each element once), AdamW is elementwise on the blocks,
  and 8-bit moments keep the whole leaf's blocks of 256
  (:meth:`ActivationPolicy.quantize_moments`: the rank's int8 values and
  every block scale of the leaf, a MAX over the ranks holding a part), so
  a rank stores what one process would for its elements.

On a mesh description every adjoint records the collective it would issue
in the backward pass too (sites ``"bwd:<site>"``), so the dry-run's train
cells count their backward.  Every rank issues the same collectives in the
same order, a remat recompute's gathers included (``layer`` sets which
outputs are partial sums each time a layer runs).

gloo moves CPU tensors: a CUDA tensor goes through host memory (a copy
each way, which waits for the card); an all-gather moves raw bytes, so any
dtype travels.  Every family, every serving program and training are
covered.
"""

from __future__ import annotations

import dataclasses
import functools
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
from ..tree import leaves, unflatten_like
from .sharding import (
    P, _swiglu_tp_perm, batch_shard, cache_specs, mesh_axis_size, param_specs,
    spec_map,
)


# ---------------------------------------------------------------------------
# Collectives over a process mesh
# ---------------------------------------------------------------------------


def ring_wire_bytes(op: str, operand_bytes: float, n: int) -> float:
    """Bytes one rank sends in a ring collective over ``n`` ranks: an
    all-reduce of an S-byte operand 2 S (n - 1) / n, a reduce-scatter of an
    S-byte operand S (n - 1) / n, an all-gather of S-byte blocks (n - 1)
    S."""
    if op == "all-gather":
        return float((n - 1) * operand_bytes)
    if op == "reduce-scatter":
        return operand_bytes * (n - 1) / n
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


def mesh_reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int, *,
                        log: Optional[CollectiveLog] = None,
                        site: str = "reduce-scatter") -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, cut on ``dim`` into
    one block a rank in rank order: this rank's block (``x.shape[dim] / n``
    wide), on ``x``'s device in ``x``'s dtype (:func:`mesh_all_gather`'s
    adjoint)."""
    import torch.distributed as dist

    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    _note("reduce-scatter", x.numel() * x.element_size(), n, site, log)
    t0 = time.perf_counter()
    host = x.detach().movedim(dim, 0).to("cpu").contiguous()
    out = torch.empty((host.shape[0] // n,) + tuple(host.shape[1:]),
                      dtype=host.dtype)
    dist.reduce_scatter_tensor(out, host, group=mesh.group(axis))
    out = out.movedim(0, dim).to(x.device)
    if log is not None:
        log.seconds += time.perf_counter() - t0
    return out


class _Adjoint(torch.autograd.Function):
    """``fwd(x)`` in the forward pass and ``bwd(g)`` on its gradient in the
    backward: a collective and its adjoint, each a function of one tensor
    (a collective, a slice or the identity)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        out = fwd(x)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def with_adjoint(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``fwd(x)``, with ``bwd`` as its backward where ``x`` takes a gradient
    (else the plain call: serving builds no graph)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Adjoint.apply(x, fwd, bwd)
    return fwd(x)


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
    ``prefix_prefill``, ``decode_step`` (dense and paged), ``verify_step``,
    audio encoder and training ``forward`` and ``lm_loss``, and so of every
    ``serving.engine`` program, of ``ContinuousBatcher`` and of
    ``training.make_train_step``, on one rank of a mesh; the module
    docstring says what each hook does.  ``log`` counts this rank's
    collectives (:class:`CollectiveLog`)."""

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
        self._specs = specs
        self._perms = _swiglu_perms(cfg, mesh, moe_ep)
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

    def _sum(self, x, axis: str, site: str, nbytes=None):
        """The sum of ``x`` over ``axis`` in f32, cast back to ``x``'s dtype;
        on a mesh description recorded at ``nbytes`` a device (default: a
        batch-sharded activation's rows, :meth:`_local_bytes`) and
        returned."""
        n = mesh_axis_size(self.mesh, axis)
        if n == 1:
            return x
        if not self.live:
            _note("all-reduce", (self._local_bytes(x, itemsize=4)
                                 if nbytes is None else nbytes), n, site,
                  self.log)
            return x
        xf = x if x.dtype == torch.float32 else x.float()
        return mesh_all_reduce(xf, self.mesh, axis, log=self.log,
                               site=site).to(x.dtype)

    def model_sum(self, x, site: str):
        """The sum over "model" of a batch-sharded activation, in f32, cast
        back to ``x``'s dtype (on a mesh description, recorded and
        returned).  Its backward is the identity where the sum's consumer
        is replicated over "model" (every site but one); the SSM norm's
        ``"ssm-norm"`` feeds each rank's own heads, whose gradients are
        summed over "model" again (site ``"bwd:ssm-norm"``)."""
        bwd = ((lambda g: self._sum(g, "model", "bwd:" + site))
               if site in _SPLIT_CONSUMERS else (lambda g: g))
        return with_adjoint(x, lambda t: self._sum(t, "model", site), bwd)

    def _enter(self, x, site: str):
        """Where a replicated tensor enters compute split over "model": the
        identity forward; backward, each rank's part of the gradient summed
        over "model" (site ``"bwd:<site>"``)."""
        return with_adjoint(x, lambda t: t,
                            lambda g: self._sum(g, "model", "bwd:" + site))

    # -- hooks ---------------------------------------------------------------
    def __call__(self, x, name: str):
        if self._sums.get(name):
            return self.model_sum(x, name)
        if name in _ENTRIES:
            split = (self.vocab_parallel if name == "logits_in"
                     else self.heads_split if name == "enc_in"
                     else self._sums.get(_ENTRIES[name], False))
            return self._enter(x, name) if split else x
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
                        lambda s, t, keep=self._keeps_model(key, name),
                        part=self._model_partial(key, name):
                        self._gather_leaf(t, s, keep, part),
                        specs[key][name], sub)
                        for name, sub in part.items()}
                  for key, part in lp.items()}
        if self._ssm_block is not None and "ssm" in lp:
            lp = dict(lp, ssm=self._ssm_local(lp["ssm"]))
        return lp

    def _model_partial(self, key: str, name: str) -> bool:
        """Whether leaf ``name`` of the layer's ``key`` is whole on every
        "model" rank yet read only by the rank's split compute, so that each
        rank's gradient of it is a part: the attention's ``q_norm`` and
        ``k_norm`` on split heads, and on split SSM heads B and C gathered
        whole (``wb``, ``wc``) and the replicated leaves
        :meth:`_ssm_local` cuts."""
        if key in ("attn", "cross"):
            return self.heads_split and name in ("q_norm", "k_norm")
        if key == "ssm":
            return self.ssm_split and (
                name in ("A_log", "D", "dt_bias", "conv_w", "norm")
                or (not self.ssm_groups_split and name in ("wb", "wc")))
        return False

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

    def _gather_leaf(self, t, spec: P, keep_model: bool,
                     model_partial: bool = False):
        """One leaf of a layer, all-gathered over "data" (FSDP) and then over
        "model" where the layer cannot use it split.  Each gather's
        backward is its adjoint: a reduce-scatter (sum, then the rank's
        block) where each rank's gradient is a part of the whole (over
        "data" when the batch is split there, each data group's rows; over
        "model" for a ``model_partial`` leaf), else the rank's own block of
        a gradient every rank holds whole."""
        todo = self._todo(spec, keep_model)
        if not todo:
            return t
        split = math.prod(mesh_axis_size(self.mesh, a)
                          for entry in spec for a in _axes(entry))
        for dim, a in sorted(todo, key=lambda da: da[1] != "data"):
            summed = (a in _axes(self.batch_axes) if a == "data"
                      else model_partial)
            t = with_adjoint(
                t, functools.partial(self._gather, axis=a, dim=dim,
                                     split=split),
                functools.partial(self._gather_adjoint, axis=a, dim=dim,
                                  split=split, summed=summed))
            split //= mesh_axis_size(self.mesh, a)
        return t

    def _gather(self, t, *, axis: str, dim: int, split: int):
        if self.live:
            return mesh_all_gather(t, self.mesh, axis, dim, log=self.log,
                                   site=f"gather-{axis}")
        _note("all-gather", t.numel() * t.element_size() / split,
              mesh_axis_size(self.mesh, axis), f"gather-{axis}", self.log)
        return t

    def _gather_adjoint(self, g, *, axis: str, dim: int, split: int,
                        summed: bool):
        n = mesh_axis_size(self.mesh, axis)
        if not self.live:
            if summed:
                _note("reduce-scatter", g.numel() * 4 * n / split, n,
                      f"bwd:gather-{axis}", self.log)
            return g
        if summed:
            return mesh_reduce_scatter(
                g.float(), self.mesh, axis, dim, log=self.log,
                site=f"bwd:gather-{axis}").to(g.dtype)
        b = g.shape[dim] // n
        return g.narrow(dim, self.mesh.coord(axis) * b, b)

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
            return self.model_sum(table[ids.long()], "embed")
        vloc = table.shape[0]
        local = ids.long() - self.vocab_offset(vloc)
        ok = (local >= 0) & (local < vloc)
        out = table[local.clamp(0, vloc - 1)]
        out = torch.where(ok[..., None], out.float(), 0.0)
        return self.model_sum(out, "embed").to(table.dtype)

    # -- training: the vocab-parallel loss, global counts, gradient sums -----
    def vocab_offset(self, vloc: int) -> int:
        """The first vocab row of this rank's ``vloc`` rows of a
        vocab-parallel table (0 on a mesh description, whose table is
        whole)."""
        return self.mesh.coord("model") * vloc if self.live else 0

    def model_max(self, x, site: str):
        """The MAX over "model" of ``x`` (no gradient: the loss's row
        maxima, which cancel in its value)."""
        if self.model == 1:
            return x
        if not self.live:
            _note("all-reduce", self._local_bytes(x, itemsize=4), self.model,
                  site, self.log)
            return x
        return mesh_all_reduce(x.detach(), self.mesh, "model", op="max",
                               log=self.log, site=site)

    def batch_sum(self, x, site: str, nbytes=None):
        """The sum of ``x`` over the data axes that split the batch (each
        data group's part of a global sum), in f32; its backward is the
        identity, since the step sums every rank's gradients over the same
        axes afterwards (:meth:`reduce_grads`)."""
        def fwd(t):
            for a in _axes(self.batch_axes):
                t = self._sum(t, a, site, t.numel() * 4 if nbytes is None
                              else nbytes)
            return t

        return with_adjoint(x, fwd, lambda g: g)

    def global_count(self, count):
        """A count of this rank's rows (the valid labels) summed over the
        data axes that split the batch (site ``"tokens"``)."""
        for a in _axes(self.batch_axes):
            n = mesh_axis_size(self.mesh, a)
            if n == 1:
                continue
            if not self.live:
                _note("all-reduce", 4, n, "tokens", self.log)
            else:
                count = mesh_all_reduce(count, self.mesh, a, log=self.log,
                                        site="tokens")
        return count

    def reduce_metrics(self, metrics):
        """The step's metrics with ``loss`` (each rank's rows' share of the
        global mean) summed over the data axes that split the batch (site
        ``"loss"``); ``tokens`` and ``aux`` are global already."""
        return dict(metrics, loss=self.batch_sum(metrics["loss"].float(),
                                                 "loss"))

    def leaf_plans(self):
        """A tree beside the parameters (dict keys as ``param_specs``') of
        :class:`_LeafPlan`: each leaf's split axes and the axes its
        gradient is summed over after the backward."""
        def walk(spec, path):
            if isinstance(spec, P):
                return self._leaf_plan(spec, path)
            if isinstance(spec, dict):
                return {k: walk(v, path + (k,)) for k, v in spec.items()}
            return [walk(v, path) for v in spec]

        return walk(self._specs, ())

    def _leaf_plan(self, spec: P, path) -> "_LeafPlan":
        split = tuple(a for entry in spec for a in _axes(entry)
                      if mesh_axis_size(self.mesh, a) > 1)
        # a layer's leaf: (key, name) after "blocks" or the encoder's
        rest = (path[1:] if path[:1] == ("blocks",) else
                path[2:] if path[:2] == ("encoder", "blocks") else ())
        layer = len(rest) >= 2
        key, name = rest[:2] if layer else (None, None)
        fsdp = layer and "data" in split
        sums = tuple(a for a in _axes(self.batch_axes)
                     if mesh_axis_size(self.mesh, a) > 1
                     and not (a == "data" and fsdp))
        if layer and "model" not in split and self._model_partial(key, name):
            sums += ("model",)
        perm = None
        if layer and rest[-1] == "wi":
            perm = self._perms.get({"mlp": "mlp", "moe": "experts"}[key]
                                   if name == "wi" else "shared")
        return _LeafPlan(split=split, sums=sums, spec=spec, perm=perm)

    def reduce_grads(self, grads):
        """Every rank's gradients after the backward made the whole
        tree's gradients of the rank's blocks: each leaf that no FSDP
        reduce-scatter summed is summed over the data axes that split the
        batch, and each :meth:`_model_partial` leaf whole on every "model"
        rank over "model" too; the leaves of one set of axes travel packed
        in f32, one all-reduce an axis (site ``"grad-sum"``)."""
        flat, plans = leaves(grads), leaves(self.leaf_plans())
        out = list(flat)
        groups: Dict[Tuple[str, ...], list] = {}
        for i, plan in enumerate(plans):
            if plan.sums:
                groups.setdefault(plan.sums, []).append(i)
        for axes in sorted(groups):
            idx = groups[axes]
            packed = torch.cat([flat[i].float().reshape(-1) for i in idx])
            nbytes = sum(flat[i].numel() * 4 / self._split_of(plans[i])
                         for i in idx)
            for a in axes:
                packed = self._sum(packed, a, "grad-sum", nbytes)
            at = 0
            for i in idx:
                n = flat[i].numel()
                out[i] = packed[at:at + n].view(flat[i].shape).to(
                    flat[i].dtype)
                at += n
        return unflatten_like(grads, out)

    def _split_of(self, plan) -> int:
        """Devices a leaf's blocks differ over on a mesh description (1 on
        a process mesh, whose leaves are the rank's blocks)."""
        if self.live:
            return 1
        return math.prod(mesh_axis_size(self.mesh, a) for a in plan.split)

    # -- 8-bit moments in the whole leaf's blocks ---------------------------
    def _whole_index(self, plan, shape, device) -> Tuple[torch.Tensor, int]:
        """(the row-major index in the whole leaf, as ``param_shardings``
        received it, of each element of this rank's block of ``shape``,
        flat; the whole leaf's size).  A permuted ``wi``'s columns map back
        through the permutation.  On a mesh description ``shape`` is the
        whole leaf's."""
        dims = len(shape)
        whole, pos = [], []
        for d in range(dims):
            i, n = 0, 1
            if self.live and d < len(plan.spec):
                for a in _axes(plan.spec[d]):
                    size = mesh_axis_size(self.mesh, a)
                    i, n = i * size + self.mesh.coord(a), n * size
            whole.append(shape[d] * n)
            ar = torch.arange(shape[d], device=device) + i * shape[d]
            if plan.perm is not None and d == dims - 1 and self.live:
                ar = torch.from_numpy(plan.perm).to(device)[ar]
            pos.append(ar)
        flat = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(dims)):
            flat = flat + (pos[d] * stride).view(
                [-1 if k == d else 1 for k in range(dims)])
            stride *= whole[d]
        return flat.reshape(-1), stride

    def quantize_moments(self, xs, plans, block: int):
        """Each f32 block of ``xs`` (this rank's block of a leaf, the leaf's
        plan beside it) as int8 in the **whole leaf's** blocks of ``block``
        consecutive elements, as the single process quantizes the whole
        leaf: ``(q, scale)`` with ``q`` the block's int8 values (flat,
        row-major) and ``scale`` (n_blocks, 1) the whole leaf's block scales,
        each the largest |x| over the ranks that hold a part of its block
        (one MAX all-reduce an axis over the leaves split alike, site
        ``"moments-max"``) over 127."""
        ids, maxes = [], []
        for x, plan in zip(xs, plans):
            flat, n = self._whole_index(plan, x.shape, x.device)
            bid = flat // block
            ids.append(bid)
            maxes.append(torch.zeros((-(-n // block),), dtype=torch.float32,
                                     device=x.device).scatter_reduce(
                0, bid, x.reshape(-1).abs(), "amax"))
        groups: Dict[Tuple[str, ...], list] = {}
        for i, plan in enumerate(plans):
            groups.setdefault(plan.split, []).append(i)
        for axes in sorted(groups):
            idx = groups[axes]
            if not axes:
                continue
            packed = torch.cat([maxes[i] for i in idx])
            for a in axes:
                if self.live:
                    packed = mesh_all_reduce(packed, self.mesh, a, op="max",
                                             log=self.log, site="moments-max")
                else:
                    _note("all-reduce", packed.numel() * 4,
                          mesh_axis_size(self.mesh, a), "moments-max",
                          self.log)
            at = 0
            for i in idx:
                maxes[i], at = packed[at:at + maxes[i].numel()], at + maxes[
                    i].numel()
        out = []
        for x, bid, mx in zip(xs, ids, maxes):
            scale = torch.clamp(mx / 127.0, min=1e-12)[:, None]
            q = torch.clamp(torch.round(x.reshape(-1) / scale[bid, 0]),
                            -127, 127).to(torch.int8)
            out.append((q, scale))
        return out

    def note_moment_maxes(self, params, block: int) -> None:
        """On a mesh description, whose moments are the whole leaves'
        (the reference's layout): record the MAX all-reduces
        :meth:`quantize_moments` issues on a process mesh for the moments
        of ``params``."""
        groups: Dict[Tuple[str, ...], float] = {}
        for p, plan in zip(leaves(params), leaves(self.leaf_plans())):
            groups[plan.split] = (groups.get(plan.split, 0.0)
                                  + 2 * 4 * -(-p.numel() // block))
        for axes in sorted(groups):
            for a in axes:
                _note("all-reduce", groups[axes], mesh_axis_size(self.mesh, a),
                      "moments-max", self.log)

    def dequantize_moment(self, q, scale, plan, shape, block: int):
        """f32 values of this rank's block of ``shape`` from
        :meth:`quantize_moments`' ``(q, scale)``."""
        flat, _ = self._whole_index(plan, shape, q.device)
        return (q.float() * scale[flat // block, 0]).reshape(shape)

    def global_norm(self, tree):
        """sqrt of the sum of squares of every element of the whole tree
        from the rank's blocks: each leaf's squares summed in f32 with the
        other leaves split over the same axes, each such sum then over
        those axes (leaves replicated over an axis are not summed over it),
        one packed all-reduce an axis (site ``"grad-norm"``)."""
        groups: Dict[Tuple[str, ...], Any] = {}
        for x, plan in zip(leaves(tree), leaves(self.leaf_plans())):
            xf = x.float()
            groups[plan.split] = groups.get(plan.split, 0) + torch.sum(xf * xf)
        keys = sorted(groups)
        sums = torch.stack([torch.as_tensor(groups[k]) for k in keys])
        for a in sorted({a for k in keys for a in k}):
            idx = [i for i, k in enumerate(keys) if a in k]
            part = self._sum(sums[idx], a, "grad-norm", 4 * len(idx))
            sums = sums.index_put((torch.tensor(idx, device=sums.device),),
                                  part)
        return torch.sqrt(sums.sum())

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


class _LeafPlan:
    """A parameter leaf's place under the policy: ``split``, the mesh axes
    its blocks differ over; ``sums``, the axes its gradient is summed over
    after the backward (:meth:`ActivationPolicy.reduce_grads`); ``spec``,
    its ``param_specs`` entry; ``perm``, the column permutation
    ``param_shardings`` put a swiglu ``wi`` in (or None)."""

    __slots__ = ("split", "sums", "spec", "perm")

    def __init__(self, split, sums, spec, perm):
        self.split, self.sums, self.spec, self.perm = split, sums, spec, perm


#: the sums over "model" whose consumer is split over it: their backward
#: sums again (:meth:`ActivationPolicy.model_sum`)
_SPLIT_CONSUMERS = ("ssm-norm",)
#: the entry hooks (identity forward, a sum over "model" backward) and the
#: output each stands before: the split compute between them
_ENTRIES = {"attn_in": "attn_out", "mlp_in": "mlp_out",
            "moe_weights": "mlp_out", "cross_in": "cross_out",
            "enc_in": "cross_out", "logits_in": None}


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


def shard_batch(x: torch.Tensor, mesh, batch_axes, *, dim: int = 0,
                micro: int = 1):
    """This rank's rows of a global batch tensor under ``batch_axes``
    (``batch_shard``'s axes, or None: every rank holds every row).  With
    ``micro`` the batch is ``micro`` microbatches of consecutive rows (the
    train step's ``grad_accum`` split) and the rank holds its rows of each,
    in order, so that its own split into ``micro`` gives its rows of the
    reference's microbatches."""
    spec = [None] * x.dim()
    spec[dim] = batch_axes
    if micro == 1:
        return block_of(x, P(*spec), mesh)
    return torch.cat([block_of(part, P(*spec), mesh)
                      for part in torch.chunk(x, micro, dim=dim)], dim=dim)


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
