"""Tensor-parallel serving: the shard layout of one tenant's model over the
logical cores of its lease, and the single-controller runtime that runs
its shards.

Counterpart of the serving half of ``repro.distributed.sharding``
(``TPShardPolicy`` through ``tp_put_replicated``).  The layout is the
reference's: attention heads and MLP hidden features are split over a
flat ``("tp",)`` axis, q/k/v column-sharded and head-contiguous, ``wo``
and the MLP's ``wo`` row-sharded; embeddings, ``lm_head`` and every norm
scale replicated, and so is every piece of slot bookkeeping (slot state,
page tables, free stack, quota, draft history).  KV caches split on their
head axis (axis 3 of the dense ring and of the page pool).  Each layer
costs exactly two sums, of the attention output and of the MLP output,
taken in f32 and cast back.  Every program is the unchanged single-device
program traced on a shard-local config (:func:`tp_local_cfg`: heads and
``d_ff`` divided by tp, ``d_head`` kept).

Where the reference wraps the program in a fully-manual ``shard_map`` over
the lease's devices, the port runs it in a :class:`ShardGroup`: one thread
per shard, single-controller as ``shard_map`` is, each on its own params,
its own contiguous KV cache of ``Hkv / tp`` heads and its own replica of
the replicated state, taking turns from one sum to the next inside
:class:`TPShardPolicy`.  A "mesh" is the flat numpy array
of ``torch.device`` that ``VirtualAcceleratorPool.tp_mesh_for`` returns;
on one card its entries are logical cores of the same device, and a mesh
over distinct devices is refused (ROADMAP.md Queue 1 item 18 part b).

A :class:`P` is the port's ``PartitionSpec``: a tuple holding, per
dimension, the mesh axis it is split over or ``None``.

The module also holds the reference's train-side specs (``param_specs``,
``train_batch_specs``, ``cache_specs``, ``batch_shard``) as a layout over a
mesh (``launch.mesh``), which the dry-run reads to count the bytes each
device would hold and ``distributed.spmd`` follows to place each rank's
blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.common import cost_sinks, record_collective
from ..models.attention import KVCacheView, PagedKVView
from ..models.transformer import Caches, period_structure

#: seconds a shard waits for its turn before the program fails
BARRIER_TIMEOUT_S = 600.0


class P(tuple):
    """``PartitionSpec`` stand-in: ``P(None, None, "tp")`` splits axis 2
    over the ``"tp"`` mesh axis; ``P()`` is replicated; an entry may be a
    tuple of axes (``("pod", "data")``), and a tuple of one axis is that
    axis, as in JAX's ``PartitionSpec``."""

    __slots__ = ()

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class PerShard(tuple):
    """One value per shard of a tensor-parallel program, in shard order:
    the per-shard pieces of a sharded tree, or each shard's replica of a
    replicated one."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "PerShard" + tuple.__repr__(self)


# ---------------------------------------------------------------------------
# The activation policy: two sums a layer
# ---------------------------------------------------------------------------


_SHARD = threading.local()        # .group (ShardGroup) and .rank of a shard


class TPShardPolicy:
    """Activation policy for tensor-parallel decode.

    Sums the row-sharded attention and MLP output projections over the
    shards of the running :class:`ShardGroup`; the identity for every other
    rule name.  The sum is taken in f32 in shard order and cast back to the
    input's dtype, once for all shards, so every shard continues from the
    same tensor.
    """

    def __call__(self, x, name: str):
        if name not in ("attn_out", "mlp_out"):
            return x
        group = getattr(_SHARD, "group", None)
        if group is None:
            raise RuntimeError(
                "TPShardPolicy sums over the shards of a tensor-parallel "
                "program; call the model through ShardGroup.run")
        return group.all_reduce(_SHARD.rank, x)


#: The shared instance (the policy is stateless).
TP_POLICY = TPShardPolicy()


# ---------------------------------------------------------------------------
# Which configs shard, and the shard-local model
# ---------------------------------------------------------------------------


def tp_supported(cfg) -> Optional[str]:
    """None when ``cfg`` can tensor-shard on the serving path, else the
    reason it cannot (pure-attention dense-MLP text archs only — SSM state,
    MoE dispatch, and cross-attention caches have no head axis to split)."""
    if cfg.family in ("audio", "vlm"):
        return f"family {cfg.family!r} has cross-attention/encoder state"
    specs = period_structure(cfg)
    if any(s.mixer != "attn" for s in specs):
        return "SSM/hybrid archs have no head axis in their recurrent state"
    if any(s.mlp == "moe" for s in specs):
        return "MoE expert dispatch is not tensor-shardable on this path"
    return None


def check_tp(cfg, tp: int) -> None:
    """Validate that ``cfg`` divides into ``tp`` shards; raises ValueError."""
    why = tp_supported(cfg)
    if why is not None:
        raise ValueError(f"tp={tp} unsupported for {cfg.name}: {why}")
    for dim, val in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                     ("d_ff", cfg.d_ff)):
        if val % tp:
            raise ValueError(
                f"tp={tp} must divide {dim}={val} for {cfg.name}")


def tp_local_cfg(cfg, tp: int):
    """The shard-local model: heads and hidden width divided by tp.  d_head
    is an explicit field (set in __post_init__), so it survives the replace;
    vocab / rope / norms are untouched (embeddings stay replicated)."""
    if tp <= 1:
        return cfg
    check_tp(cfg, tp)
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        d_ff=cfg.d_ff // tp,
    )


def make_tp_mesh(tp: int, devices: Optional[Sequence] = None) -> np.ndarray:
    """Flat mesh of the first ``tp`` of ``devices`` (default: ``tp``
    logical cores of the current CUDA device), the per-tenant sub-mesh a
    hypervisor lease maps to."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())] * tp
    devices = [torch.device(d) for d in devices]
    if len(devices) < tp:
        raise ValueError(f"need {tp} devices for tp={tp}, have {len(devices)}")
    mesh = np.empty(tp, dtype=object)
    for i, d in enumerate(devices[:tp]):
        mesh[i] = d
    return mesh


def _canonical(device) -> torch.device:
    """``device`` as its tensors report it (``cuda`` gets its index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


def mesh_device(mesh, expected=None) -> torch.device:
    """The one device under a flat mesh's logical cores.  Raises ValueError
    for a mesh that is not flat, or whose cores are distinct devices, or
    not ``expected`` when given."""
    arr = np.asarray(mesh, dtype=object)
    if arr.ndim != 1 or arr.size < 1:
        raise ValueError(
            "batcher meshes must be flat ('tp',) meshes "
            "(distributed.sharding.make_tp_mesh)")
    devs = {_canonical(d) for d in arr}
    if expected is not None:
        devs.add(_canonical(expected))
    if len(devs) > 1:
        raise ValueError(
            f"a tensor-parallel mesh over distinct devices "
            f"({', '.join(sorted(map(str, devs)))}) is not ported: the "
            f"port shards over the logical cores of one device; tensor "
            f"parallelism across cards is ROADMAP.md Queue 1 item 18 part b")
    return next(iter(devs))


# ---------------------------------------------------------------------------
# Parameter and cache layout
# ---------------------------------------------------------------------------


def _swiglu_tp_perm(d_ff: int, tp: int):
    """Column permutation putting swiglu's packed [gate | up] wi into
    per-shard-contiguous [gate_i | up_i] blocks, so a plain contiguous
    chunking over the last axis hands shard i exactly its gate/up columns
    (and the silu(gate_i)*up_i features line up with wo's row shard i)."""
    f = d_ff // tp
    idx = []
    for i in range(tp):
        idx.extend(range(i * f, (i + 1) * f))
        idx.extend(range(d_ff + i * f, d_ff + (i + 1) * f))
    return np.asarray(idx, dtype=np.int64)


def permute_params_for_tp(params, cfg, tp: int):
    """Relayout making every sharded matrix *contiguously* chunkable over
    its tp axis.  Only swiglu's packed wi moves (one gathered copy, on its
    device); every other leaf of the returned tree is the input's tensor:
    attention projections are head-contiguous already (contiguous head
    chunks preserve the GQA group ratio because tp divides both head
    counts)."""
    if tp <= 1 or cfg.mlp_kind != "swiglu":
        return params
    return permute_wi(params, _swiglu_tp_perm(cfg.d_ff, tp))


def permute_wi(params, perm):
    """``params`` with every MLP's ``wi`` columns taken in the order
    ``perm`` (one gathered copy each, on its device); every other leaf is
    the input's tensor."""
    out = dict(params)
    out["blocks"] = [dict(layer) for layer in params["blocks"]]
    for layer in out["blocks"]:
        if "mlp" in layer:
            m = dict(layer["mlp"])
            wi = m["wi"]
            m["wi"] = wi[..., torch.from_numpy(perm).to(wi.device)]
            layer["mlp"] = m
    return out


def tp_param_specs(cfg) -> Dict[str, Any]:
    """Spec tree over the "tp" axis, structurally matching ``init_params``
    for the pure-attention archs ``check_tp`` admits.  Attention q/k/v are
    column-sharded (head-contiguous), output projections row-sharded;
    embeddings / lm_head / every norm scale replicated.  All leaves carry
    the leading stacked-blocks axis (hence the extra None)."""
    attn: Dict[str, Any] = {
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
    }
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": P()}
        attn["k_norm"] = {"scale": P()}
    layer = {
        "ln1": {"scale": P()},
        "attn": attn,
        "ln2": {"scale": P()},
        "mlp": {"wi": P(None, None, "tp"), "wo": P(None, "tp", None)},
    }
    out: Dict[str, Any] = {
        "embed": {"w": P()},
        "final_norm": {"scale": P()},
        "blocks": [layer for _ in period_structure(cfg)],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": P()}
    return out


def tp_cache_specs(cfg, *, paged: bool) -> Caches:
    """Spec tree matching serving's ``Caches``: K/V sharded over the head
    axis (axis 3 of both the dense ring and the page pool), positions
    replicated."""
    kvspec = P(None, None, None, "tp", None)
    kv: Dict[str, Any] = {}
    for p, sp in enumerate(period_structure(cfg)):
        if sp.mixer != "attn":        # unreachable under check_tp; defensive
            raise ValueError("tp caches require a pure-attention arch")
        if paged:
            kv[str(p)] = PagedKVView(k=kvspec, v=kvspec)
        else:
            kv[str(p)] = KVCacheView(k=kvspec, v=kvspec, pos=P())
    return Caches(kv=kv, ssm={}, cross=None)


def spec_map(fn: Callable, spec, *trees):
    """``fn(spec_leaf, *leaves)`` over a spec tree and trees of its shape
    (dicts, lists, NamedTuples; ``None`` stays ``None``)."""
    if isinstance(spec, P):
        return fn(spec, *trees)
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: spec_map(fn, spec[k], *(t[k] for t in trees)) for k in spec}
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(trees[0])(*(spec_map(fn, s, *(t[i] for t in trees))
                                for i, s in enumerate(spec)))
    if isinstance(spec, (list, tuple)):
        return type(spec)(spec_map(fn, s, *(t[i] for t in trees))
                          for i, s in enumerate(spec))
    raise TypeError(f"not a spec tree node: {spec!r}")


def _axis(spec: P) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def _transpose(tree_of_lists, spec, tp: int) -> List[Any]:
    """A tree whose leaves are length-``tp`` lists -> ``tp`` trees."""
    return [spec_map(lambda _, leaf: leaf[r], spec, tree_of_lists)
            for r in range(tp)]


def tp_shards(tree, spec_tree, tp: int, *, copy: bool = False) -> PerShard:
    """Split ``tree`` into ``tp`` per-shard trees by ``spec_tree`` (the
    counterpart of ``device_put`` with ``tp_shardings``).  A sharded leaf
    becomes ``tp`` contiguous chunks of its split axis: views of it, or
    contiguous copies with ``copy=True``.  A replicated leaf is the same
    tensor in every shard, or (``copy=True``) shard 0's is the leaf and the
    others get clones, for state the programs update in place."""

    def split(spec, leaf):
        ax = _axis(spec)
        if ax is None:
            if not copy:
                return [leaf] * tp
            return [leaf] + [leaf.clone() for _ in range(tp - 1)]
        parts = list(torch.chunk(leaf, tp, dim=ax))
        if len(parts) != tp or leaf.shape[ax] % tp:
            raise ValueError(
                f"tp={tp} must divide axis {ax} of a leaf of shape "
                f"{tuple(leaf.shape)}")
        return [p.contiguous() if copy else p for p in parts]

    return PerShard(_transpose(spec_map(split, spec_tree, tree), spec_tree,
                               tp))


def tp_replicas(tree, tp: int) -> PerShard:
    """``tp`` replicas of a replicated tree (the counterpart of
    ``tp_put_replicated``): shard 0 holds ``tree`` itself, every other
    shard a clone, since the programs update slot, page and draft state
    per shard."""

    def clone(t):
        if isinstance(t, torch.Tensor):
            return t.clone()
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(clone(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(clone(v) for v in t)
        return t

    return PerShard([tree] + [clone(tree) for _ in range(tp - 1)])


def tp_gather(shards: Sequence, spec_tree):
    """The logical tree of per-shard trees: sharded leaves concatenated
    over their split axis (a new tensor), replicated leaves shard 0's."""

    def join(spec, *leaves):
        ax = _axis(spec)
        return leaves[0] if ax is None else torch.cat(leaves, dim=ax)

    return spec_map(join, spec_tree, *shards)


def tp_tree_bytes(shards: Sequence, spec_tree) -> int:
    """Bytes of the logical tree (each replicated leaf once) of per-shard
    trees, without building it."""
    total = 0

    def add(spec, *leaves):
        nonlocal total
        counted = leaves if _axis(spec) is not None else leaves[:1]
        total += sum(t.numel() * t.element_size() for t in counted)

    spec_map(add, spec_tree, *shards)
    return total


# ---------------------------------------------------------------------------
# The training layout over a production mesh, as specs only
# ---------------------------------------------------------------------------
#
# The reference's train-side specs (``repro.distributed.sharding`` :61-232,
# :371-414): parameters tensor-parallel over "model" on their width and
# FSDP over "data" on the other dimension, replicated over "pod"; batches
# over ("pod", "data"); KV caches over heads, or over their length where
# the kv heads do not divide "model".  The dry-run lays a traced program's
# arguments out by them over a mesh description (``launch.mesh``) to count
# the bytes each device would hold; ``distributed.spmd`` places each rank's
# blocks by them on a process mesh.  They read only ``mesh.shape`` (axis
# name -> size) and ``mesh.axis_names``.


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_shard(mesh, batch: int):
    """Largest prefix of the data axes that divides ``batch`` (None if the
    batch cannot be sharded at all, e.g. a batch of 1)."""
    axes = []
    prod = 1
    for a in data_axes(mesh):
        if batch % (prod * mesh_axis_size(mesh, a)) == 0:
            axes.append(a)
            prod *= mesh_axis_size(mesh, a)
        else:
            break
    return tuple(axes) if axes else None


class _Div:
    """Divisibility-gated axis chooser for one mesh.  ``fsdp=False`` keeps
    parameters off the "data" axis (the serving layout); ``moe_ep=False``
    shards each expert's width instead of the experts."""

    def __init__(self, mesh, *, fsdp: bool = True, moe_ep: bool = True):
        self.model = mesh_axis_size(mesh, "model")
        self.data = mesh_axis_size(mesh, "data")
        self.fsdp = fsdp
        self.moe_ep = moe_ep

    def m(self, dim: int):
        return "model" if dim % self.model == 0 else None

    def d(self, dim: int):
        if not self.fsdp:
            return None
        return "data" if dim % self.data == 0 else None


def _spec_attn(cfg, dv: _Div, *, cross: bool = False) -> Dict[str, Any]:
    p = {
        "wq": P(dv.d(cfg.d_model), dv.m(cfg.q_dim)),
        "wk": P(dv.d(cfg.d_model), dv.m(cfg.kv_dim)),
        "wv": P(dv.d(cfg.d_model), dv.m(cfg.kv_dim)),
        "wo": P(dv.m(cfg.q_dim), dv.d(cfg.d_model)),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = {"scale": P(None)}
        p["k_norm"] = {"scale": P(None)}
    return p


def _spec_mlp(cfg, dv: _Div, d_ff: int, *, kind: Optional[str] = None):
    kind = cfg.mlp_kind if kind is None else kind
    wi_out = 2 * d_ff if kind == "swiglu" else d_ff
    return {"wi": P(dv.d(cfg.d_model), dv.m(wi_out)),
            "wo": P(dv.m(d_ff), dv.d(cfg.d_model))}


def _spec_moe(cfg, dv: _Div) -> Dict[str, Any]:
    m = cfg.moe
    p: Dict[str, Any] = {"router": P(dv.d(cfg.d_model), None)}
    if m.n_experts % dv.model == 0 and dv.moe_ep:
        # expert parallelism: the experts over "model"
        p["wi"] = P("model", dv.d(cfg.d_model), None)
        p["wo"] = P("model", None, dv.d(cfg.d_model))
    else:
        # each expert's width over "model"
        p["wi"] = P(None, dv.d(cfg.d_model), dv.m(2 * m.expert_d_ff))
        p["wo"] = P(None, dv.m(m.expert_d_ff), dv.d(cfg.d_model))
    if m.n_shared_experts:
        p["shared"] = _spec_mlp(
            cfg, dv, m.n_shared_experts * (m.shared_d_ff or m.expert_d_ff),
            kind="swiglu")
    return p


def _spec_ssm(cfg, dv: _Div) -> Dict[str, Any]:
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    return {
        "wz": P(dv.d(cfg.d_model), dv.m(d_in)),
        "wx": P(dv.d(cfg.d_model), dv.m(d_in)),
        "wb": P(dv.d(cfg.d_model), dv.m(gn)),
        "wc": P(dv.d(cfg.d_model), dv.m(gn)),
        "wdt": P(dv.d(cfg.d_model), dv.m(nh)),
        "conv_w": P(None, None),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "norm": {"scale": P(None)},
        "out_proj": P(dv.m(d_in), dv.d(cfg.d_model)),
    }


def _spec_layer(cfg, dv: _Div, spec, *, cross: bool) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": {"scale": P(None)}}
    if spec.mixer == "attn":
        p["attn"] = _spec_attn(cfg, dv)
    else:
        p["ssm"] = _spec_ssm(cfg, dv)
    if cross:
        p["ln_x"] = {"scale": P(None)}
        p["cross"] = _spec_attn(cfg, dv, cross=True)
    if spec.mlp is not None:
        p["ln2"] = {"scale": P(None)}
        if spec.mlp == "moe":
            p["moe"] = _spec_moe(cfg, dv)
        else:
            p["mlp"] = _spec_mlp(cfg, dv, cfg.d_ff)
    return p


def _add_leading(tree):
    """Stacked-block params get an unsharded leading (block) axis."""
    return spec_map(lambda s: P(None, *s), tree)


def param_specs(cfg, mesh, *, fsdp: bool = True,
                moe_ep: bool = True) -> Dict[str, Any]:
    """Spec tree structurally matching ``models.init_params(cfg)``.
    Embedding tables are vocab-sharded over "model" with the feature dim
    replicated, as the reference's are."""
    from ..models.transformer import LayerSpec

    dv = _Div(mesh, fsdp=fsdp, moe_ep=moe_ep)
    cross = cfg.family == "audio"
    embed_spec = P(dv.m(cfg.vocab_padded), None)
    out: Dict[str, Any] = {
        "embed": {"w": embed_spec},
        "final_norm": {"scale": P(None)},
        "blocks": [_add_leading(_spec_layer(cfg, dv, s, cross=cross))
                   for s in period_structure(cfg)],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": embed_spec}
    if cfg.family == "audio":
        enc = LayerSpec(mixer="attn", mlp="mlp")
        out["encoder"] = {
            "blocks": [_add_leading(_spec_layer(cfg, dv, enc, cross=False))],
            "final_norm": {"scale": P(None)},
        }
    return out


def train_batch_specs(cfg, mesh, *, batch: int) -> Dict[str, P]:
    ba = batch_shard(mesh, batch)
    specs = {"tokens": P(ba, None), "labels": P(ba, None)}
    if cfg.family == "vlm":
        specs["extra_embeds"] = P(ba, None, None)            # (B, Sv, d)
        specs["positions"] = P(None, ba, None)               # (3, B, S)
    if cfg.family == "audio":
        specs["frames"] = P(ba, None, None)                  # (B, S_enc, d)
    return specs


def cache_specs(cfg, mesh, *, batch: int) -> Caches:
    """Spec tree structurally matching ``models.init_caches``: kv heads
    over "model" where they divide it, else the cache length; the batch
    over the data axes where it divides them."""
    from ..models.ssm import SSMState

    dv = _Div(mesh)
    ba = batch_shard(mesh, batch)
    specs = period_structure(cfg)
    kv: Dict[str, Any] = {}
    ssm: Dict[str, Any] = {}
    kv_heads_ok = cfg.n_kv_heads % dv.model == 0
    for p, sp in enumerate(specs):
        if sp.mixer == "attn":
            if kv_heads_ok:
                kvspec, pspec = P(None, ba, None, "model", None), P(None, ba, None)
            else:
                kvspec, pspec = P(None, ba, "model", None, None), P(None, ba, "model")
            kv[str(p)] = KVCacheView(k=kvspec, v=kvspec, pos=pspec)
        else:
            nh = cfg.ssm.n_ssm_heads(cfg.d_model)
            ssm[str(p)] = SSMState(conv=P(None, ba, None, None),
                                   ssm=P(None, ba, dv.m(nh), None, None))
    cross = None
    if cfg.family == "audio":
        cross = {str(p): (P(None, ba, None, None, None),
                          P(None, ba, None, None, None))
                 for p in range(len(specs))}
    return Caches(kv=kv, ssm=ssm, cross=cross)


# ---------------------------------------------------------------------------
# The runtime: one thread a shard, taking turns from one sum to the next
# ---------------------------------------------------------------------------


def _thread_context(device: torch.device):
    """A context factory that puts a worker thread in the caller's state:
    grad and inference mode, and on the card the caller's current device
    and stream, so every shard enqueues on one stream in host order; under
    ``op_static.analyze`` its op counter too, which is per thread."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    sinks = cost_sinks()

    @contextlib.contextmanager
    def enter():
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode(inference))
            stack.enter_context(torch.set_grad_enabled(grad))
            for sink in sinks:
                stack.enter_context(sink.thread_mode())
            if stream is not None:
                stack.enter_context(torch.cuda.device(stream.device))
                stack.enter_context(torch.cuda.stream(stream))
            yield

    return enter


class _Aborted(Exception):
    """Raised in a shard woken because another shard failed."""


class ShardGroup:
    """The shards of one tensor-parallel program over a flat mesh of
    logical cores of one device.

    :meth:`run` calls the program on every shard: shard 0 in the caller's
    thread, the others in worker threads that enter the caller's device,
    stream and grad mode.  The shards take turns, like coroutines: one
    runs at a time, from one sum to the next, then hands the turn on.
    Inside, :class:`TPShardPolicy` reaches :meth:`all_reduce`: a shard
    leaves its partial and passes the turn; the last shard adds the
    partials in f32 in shard order, casts back and passes the turn to
    shard 0, and every shard continues from that one tensor.  On one card
    the shards share one stream, so running them together would buy
    nothing, while threads that run at once contend for the interpreter
    lock at every eager op; taking turns costs one hand-off a shard a sum.
    A shard that raises wakes the others, which stop, and :meth:`run`
    re-raises its exception in the caller; a shard that waits more than
    ``timeout`` seconds for its turn fails the program too.
    """

    def __init__(self, mesh, *, timeout: float = BARRIER_TIMEOUT_S):
        self.device = mesh_device(mesh)
        self.tp = len(np.asarray(mesh, dtype=object))
        self.timeout = timeout
        self.all_reduces = 0          # sums taken, one per layer half a step
        self._parts: List[Optional[torch.Tensor]] = [None] * self.tp
        self._total: Optional[torch.Tensor] = None
        self._turns = [threading.Event() for _ in range(self.tp)]
        self._failed = False
        self._pool = (ThreadPoolExecutor(max_workers=self.tp - 1,
                                         thread_name_prefix="tp-shard")
                      if self.tp > 1 else None)

    def close(self) -> None:
        """Let the worker threads go (a re-meshed batcher drops its group)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def _pass(self, rank: int) -> None:
        self._turns[(rank + 1) % self.tp].set()

    def _wait_turn(self, rank: int) -> None:
        turn = self._turns[rank]
        if not turn.wait(self.timeout):
            self._fail()
            raise RuntimeError(
                f"shard {rank} of the tp={self.tp} program waited more than "
                f"{self.timeout} s for its turn")
        turn.clear()
        if self._failed:
            raise _Aborted()

    def _fail(self) -> None:
        self._failed = True
        for turn in self._turns:
            turn.set()

    def all_reduce(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``x``, the same tensor for all.  Each
        shard's call counts its own wire bytes of a ring all-reduce,
        2 size (N - 1) / N, to the open cost sinks (``op_static``)."""
        n_bytes = x.numel() * x.element_size()
        record_collective("all-reduce", 2.0 * n_bytes * (self.tp - 1) / self.tp,
                          n_bytes)
        self._parts[rank] = x
        if rank == self.tp - 1:
            parts, self._parts = self._parts, [None] * self.tp
            if any(part is None for part in parts):
                raise RuntimeError(
                    f"a shard of the tp={self.tp} program ended before "
                    f"its sum")
            acc = parts[0].float()
            for part in parts[1:]:
                acc = acc + part.float()
            self._total = acc.to(x.dtype)
            self.all_reduces += 1
        total_before = self._total
        self._pass(rank)
        self._wait_turn(rank)
        if rank != self.tp - 1 and self._total is total_before:
            raise RuntimeError(
                f"a shard of the tp={self.tp} program ended before its sum")
        return self._total

    def _shard(self, rank: int, fn, args, enter):
        prev = (getattr(_SHARD, "group", None), getattr(_SHARD, "rank", None))
        _SHARD.group, _SHARD.rank = self, rank
        try:
            self._wait_turn(rank)
            with enter():
                out = fn(*args)
            self._pass(rank)
            return out
        except _Aborted:
            raise
        except BaseException:
            self._fail()               # wake the shards waiting on this one
            raise
        finally:
            _SHARD.group, _SHARD.rank = prev

    def run(self, fn, shard_args: Sequence[Sequence]) -> List[Any]:
        """``fn(*shard_args[r])`` on every shard ``r``, taking turns; the
        list of their results, in shard order."""
        for turn in self._turns:
            turn.clear()
        self._failed = False
        self._parts = [None] * self.tp
        self._turns[0].set()
        enter = _thread_context(self.device)
        futures = [self._pool.submit(self._shard, r, fn, shard_args[r], enter)
                   for r in range(1, self.tp)]
        results: List[Any] = [None] * self.tp
        errors: List[Optional[BaseException]] = [None] * self.tp
        try:
            results[0] = self._shard(0, fn, shard_args[0],
                                     contextlib.nullcontext)
        except BaseException as e:           # noqa: BLE001 (re-raised below)
            errors[0] = e
        for r, fut in enumerate(futures, start=1):
            try:
                results[r] = fut.result(timeout=self.timeout)
            except BaseException as e:       # noqa: BLE001 (re-raised below)
                errors[r] = e
        for e in errors:
            if e is not None and not isinstance(e, _Aborted):
                raise e
        return results


__all__ = [
    "BARRIER_TIMEOUT_S", "P", "PerShard", "ShardGroup", "TPShardPolicy",
    "TP_POLICY", "batch_shard", "cache_specs", "check_tp", "data_axes",
    "make_tp_mesh", "mesh_axis_size", "mesh_device", "param_specs",
    "permute_params_for_tp", "permute_wi", "spec_map", "tp_cache_specs",
    "tp_gather", "tp_local_cfg", "tp_param_specs", "tp_replicas",
    "tp_shards", "tp_supported", "tp_tree_bytes", "train_batch_specs",
]
