"""Cell construction: (arch × shape × mesh) → program, abstract arguments,
their layout, and the model FLOPs.

Counterpart of ``repro.launch.cells``.  A *cell* bundles what the dry-run
and the card's cells read:

    program          the step callable (train_step / prefill_step /
                     serve_step); every serving step is built under
                     ``distributed.spmd.make_policy`` (``policy``, with
                     the cell's ``fsdp`` and ``moe_ep``), so on a mesh
                     description its trace records each collective a
                     device would issue, and on a process mesh it runs
                     one rank's share; so is every train step, whose
                     record holds the backward's collectives too
    abstract_args    the arguments as ``meta`` tensors (shapes and dtypes,
                     no memory), the reference's ``ShapeDtypeStruct``s
    in_specs         the arguments' layout over ``mesh`` (``P`` trees)
    donate_argnums   the arguments the step may overwrite (params and
                     moments for train, caches for decode), as the
                     reference's; the port's steps update caches in place
    model_flops      6·N_active·D (train), 2·N_active·D (prefill) or
                     2·N_active·B (decode), for the useful-FLOPs ratio

``Cell.analyze()`` counts the program's cost on the abstract arguments
(``distributed.op_static``); ``Cell.materialize`` and ``Cell.run`` execute
it on a real device with seeded inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import SHAPES, ShapeConfig, get_config, get_reduced
from ..data.synthetic import VLM_PATCHES, VLM_PATCHES_REDUCED, make_batch
from ..device import resolve_device, torch_dtype
from ..distributed.sharding import (
    P, batch_shard, cache_specs, param_specs, train_batch_specs,
)
from ..distributed.spmd import make_policy
from ..models import init_caches, init_params
from ..optim import adamw_init, opt_state_specs
from ..serving.engine import ServeConfig, make_prefill_step, make_serve_step
from ..training.steps import TrainerConfig, make_train_step
from ..tree import leaves


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    mesh: Any
    program: Callable
    abstract_args: Tuple
    in_specs: Tuple
    out_specs: Any
    donate_argnums: Tuple[int, ...]
    model_flops: float
    cfg: Any
    note: str = ""
    reduced: bool = False
    tcfg: Optional[TrainerConfig] = None     # train cells' trainer config
    policy: Any = None                       # distributed.spmd.ActivationPolicy

    def analyze(self):
        """The program's cost on the abstract arguments
        (``op_static.analyze``): kernels through their ``cost``."""
        from ..distributed.op_static import analyze

        return analyze(self.program, *self.abstract_args)

    def materialize(self, device="cuda", seed: int = 0) -> Tuple:
        """The arguments on ``device``, made from ``seed``: the params
        (``init_params``), the batch (``data.make_batch``, step 0) and zero
        moments for train; for decode the last tokens, caches whose every
        slot holds a seeded K/V row at positions 0 .. C-1 (SSM and cross
        states seeded too), and ``cur_pos = C``, the next position, so
        every slot is valid."""
        dev = resolve_device(device)
        cfg, shape = self.cfg, self.shape
        params = init_params(cfg, seed, device=dev)
        if shape.kind in ("train", "prefill"):
            batch = _batch_to(make_batch(
                cfg, seq_len=shape.seq_len, batch=shape.global_batch, step=0,
                seed=seed, reduced=self.reduced), cfg, dev)
            if shape.kind == "prefill":
                batch.pop("labels")
                return params, batch
            return (params, adamw_init(params, quantize=self.tcfg.quantize_opt),
                    batch)
        B, S = shape.global_batch, shape.seq_len
        caches = fill_caches(init_caches(cfg, B, S, device=dev), seed)
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, size=B, dtype=np.int32)).to(dev)
        C = _cache_len(caches, S)
        cur_pos = torch.full((B,), C, dtype=torch.int32, device=dev)
        return params, tokens, caches, cur_pos, None

    def run(self, *args):
        """The program on real arguments (``materialize``'s)."""
        if self.shape.kind == "train":
            return self.program(*args)
        with torch.no_grad():
            return self.program(*args)


def _batch_to(batch: Dict[str, np.ndarray], cfg, dev) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``dev``; the VLM's patch embeddings and
    the audio frames in the model's dtype, as the abstract batch has them."""
    dt = torch_dtype(cfg.dtype)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        out[k] = t.to(dt) if k in ("extra_embeds", "frames") else t
    return out


def _cache_len(caches, S: int) -> int:
    for view in caches.kv.values():
        return view.k.shape[2]
    return S


def fill_caches(caches, seed: int):
    """``caches`` (from ``init_caches``) filled in place with seeded values:
    K/V rows ~ N(0, 1) in the cache dtype at positions 0 .. C-1, SSM and
    cross states ~ N(0, 1) scaled by 0.1.  Returns ``caches``."""
    tensors = [t for t in leaves(caches) if isinstance(t, torch.Tensor)]
    if not tensors:
        return caches
    gen = torch.Generator(device=tensors[0].device)
    gen.manual_seed(int(seed))

    def rand_(t, scale=1.0):
        for blk in t:          # a block at a time: one block's f32 temporary
            blk.copy_(torch.randn(blk.shape, generator=gen, device=t.device,
                                  dtype=torch.float32) * scale)

    for view in caches.kv.values():
        rand_(view.k)
        rand_(view.v)
        C = view.pos.shape[-1]
        view.pos.copy_(torch.arange(C, dtype=view.pos.dtype,
                                    device=view.pos.device).expand_as(view.pos))
    for st in caches.ssm.values():
        rand_(st.conv, 0.1)
        rand_(st.ssm, 0.1)
    for k, v in (caches.cross or {}).values():
        rand_(k)
        rand_(v)
    return caches


def trainer_defaults(cfg, shape: ShapeConfig, *, attn_impl: str = "torch",
                     remat: str = "full") -> TrainerConfig:
    """The reference's defaults: int8 moments above 40e9 parameters, full
    remat, loss chunks of 128; ``"torch"`` is the port's name for the
    reference's ``"xla"`` route."""
    return TrainerConfig(
        quantize_opt=cfg.param_count() > 40e9,
        remat=remat,
        loss_chunk=128,
        attn_impl=attn_impl,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg, shape: ShapeConfig, *, with_labels: bool,
                   reduced: bool = False) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    n_patch = 0
    if cfg.family == "vlm":
        n_patch = VLM_PATCHES_REDUCED if reduced else VLM_PATCHES
    d: Dict[str, torch.Tensor] = {"tokens": _meta((B, S - n_patch), torch.int32)}
    if with_labels:
        d["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        d["extra_embeds"] = _meta((B, n_patch, cfg.d_model), dt)
        d["positions"] = _meta((3, B, S), torch.int32)
    if cfg.family == "audio":
        d["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), dt)
    return d


def abstract_params(cfg) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: the reference's shapes and
    dtypes, no memory and no values."""
    return init_params(cfg, device="meta")


def _logits_spec(cfg, mesh, ba):
    return P(ba, "model" if cfg.vocab_padded % mesh.shape["model"] == 0
             else None)


def build_cell(
    arch: str, shape: Union[str, ShapeConfig], mesh, *, reduced: bool = False,
    tcfg: Optional[TrainerConfig] = None, attn_impl: str = "torch",
    remat: str = "full", fsdp: bool = True, moe_ep: bool = True,
) -> Cell:
    """The cell of ``arch`` at ``shape`` over ``mesh`` (``launch.mesh``).
    ``shape`` is a name of ``configs.SHAPES`` or, where the reference takes
    only a name, a ``ShapeConfig`` (the card's one-card cut of a cell keeps
    its ``seq_len`` and cuts its batch).  ``reduced`` takes the smoke
    config and cuts the shape to seq_len <= 64, batch <= 4, as the
    reference does.  ``attn_impl`` is the program's route: ``"torch"`` (the
    reference's ``"xla"``), ``"cuda"`` for the serving steps' kernels,
    ``"flash"`` for training's."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if reduced:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 64),
            global_batch=min(shape.global_batch, 4))
    B, S = shape.global_batch, shape.seq_len
    ba = batch_shard(mesh, B)
    p_specs = param_specs(cfg, mesh, fsdp=fsdp, moe_ep=moe_ep)
    params_abs = abstract_params(cfg)
    n_active = cfg.param_count(active_only=True)
    policy = make_policy(cfg, mesh, batch=B, fsdp=fsdp, moe_ep=moe_ep)

    if shape.kind == "train":
        tcfg = tcfg or trainer_defaults(cfg, shape, attn_impl=attn_impl,
                                        remat=remat)
        program = make_train_step(cfg, tcfg, policy=policy, mesh=mesh)
        opt_abs = adamw_init(params_abs, quantize=tcfg.quantize_opt)
        o_specs = opt_state_specs(p_specs, quantize=tcfg.quantize_opt,
                                  params=params_abs, mesh=mesh)
        batch_abs = abstract_batch(cfg, shape, with_labels=True,
                                   reduced=reduced)
        b_specs = train_batch_specs(cfg, mesh, batch=B)
        return Cell(
            arch=arch, shape=shape, mesh=mesh, program=program,
            abstract_args=(params_abs, opt_abs, batch_abs),
            in_specs=(p_specs, o_specs, {k: b_specs[k] for k in batch_abs}),
            out_specs=(p_specs, o_specs, None),
            donate_argnums=(0, 1),
            model_flops=6.0 * n_active * shape.tokens,
            cfg=cfg, reduced=reduced, tcfg=tcfg, policy=policy,
        )

    scfg = ServeConfig(max_len=S, attn_impl=attn_impl)
    c_specs = cache_specs(cfg, mesh, batch=B)

    if shape.kind == "prefill":
        program = make_prefill_step(cfg, scfg, policy=policy)
        batch_abs = abstract_batch(cfg, shape, with_labels=False,
                                   reduced=reduced)
        b_specs = train_batch_specs(cfg, mesh, batch=B)
        return Cell(
            arch=arch, shape=shape, mesh=mesh, program=program,
            abstract_args=(params_abs, batch_abs),
            in_specs=(p_specs, {k: b_specs[k] for k in batch_abs}),
            out_specs=(_logits_spec(cfg, mesh, ba), c_specs),
            donate_argnums=(),
            model_flops=2.0 * n_active * shape.tokens,
            cfg=cfg, reduced=reduced, policy=policy,
        )

    # decode: serve_step(params, tokens, caches, cur_pos, key)
    program = make_serve_step(cfg, scfg, policy=policy)
    caches_abs = init_caches(cfg, B, S, device="meta")
    tok_abs = _meta((B,), torch.int32)
    pos_abs = _meta((B,), torch.int32)
    return Cell(
        arch=arch, shape=shape, mesh=mesh, program=program,
        abstract_args=(params_abs, tok_abs, caches_abs, pos_abs, None),
        in_specs=(p_specs, P(ba), c_specs, P(ba), None),
        out_specs=(P(ba), _logits_spec(cfg, mesh, ba), c_specs),
        donate_argnums=(2,),
        model_flops=2.0 * n_active * B,
        cfg=cfg, reduced=reduced, policy=policy,
        note="the sampling key is a torch.Generator or None, no tensor",
    )


def _split_factor(spec, mesh) -> int:
    """Devices a leaf laid out by ``spec`` is split over."""
    n = 1
    for ax in spec:
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            if name is not None:
                n *= int(mesh.shape[name])
    return n


def _spec_leaves(spec_tree, tree):
    """(spec, tensor) of each tensor of ``tree`` under ``spec_tree`` (a
    ``None`` spec replicates its subtree)."""
    out = []

    def visit(spec, node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out.append((spec, node))
            return
        if spec is None or isinstance(spec, P):
            out.extend((spec or P(), leaf) for leaf in leaves(node)
                       if isinstance(leaf, torch.Tensor))
        elif isinstance(node, dict):
            for k in node:
                visit(spec[k], node[k])
        else:                                 # lists, tuples, NamedTuples
            for s, n in zip(spec, node):
                visit(s, n)

    visit(spec_tree, tree)
    return out


def argument_bytes_per_device(cell: Cell, totals=None) -> float:
    """Bytes of the cell's arguments a device holds: each leaf's bytes
    divided by the product of the mesh axes its spec splits it over, as
    the reference's ``argument_size_in_bytes`` counts them.  With
    ``totals`` (``cell.analyze()``'s), only the arguments the program reads
    count: ``jax.jit`` drops the others from a compiled program's arguments
    (the audio decoder's encoder weights, an SSM's unused positions)."""
    total = 0.0
    for spec, leaf in _spec_leaves(tuple(cell.in_specs),
                                   tuple(cell.abstract_args)):
        if totals is not None and id(leaf) not in totals.read_args:
            continue
        total += leaf.numel() * leaf.element_size() / _split_factor(spec, cell.mesh)
    return total


__all__ = ["Cell", "abstract_batch", "abstract_params",
           "argument_bytes_per_device", "build_cell", "fill_caches",
           "trainer_defaults"]
