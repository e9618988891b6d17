"""Step functions: the loss and the train step, with remat, gradient
accumulation, clipping, LR schedules and AdamW.

Counterpart of ``repro.training.steps``.  ``make_train_step`` builds the
step for one (arch, trainer) config:

    params, opt_state, metrics = train_step(params, opt_state, batch)

``batch`` is a dict of tensors on the params' device
(:func:`batch_to_torch` moves a numpy batch of ``repro_torch.data`` there).
The step returns new trees and leaves its arguments as they were (the
reference's jitted step donates them instead).

* the loss is family-aware: the VLM's patch embeddings and M-RoPE
  positions, the audio family's encoder over the stub frames, MoE's
  load-balance loss weighted by ``aux_coef``;
* ``remat`` ("none" | "dots" | "full") checkpoints each period of layers
  (``models.transformer._remat_wrap``);
* ``grad_accum`` splits the batch into microbatches along axis 0 (axis 1
  for the (3, B, S) positions) and accumulates their gradients in f32;
* global-norm clipping, then the schedule's LR, then AdamW (f32 or 8-bit
  moments).

``attn_impl`` takes the ``"train"`` row of
``models.attention.ATTN_CAPABILITIES``: ``"torch"`` (the port's name for
the reference's ``"xla"``, the default), ``"flash"`` (the prefill kernel
under ``FlashAttentionFn`` on the card) or ``"naive"``.  ``"cuda"`` is
refused: the reference's ``"pallas"`` cannot be differentiated (its
``pallas_call`` has no JVP rule that ``jax.grad`` can use), so its only
differentiable fast path is ``"flash"``, and so is the port's.

Under an SPMD ``policy`` (``distributed.spmd.make_policy``, the
reference's GSPMD program with its policy) the step runs on one rank of a
process mesh over "pod", "data" and "model": the rank's
``param_shardings`` blocks of the params and moments, its ``shard_batch``
rows, collectives that autograd differentiates, the loss over the whole
batch's count, the gradients summed over the data axes after the
backward, the whole tree's norm, and AdamW on the blocks
(``distributed.spmd``'s docstring).  On a mesh description (the dry-run's
production meshes) the program is the global one and the policy records
every collective, the backward's too.  ``compress_pods`` under a policy
over a "pod" axis is refused: the reference's own step fails there.

Without a policy, over the ``"pod"`` axis of a process mesh
(``launch.mesh.make_host_mesh`` inside a ``torch.distributed`` group, one
rank a pod) each rank takes the batch rows of its pod, computes their
gradients, and the pods' gradients are combined: with ``compress_pods``
by ``distributed.compression.pod_psum_compressed`` (the reference's
per-pod branch under its ``shard_map``), otherwise by an f32 mean, the
all-reduce the reference's GSPMD program makes; the metrics are the pods'
means.  Every rank then takes the same clip and AdamW step on its replica
of the params.  Without a ``"pod"`` axis the reference takes its own
uncompressed branch, and so does the port, as it does on a mesh
description, where ``compress_pods`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..models import encoder_forward, forward, lm_loss
from ..models.attention import check_attn_impl
from ..obs import profiled
from ..optim import adamw_update, clip_by_global_norm
from ..optim.schedules import SCHEDULES
from ..tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    lr: float = 3e-4
    schedule: str = "constant"
    warmup: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_coef: float = 0.01          # MoE load-balance loss weight
    quantize_opt: bool = False      # 8-bit AdamW moments
    remat: str = "none"             # none | dots | full
    grad_accum: int = 1
    compress_pods: bool = False     # int8 cross-pod grad all-reduce
    attn_impl: str = "torch"        # torch | flash | naive
    loss_chunk: int = 1024

    def __post_init__(self):
        if self.attn_impl == "cuda":
            raise ValueError(
                "attn_impl='cuda' cannot be trained: the reference's "
                "'pallas' kernels have no usable gradient, so training runs "
                "the prefill kernel through attn_impl='flash' (its "
                "autograd.Function)")
        check_attn_impl(self.attn_impl, "train")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"unknown remat policy {self.remat!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {sorted(SCHEDULES)}")

    def lr_fn(self):
        sched = SCHEDULES[self.schedule]
        if self.schedule == "constant":
            return sched(self.lr)
        return sched(self.lr, self.warmup, self.total_steps)


def batch_to_torch(batch: Dict[str, np.ndarray], device="cuda"):
    """A numpy batch (``repro_torch.data.make_batch``) as tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _forward_kwargs(cfg, batch: Dict[str, Any], *, impl, policy, remat):
    kw = dict(impl=impl, policy=policy, remat=remat)
    if cfg.family == "vlm":
        kw["extra_embeds"] = batch["extra_embeds"]
        kw["positions"] = batch["positions"]
    return kw


def make_loss_fn(cfg, tcfg: TrainerConfig, *, policy=None):
    """loss_fn(params, batch) -> (loss + aux_coef * aux, metrics).

    The audio family's stub frames are cast to the model's dtype before the
    encoder (the reference adds its f32 frames to bf16 weights by type
    promotion, which torch's products do not do; at f32 the two agree).
    Under an SPMD policy (``distributed.spmd.ActivationPolicy``) ``batch``
    is the rank's rows and the loss their summed loss over the whole
    batch's count of valid labels, so the ranks' losses add up to the
    global mean."""
    spmd = _is_spmd(policy)

    def loss_fn(params, batch):
        kw = _forward_kwargs(cfg, batch, impl=tcfg.attn_impl, policy=policy,
                             remat=tcfg.remat)
        if cfg.family == "audio":
            kw["enc_out"] = encoder_forward(
                params, batch["frames"].to(torch_dtype(cfg.dtype)), cfg,
                impl=tcfg.attn_impl, policy=policy, remat=tcfg.remat)
        out = forward(params, batch["tokens"], cfg, **kw)
        sum_loss, count = lm_loss(params, out.hidden, batch["labels"], cfg,
                                  chunk=tcfg.loss_chunk, policy=policy)
        if spmd:
            # the rank's rows' share of the mean over the whole batch
            count = policy.global_count(count)
        loss = sum_loss / torch.clamp(count.float(), min=1.0)
        total = loss + tcfg.aux_coef * out.aux
        metrics = {"loss": loss, "aux": out.aux, "tokens": count}
        return total, metrics

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads) of ``loss_fn(params, batch)`` with respect
    to every leaf of ``params``; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives them."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves(ps)
    with torch.enable_grad():
        total, metrics = loss_fn(ps, batch)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (total.detach(), metrics), unflatten_like(params, grads)


def _split(x, n_accum: int):
    """Microbatches of one batch tensor: along axis 0, or axis 1 for the
    (3, B, S) int32 M-RoPE positions."""
    if x.dim() == 0:
        return [x] * n_accum
    axis = 1 if x.dim() == 3 and x.shape[0] == 3 and x.dtype == torch.int32 else 0
    return list(torch.chunk(x, n_accum, dim=axis))


def _accumulate_grads(loss_fn, params, batch, n_accum: int):
    """Microbatches in order, gradients summed in f32 and averaged (the
    reference's ``lax.scan`` with an f32 accumulator)."""
    for k, x in batch.items():
        axis = 1 if x.dim() == 3 and x.shape[0] == 3 and x.dtype == torch.int32 else 0
        if x.dim() and x.shape[axis] % n_accum:
            raise ValueError(f"batch[{k!r}] has {x.shape[axis]} rows, not a "
                             f"multiple of grad_accum={n_accum}")
    split = {k: _split(x, n_accum) for k, x in batch.items()}
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    tok_acc = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n_accum):
        mb = {k: v[i] for k, v in split.items()}
        (_, metrics), g = value_and_grad(loss_fn, params, mb)
        g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
        del g
        loss_acc = loss_acc + metrics["loss"]
        tok_acc = tok_acc + metrics["tokens"]
        aux_acc = aux_acc + metrics["aux"]
    g = tree_map(lambda x: x / n_accum, g_acc)
    return g, {"loss": loss_acc / n_accum, "aux": aux_acc / n_accum,
               "tokens": tok_acc}


def _is_spmd(policy) -> bool:
    """Whether ``policy`` is an SPMD rank's (``distributed.spmd``), as
    opposed to none or the tensor-parallel serving policy."""
    return policy is not None and hasattr(policy, "reduce_grads")


def _has_pod_axis(mesh) -> bool:
    names = getattr(mesh, "axis_names", ())
    return "pod" in names and int(mesh.shape["pod"]) > 1


def _pod_mesh(mesh, compress: bool) -> bool:
    """Whether the step without a policy combines gradients over the "pod"
    axis of a process mesh.  On a mesh description the step is the global
    program (the reference's GSPMD branch), except that the compressed
    all-reduce needs the pods' processes: it raises, as does a process mesh
    that also splits "data" or "model", whose layout a policy places."""
    if mesh is None or not _has_pod_axis(mesh):
        return False
    if not getattr(mesh, "is_process_mesh", False):
        if not compress:
            return False
        raise NotImplementedError(
            "a 'pod' mesh axis needs a process group: build the mesh with "
            "launch.mesh.make_host_mesh inside torch.distributed, one rank "
            "a pod (across cards: ROADMAP.md Queue 1 item 18 part b)")
    others = [a for a in mesh.axis_names if a != "pod" and mesh.shape[a] > 1]
    if others:
        raise NotImplementedError(
            f"the train step without a policy shards over the 'pod' axis "
            f"only, not over {others}: pass policy=make_policy(cfg, mesh, "
            f"batch=...) (distributed.spmd), with the params placed by "
            f"param_shardings")
    return True


def _refuse_compressed_under_policy(mesh) -> None:
    """``compress_pods`` over a "pod" axis under a policy: the reference's
    own step fails there, on every mesh ``make_policy`` covers, so the port
    refuses it."""
    if mesh is not None and _has_pod_axis(mesh):
        raise NotImplementedError(
            "compress_pods under an ActivationPolicy: the reference's "
            "shard_map over 'pod' cannot take the policy's sharding rules "
            "(its step raises ValueError under every make_policy); train "
            "under the policy with compress_pods=False (the pods' gradients "
            "summed uncompressed), or with compress_pods and no policy on a "
            "'pod'-only process mesh")


def make_train_step(cfg, tcfg: TrainerConfig, *, policy=None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): metrics ``loss``, ``aux``, ``tokens``, ``grad_norm``, ``lr``.

    Under an SPMD ``policy`` (``make_policy(cfg, mesh, batch=B)``) the
    params and optimizer state are the rank's ``param_shardings`` blocks
    and ``batch`` its ``shard_batch`` rows (of each microbatch under
    ``grad_accum``: ``shard_batch(..., micro=grad_accum)``); the step is
    the module docstring's.  Without one, on a process mesh whose "pod"
    axis has several ranks, ``batch`` is this rank's pod's rows and the
    gradients are combined over the pods.  Raises ``NotImplementedError``
    for ``compress_pods`` on a "pod" mesh that is only a description or
    under a policy, and for a process mesh without a policy that also
    splits "data" or "model".

    ``train_step(..., keep_grads=True)`` also returns, fourth, the
    gradients as the step has them before clipping (under a policy the
    whole tree's gradients of the rank's blocks)."""
    spmd = _is_spmd(policy)
    if spmd and tcfg.compress_pods:
        _refuse_compressed_under_policy(mesh if mesh is not None
                                        else policy.mesh)
    pods = not spmd and _pod_mesh(mesh, tcfg.compress_pods)
    loss_fn = make_loss_fn(cfg, tcfg, policy=policy)
    lr_fn = tcfg.lr_fn()

    def local_grads(params, batch):
        if tcfg.grad_accum > 1:
            return _accumulate_grads(loss_fn, params, batch, tcfg.grad_accum)
        (_, metrics), g = value_and_grad(loss_fn, params, batch)
        return g, metrics

    def pod_grads(params, batch):
        from ..distributed.compression import pod_psum_compressed
        from ..distributed.spmd import mesh_all_reduce

        g, metrics = local_grads(params, batch)
        n = int(mesh.shape["pod"])
        if tcfg.compress_pods:
            zeros = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                   device=x.device), g)
            g, _ = pod_psum_compressed(g, zeros, mesh=mesh, axis="pod")
        else:
            g = tree_map(lambda x: mesh_all_reduce(x.float(), mesh, "pod") / n,
                         g)
        metrics = {k: mesh_all_reduce(torch.as_tensor(v).float(), mesh,
                                      "pod") / n
                   for k, v in metrics.items()}
        return g, metrics

    def spmd_grads(params, batch):
        g, metrics = local_grads(params, batch)
        return policy.reduce_grads(g), policy.reduce_metrics(metrics)

    compute_grads = (spmd_grads if spmd else pod_grads if pods
                     else local_grads)
    rank_policy = policy if spmd else None

    def train_step(params, opt_state, batch, *, keep_grads=False):
        grads, metrics = compute_grads(params, batch)
        kept = grads
        # a profiler range while a profiler records (chip_smoke.py splits
        # a training window's device time by it)
        with profiled("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm,
                                               policy=rank_policy)
            lr = lr_fn(opt_state.step)
            params, opt_state = adamw_update(
                grads, opt_state, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                weight_decay=tcfg.weight_decay, quantized=tcfg.quantize_opt,
                policy=rank_policy)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        if keep_grads:
            return params, opt_state, metrics, kept
        return params, opt_state, metrics

    return train_step


__all__ = ["TrainerConfig", "batch_to_torch", "make_loss_fn",
           "make_train_step", "value_and_grad"]
