"""AdamW with optional block-quantized (8-bit) first and second moments.

Counterpart of ``repro.optim.adamw`` (lines 34-130), as plain functions
over the parameter tree rather than ``torch.optim.AdamW``, so every f32
operation stands in the reference's order:

    state  = adamw_init(params, quantize=...)
    params, state = adamw_update(grads, state, params, lr=..., ...)

Memory modes: f32 moments (8 B a parameter of optimizer state), or
``quantize=True``: int8 block-quantized m and v (1 B + 4 B a 256-block
each, about 2.03 B a parameter), dequantized, updated and requantized each
step, the second moment quantized in sqrt-space.  The state is a
:class:`AdamWState` of the reference's field names, so a checkpoint's keys
(``['opt'].m['embed']['w'].q``) match in both packages.  Both functions
return new tensors and leave their arguments as they were.

``opt_state_specs`` lays the state out over a mesh description (the
dry-run's ZeRO layout, ``launch.mesh``); no tensor is placed by it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..distributed.compression import dequantize_int8, quantize_int8
from ..tree import leaves, tree_map, unflatten_like

QBLOCK = 256


class QTensor(NamedTuple):
    """Block-quantized tensor: q (nb, QBLOCK) int8, scale (nb, 1) f32.  The
    shape is the parameter's at the same place in the tree."""

    q: torch.Tensor
    scale: torch.Tensor


def _q(x) -> QTensor:
    q, s = quantize_int8(x, block=QBLOCK)
    return QTensor(q=q, scale=s)


def _dq(qt: QTensor, shape):
    return dequantize_int8(qt.q, qt.scale, shape, block=QBLOCK)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any                  # tree of f32 tensors or QTensors
    v: Any


def adamw_init(params, *, quantize: bool = False, policy=None) -> AdamWState:
    """Zero moments on each parameter's device; ``step`` on the first
    parameter's.  ``params`` may be an SPMD rank's blocks: f32 moments are
    then its blocks; quantized ones need the rank's ``policy``
    (:func:`adamw_update`)."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    make = (lambda p: _q(z(p))) if quantize else z
    if quantize and policy is not None and policy.live:
        def make(p, plan):
            (q, s), = policy.quantize_moments([z(p)], [plan], QBLOCK)
            return QTensor(q=q, scale=s)

        plans = policy.leaf_plans()
        m = tree_map(make, params, plans)
        v = tree_map(make, params, plans)
    else:
        m, v = tree_map(make, params), tree_map(make, params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v)


def global_norm(tree, *, policy=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, the leaves added in
    the reference's order.  Under an SPMD ``policy`` the leaves are one
    rank's blocks and the norm is the whole tree's, each element counted
    once: a leaf's squares are summed over the mesh axes its blocks are
    split on, not over those it is replicated on
    (``ActivationPolicy.global_norm``), so every rank gets one value."""
    if policy is not None:
        return policy.global_norm(tree)
    total = 0
    for x in leaves(tree):
        xf = x.float()
        total = total + torch.sum(xf * xf)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, *, policy=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping); ``policy`` as :func:`global_norm` takes it.  The
    scale is elementwise, so a rank scales its blocks alone."""
    norm = global_norm(grads, policy=policy)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    quantized: bool = False,
    policy=None,
) -> Tuple[Any, AdamWState]:
    """One AdamW step.  ``lr`` may be a float or a 0-d tensor.  Every
    operation is elementwise, so an SPMD rank steps its blocks alone; with
    quantized moments the rank's ``policy`` keeps them in the whole leaf's
    blocks, as one process quantizes them
    (``ActivationPolicy.quantize_moments``: its int8 values, the whole
    leaf's block scales)."""
    step = state.step + 1
    s = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=s.device), s)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=s.device), s)

    # a process mesh's rank keeps its blocks' moments in the whole leaf's
    # blocks; a mesh description's program is the global one
    spmd_q = quantized and policy is not None and policy.live
    plans = policy.leaf_plans() if spmd_q else None
    if quantized and policy is not None and not policy.live:
        policy.note_moment_maxes(params, QBLOCK)

    def dq(qt, p, plan):
        if spmd_q:
            return policy.dequantize_moment(qt.q, qt.scale, plan, p.shape,
                                            QBLOCK)
        return _dq(qt, p.shape)

    def one(p, g, m, v, plan=None):
        g = g.float()
        if quantized:
            m_f = dq(m, p, plan)
            v_f = torch.square(dq(v, p, plan))     # v stored in sqrt-space
        else:
            m_f, v_f = m, v
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * torch.square(g)
        m_hat = m_new / c1
        v_hat = v_new / c2
        upd = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p.float()
        p_new = (p.float() - lr * upd).to(p.dtype)
        if not quantized:
            return p_new, m_new, v_new
        if spmd_q:              # quantized below, with every other leaf's
            return p_new, m_new, torch.sqrt(v_new)
        return p_new, _q(m_new), _q(torch.sqrt(v_new))

    out = tree_map(one, params, grads, state.m, state.v,
                   *([plans] if spmd_q else []))
    if spmd_q:
        # every leaf's moments quantized together: one packed MAX of the
        # block scales an axis
        flat, plan_list = leaves(out), leaves(plans)   # (p, m, sqrt v) each
        n = len(plan_list)
        qs = policy.quantize_moments(flat[1::3] + flat[2::3], plan_list * 2,
                                     QBLOCK)
        flat[1::3] = [QTensor(*x) for x in qs[:n]]
        flat[2::3] = [QTensor(*x) for x in qs[n:]]
        out = unflatten_like(out, flat)
    # ``out`` has a (p, m, v) triple at each leaf position of ``params``
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2))


# ---------------------------------------------------------------------------
# State specs (ZeRO: the moments mirror the param specs)
# ---------------------------------------------------------------------------


def opt_state_specs(p_specs, *, quantize: bool = False, params=None,
                    mesh=None):
    """Spec tree matching :func:`adamw_init`'s state, the reference's
    ``opt_state_specs``.  f32 moments mirror the param specs (ZeRO falls
    out of the FSDP specs).  Quantized moments are (n_blocks, QBLOCK) int8
    + (n_blocks, 1) scales, the block axis over "data" only where the
    leaf's block count divides it; that needs ``params`` (meta tensors
    will do) and ``mesh``."""
    from ..distributed.sharding import P

    if quantize:
        if params is None:
            raise ValueError("opt_state_specs(quantize=True) needs params=")
        data = (int(mesh.shape["data"])
                if mesh is not None and "data" in mesh.axis_names else 1)

        def qspec_for(p):
            nb = -(-(p.numel() if p.dim() else 1) // QBLOCK)
            ax = "data" if (data > 1 and nb % data == 0) else None
            return QTensor(q=P(ax, None), scale=P(ax, None))

        mspec = tree_map(qspec_for, params)
    else:
        mspec = p_specs
    return AdamWState(step=P(), m=mspec, v=mspec)


__all__ = ["AdamWState", "QBLOCK", "QTensor", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "opt_state_specs"]
