"""Mixture-of-Experts: top-k router, capacity-bounded sort dispatch, and
the dense decode path.

Counterpart of ``repro.models.moe``, with the same two compute paths,
picked by :func:`moe_apply` from the token count:

* **grouped dispatch** (prefill): per batch row, the (token, expert)
  assignments are sorted by expert id with a stable sort, each gets its
  position within its expert, and the first ``capacity`` of each expert
  are copied into a capacity buffer; the overflow is dropped.  The buffer
  is laid out expert-major, ``(E, B * capacity, d)``, so the expert
  products are one batched matmul over the expert axis against ``wi``
  ``(E, d, 2f)`` and ``wo`` ``(E, f, d)`` as stored: no copy of an expert
  weight per call.
* **dense decode** (few tokens): every expert for every token, weighted
  by the router's top-k probabilities (zero elsewhere).  Decode reads
  every expert weight anyway once a batch activates most experts.

The combine step differs from the reference's scatter-add in form only:
each token gathers its ``top_k`` contributions through the inverse of the
dispatch sort and adds them in ascending expert order, the order in which
the reference's scatter visits them, in the output dtype as the reference
adds them.  A scatter-add of bf16 rows on the card would use atomics, whose
order, and so whose rounding, changes from run to run.

While a ``torch.profiler`` session records, the routing and dispatch ops
run inside a ``moe.dispatch`` range and the expert products inside
``moe.expert_products`` (``chip_smoke.py`` phase 6 splits the MoE's device
time by them); otherwise no range is opened.

Shared experts (DeepSeek-MoE) are one always-on MLP of width
``n_shared * shared_d_ff``, as in the reference.  Under an SPMD
``policy`` (``distributed.spmd.make_policy``) the params are one rank's
blocks and the output is the rank's partial sum, which the caller sums
over "model" at ``"mlp_out"``: expert-parallel (the reference's
``"moe_ecap"`` case), each rank holds ``E / model`` experts
(``policy.expert_block``); every rank routes the same tokens into all
``E`` buckets with the global capacity, computes only its own buckets
(an empty one too, so every rank runs the same products) and combines
only their outputs; expert-TP, each expert's ``[gate | up]`` columns and
``wo`` rows are split over "model" and the code is the single process's.
Tensor-parallel serving refuses MoE archs, as the reference's
``check_tp`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import torch_dtype
from ..obs import profiled
from .layers import init_dense, init_mlp, mlp


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg, *, device=None):
    """cfg: ModelConfig with cfg.moe set.  The router stays f32."""
    m = cfg.moe
    d, dff, E = cfg.d_model, m.expert_d_ff, m.n_experts
    device = device or gen.device
    dt = torch_dtype(cfg.dtype)

    def experts(shape, fan_in):
        # scaled in place: one f32 temporary of the stacked experts, not two
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(1.0 / np.sqrt(fan_in)).to(dt)

    p = {"router": init_dense(gen, d, E, "float32", device=device)["w"],
         "wi": experts((E, d, 2 * dff), d),
         "wo": experts((E, dff, d), dff)}
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, d, m.n_shared_experts
                               * (m.shared_d_ff or dff), cfg.dtype,
                               device=device)
    return p


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def router_probs(params, x, cfg):
    """(T, d) -> (top-k probs (T, k) renormalised, expert ids (T, k), full
    probs (T, E)), all from f32 router logits."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_p, top_i, probs


def load_balance_loss(probs, top_i, n_experts: int, *,
                      batch_sum=None) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (1.0 = perfectly
    balanced).  ``batch_sum`` (an SPMD policy's ``batch_sum`` where the
    batch is split over data groups) turns this rank's expert counts,
    probability sums and row count into the whole batch's, as the
    reference's one program reads them."""
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, top_i.reshape(-1),
                      torch.ones((top_i.numel(),), dtype=torch.float32,
                                 device=probs.device))
    if batch_sum is None:
        mean = probs.mean(dim=0)
    else:
        rows = probs.new_full((1,), float(probs.shape[0]))
        both = batch_sum(torch.cat([counts, probs.sum(dim=0), rows]))
        counts = both[:n_experts]
        mean = both[n_experts:2 * n_experts] / both[-1]
    f = counts / counts.sum().clamp(min=1.0)
    return n_experts * torch.sum(f * mean)


def _enter(policy, x, name: str):
    """The SPMD policy's entry hook ``name`` (the identity without one)."""
    return policy(x, name) if policy is not None else x


def _aux_sum(policy, probs):
    """The policy's sum over the data groups of the aux loss's statistics,
    where the batch is split over them and the aux takes a gradient (it is
    discarded when serving)."""
    if (policy is None or not getattr(policy, "batch_axes", None)
            or not probs.requires_grad):
        return None
    return lambda x: policy.batch_sum(x, "aux")


def _expert_ffn(h, wi, wo):
    """SwiGLU experts as batched matmuls over the expert axis: h (E, T, d)
    -> (E, T, d), reading ``wi`` (E, d, 2f) and ``wo`` (E, f, d) in
    place.  A broadcast batch of size 1 is expanded with stride 0, which
    the batched product reads without a copy."""
    with profiled("moe.expert_products"):
        g = torch.matmul(h, wi)
        gate, up = torch.chunk(g, 2, dim=-1)
        return torch.matmul(F.silu(gate) * up, wo)


# ---------------------------------------------------------------------------
# Grouped (sort-based) dispatch: prefill
# ---------------------------------------------------------------------------


def _route(x, top_p, top_i, E: int, capacity: int):
    """Every batch row's dispatch at once.  x: (B, T, d); top_p/top_i:
    (B, T, k).

    Returns (buf (E, B * capacity, d), slot (B, T*k), w_sorted (B, T*k),
    keep (B, T*k), inv (B, T*k)): ``slot`` is each sorted assignment's row
    of ``buf`` (``E * B * capacity``, the sink, when dropped) and ``inv``
    the sorted index of each assignment in (token, k) order."""
    B, T, d = x.shape
    k = top_i.shape[-1]
    Tk = T * k
    dev = x.device
    expert = top_i.reshape(B, Tk)
    order = torch.argsort(expert, dim=1, stable=True)   # group by expert
    e_sorted = torch.gather(expert, 1, order)
    t_sorted = order // k                               # token = a // k
    w_sorted = torch.gather(top_p.reshape(B, Tk), 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, expert, torch.ones_like(expert))
    starts = torch.cumsum(counts, dim=1) - counts       # first sorted index
    pos = (torch.arange(Tk, device=dev)[None, :]
           - torch.gather(starts, 1, e_sorted))         # position in expert
    keep = pos < capacity                               # overflow dropped
    b = torch.arange(B, device=dev)[:, None]
    sink = E * B * capacity
    slot = torch.where(keep, (e_sorted * B + b) * capacity + pos, sink)
    buf = x.new_zeros((sink + 1, d))
    buf[slot.reshape(-1)] = x[b, t_sorted].reshape(B * Tk, d)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(Tk, device=dev).expand(B, Tk))
    return buf[:-1].reshape(E, B * capacity, d), slot, w_sorted, keep, inv


def _combine(y, slot, w_sorted, keep, inv, T: int, k: int, first: int = 0):
    """y: (E, B * capacity, d) expert outputs -> (B, T, d).  Token t's k
    contributions are gathered through ``inv`` and added in ascending
    expert order (ascending sorted index), in ``y.dtype``; a dropped
    assignment adds zero.  ``y`` may hold only the buffer rows from
    ``first`` on (an expert-parallel rank's experts): an assignment to
    any other row adds zero too."""
    B = slot.shape[0]
    d = y.shape[-1]
    rows = y.shape[0] * y.shape[1]
    local = slot - first
    keep = keep & (local >= 0) & (local < rows)
    y_flat = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))], dim=0)
    contrib = (y_flat[torch.where(keep, local, rows).reshape(-1)]
               .reshape(B, T * k, d) * w_sorted[..., None].to(y.dtype))
    contrib = torch.where(keep[..., None], contrib, 0)
    idx = torch.sort(inv.reshape(B, T, k), dim=-1).values.reshape(B, T * k)
    parts = torch.gather(contrib, 1, idx[..., None].expand(B, T * k, d))
    parts = parts.reshape(B, T, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


def moe_grouped(params, x, cfg, *, capacity: Optional[int] = None,
                experts: Optional[Tuple[int, int]] = None, policy=None):
    """x: (B, S, d) -> (out (B, S, d), aux loss).  Capacity per expert and
    batch row, ``max(1, int(S * k / E * capacity_factor))`` capped at
    ``S * k``, computed on the host as the reference does.  ``experts=(lo,
    hi)``: ``params`` hold experts lo .. hi - 1 only (an expert-parallel
    rank); the tokens are routed into all E buckets, only these are
    computed and combined, and ``out`` is this rank's partial sum.  Under
    an SPMD ``policy`` the router reads ``x`` whole, while the dispatched
    tokens and the combine weights enter the split experts through the
    entry hooks ``"mlp_in"`` and ``"moe_weights"``, and the aux loss is the
    whole batch's."""
    m = cfg.moe
    B, S, d = x.shape
    if capacity is None:
        capacity = max(1, int(S * m.top_k / m.n_experts * m.capacity_factor))
        capacity = min(capacity, S * m.top_k)
    with profiled("moe.dispatch"):
        top_p, top_i, probs = router_probs(params, x.reshape(B * S, d), cfg)
        xs = _enter(policy, x, "mlp_in")
        top_p = _enter(policy, top_p, "moe_weights")
        buf, slot, w_sorted, keep, inv = _route(
            xs, top_p.reshape(B, S, m.top_k), top_i.reshape(B, S, m.top_k),
            m.n_experts, capacity)
    first = 0
    if experts is not None:
        buf = buf[experts[0]:experts[1]]
        first = experts[0] * buf.shape[1]
    y = _expert_ffn(buf, params["wi"], params["wo"])
    with profiled("moe.dispatch"):
        out = _combine(y, slot, w_sorted, keep, inv, S, m.top_k, first)
    if "shared" in params:
        out = out + mlp(params["shared"], xs)
    return out, load_balance_loss(probs, top_i, m.n_experts,
                                  batch_sum=_aux_sum(policy, probs))


# ---------------------------------------------------------------------------
# Dense decode path
# ---------------------------------------------------------------------------


def moe_dense_decode(params, x, cfg, *,
                     experts: Optional[Tuple[int, int]] = None, policy=None):
    """x: (B, S_small, d): every expert for every token, weighted by the
    router's top-k probabilities.  Returns (out, 0.0): no aux loss.
    ``experts=(lo, hi)`` weighs only those experts' columns (the params'
    experts on an expert-parallel rank): a partial sum."""
    m = cfg.moe
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    with profiled("moe.dispatch"):
        top_p, top_i, _ = router_probs(params, x2, cfg)
        top_p = _enter(policy, top_p, "moe_weights")
        w = torch.zeros((B * S, m.n_experts), dtype=torch.float32,
                        device=x.device).scatter_(1, top_i, top_p)
        if experts is not None:
            w = w[:, experts[0]:experts[1]]
    x2 = _enter(policy, x2, "mlp_in")
    y = _expert_ffn(x2[None], params["wi"], params["wo"])      # (E, T, d)
    # out[t] = sum_e w[t, e] y[e, t]: a (1, E) @ (E, d) product per token
    out = torch.matmul(w.to(y.dtype)[:, None, :], y.transpose(0, 1))
    out = out.reshape(B, S, d)
    if "shared" in params:
        out = out + mlp(params["shared"], x2.view(B, S, d))
    return out, 0.0


def moe_apply(params, x, cfg, *, decode: bool = False, policy=None):
    """Grouped dispatch for prefill, dense for decode and for prompts of at
    most 4 tokens, as in the reference.  An expert-parallel ``policy``
    names this rank's experts (``expert_block``)."""
    experts = getattr(policy, "expert_block", None)
    if decode or x.shape[1] <= 4:
        return moe_dense_decode(params, x, cfg, experts=experts,
                                policy=policy)
    return moe_grouped(params, x, cfg, experts=experts, policy=policy)


__all__ = ["init_moe", "load_balance_loss", "moe_apply", "moe_dense_decode",
           "moe_grouped", "router_probs"]
