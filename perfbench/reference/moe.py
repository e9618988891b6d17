"""Plain reference of DeepSeekMoE's expert layer (arXiv:2401.06066), in
float32: a softmax router over the routed experts, the top-k of them per
token, SwiGLU experts, and shared experts that every token passes through.
The attention half is :mod:`perfbench.reference.common`'s.

Departures from the published model, each as the program serves it and as
the configuration file lists them:

* every layer is an expert layer (the published model keeps layer 0 dense,
  ``first_k_dense_replace`` 1);
* the top-k probabilities are divided by their sum (the published
  ``norm_topk_prob`` is false);
* at admission each padded prompt row routes with a capacity of
  ``int(prompt_len * k / E * capacity_factor)`` assignments per expert,
  counted in token order, padding included; later assignments to a full
  expert add nothing.  Decoded tokens are never dropped.
"""

from __future__ import annotations

import torch

from .common import swiglu


def _capacity_keep(top_i: torch.Tensor, n_experts: int,
                   capacity: int) -> torch.Tensor:
    """(T, k) bool: whether each (token, choice) assignment is among the
    first ``capacity`` to its expert, in token order."""
    flat = top_i.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    return (rank < capacity).view(top_i.shape)


def ffn(lw, h, rows, conf, lin):
    moe = lw["moe"]
    n_exp = conf["n_routed_experts"]
    k = conf["num_experts_per_tok"]
    cf = conf["prefill_capacity_factor"]
    probs = torch.softmax(lin(h, moe["router"]), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    if conf.get("norm_topk_prob"):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = torch.ones_like(top_i, dtype=torch.bool)
    start = 0
    for r in rows:
        p = r["prompt_len"]
        cap = min(max(1, int(p * k / n_exp * cf)), p * k)
        keep[start:start + p] = _capacity_keep(top_i[start:start + p], n_exp,
                                               cap)
        start += r["tokens"].shape[0]
    w = torch.where(keep, top_p, 0.0)
    out = torch.zeros_like(h)
    for e in range(n_exp):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], moe["wi"][e], moe["wo"][e], lin)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    if conf.get("n_shared_experts"):
        out = out + swiglu(h, moe["shared"]["wi"], moe["shared"]["wo"], lin)
    return out
