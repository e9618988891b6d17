"""Plain PyTorch version of the flash-attention kernel (GQA + causal +
window), line for line after ``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common import NEG_INF


def flash_attention_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0,
):
    """q: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh).  Returns (B, H, Sq, dh).

    Materialized-scores reference in f32 — what the CUDA kernel is held
    against, and what a CPU tensor runs instead of the kernel.
    """
    B, H, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float())
    s = s / math.sqrt(dh)            # sqrt is exact-rounded: same f32 as jnp
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)

