"""Plain PyTorch version of the flash-attention kernel (GQA + causal +
window), line for line after ``repro.kernels.flash_attention.ref``, and an
emulation of the bf16 CUDA route's rounding (:func:`flash_attention_mma_ref`),
which only the tests use."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common import NEG_INF


def flash_attention_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0, return_lse: bool = False,
):
    """q: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh).  Returns (B, H, Sq, dh),
    and with ``return_lse`` also the (B, H, Sq) f32 log-sum-exp of the
    scaled, masked scores (a row with no valid key gives -1e30, as the
    reference's ``_flash_fwd_lse`` does).

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
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_mma_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0, block_k: int = 64,
):
    """The bf16 CUDA route's arithmetic in plain torch, for the tests: f32
    scores, an online softmax over k-tiles of ``block_k`` keys, and p
    rounded to bf16 before P V (the row sum l adds the unrounded p).
    q: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh).  Returns (B, H, Sq, dh)."""
    B, H, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    kx = torch.repeat_interleave(k, group, dim=1).float()
    vx = torch.repeat_interleave(v, group, dim=1).float()
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, dh), device=q.device)
    for k0 in range(0, Sk, block_k):
        ks = slice(k0, min(Sk, k0 + block_k))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx[:, :, ks]) / math.sqrt(dh)
        ki = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
        mask = torch.ones((Sq, ks.stop - ks.start), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= ki <= qi
        if window is not None:
            mask &= ki > qi - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1, keepdim=True)
        acc = acc * scale + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vx[:, :, ks])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
