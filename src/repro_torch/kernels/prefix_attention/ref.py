"""Plain PyTorch version of the prefix-context flash-attention kernel: the
materialised-concat oracle, line for line after
``repro.kernels.prefix_attention.ref.prefix_flash_attention_ref``, and an
emulation of the bf16 CUDA route's rounding
(:func:`prefix_flash_attention_mma_ref`), which only the tests use."""

from __future__ import annotations

import math

import torch

from ..common import NEG_INF


def prefix_flash_attention_ref(q, pk, pv, k, v, *, q_offset: int = 0):
    """q: (B, Sq, H, dh); pk/pv: (B, Lp, Hkv, dh); k/v: (B, Sk, Hkv, dh)
    → (B, Sq, H, dh).  Query row i sits at suffix-local position
    ``q_offset + i``; it attends to the whole prefix plus suffix cols
    ``<= q_offset + i``."""
    B, Sq, H, dh = q.shape
    Lp = pk.shape[1]
    Sk = k.shape[1]
    Hkv = k.shape[2]
    group = H // Hkv

    kc = torch.cat([pk.to(k.dtype), k], dim=1)
    vc = torch.cat([pv.to(v.dtype), v], dim=1)

    qg = q.reshape(B, Sq, Hkv, group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kc.float()) / math.sqrt(dh)
    rows = q_offset + torch.arange(Sq, device=q.device)
    cols = torch.arange(Lp + Sk, device=q.device) - Lp   # suffix-local; prefix < 0
    mask = cols[None, :] <= rows[:, None]
    s = torch.where(mask[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(vc.dtype).float(), vc.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def prefix_flash_attention_mma_ref(q, pk, pv, k, v, *, q_offset: int = 0,
                                   block_k: int = 64):
    """The bf16 CUDA route's arithmetic in plain torch, for the tests: f32
    scores, one online softmax over the prefix's k-tiles of ``block_k`` keys
    and then the suffix's (cols ``<= q_offset + row`` there), and p rounded
    to bf16 before P V (the row sum l adds the unrounded p).  Shapes as in
    :func:`prefix_flash_attention_ref`."""
    B, Sq, H, dh = q.shape
    Lp, Sk, Hkv = pk.shape[1], k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, dh).float()
    rows = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, group, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, group, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, dh), device=q.device)
    tiles = ([(pk, pv, Lp, k0, False) for k0 in range(0, Lp, block_k)]
             + [(k, v, Sk, k0, True) for k0 in range(0, Sk, block_k)])
    for kk, vv, S, k0, causal in tiles:
        ks = slice(k0, min(S, k0 + block_k))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kk[:, ks].float()) / math.sqrt(dh)
        if causal:
            cols = torch.arange(ks.start, ks.stop, device=q.device)
            s = torch.where(cols[None, :] <= rows[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1, keepdim=True)
        acc = acc * scale + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(torch.bfloat16).float(), vv[:, ks].float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, dh).to(q.dtype)
