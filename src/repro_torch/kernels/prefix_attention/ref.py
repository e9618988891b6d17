"""Plain PyTorch version of the prefix-context flash-attention kernel: the
materialised-concat oracle, line for line after
``repro.kernels.prefix_attention.ref.prefix_flash_attention_ref``."""

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
