"""Plain PyTorch version of the decode-attention kernel (ring-buffer KV),
line for line after ``repro.kernels.decode_attention.ref``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common import NEG_INF


def decode_attention_ref(q, k, v, pos, cur_pos, *, window: Optional[int] = None):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C) absolute positions
    (-1 = empty slot); cur_pos: (B,).  Returns (B, H, dh)."""
    B, H, dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, dh).float() / math.sqrt(dh)
    s = torch.einsum("bgid,bkgd->bgik", qg, k.float())
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    if window is not None:
        valid &= pos > (cur_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgik,bkgd->bgid", w, v.float())
    return out.reshape(B, H, dh).to(q.dtype)
