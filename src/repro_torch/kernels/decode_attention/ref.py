"""Plain PyTorch version of the decode-attention kernel (ring-buffer KV),
line for line after ``repro.kernels.decode_attention.ref``, and the CUDA
kernel's split-and-merge arithmetic (:func:`decode_attention_split_ref`),
which only the tests use."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..common import NEG_INF


def decode_attention_ref(q, k, v, pos, cur_pos, *, window: Optional[int] = None,
                         return_stats: bool = False):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C) absolute positions
    (-1 = empty slot); cur_pos: (B,).  Returns (B, H, dh); with
    ``return_stats``, (out, m, l): the row's max scaled score ``m``
    (NEG_INF where no slot is valid) and ``l = sum exp(s - m)`` over its C
    slots, f32 (B, H), as the kernel's merge pass writes them."""
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
    out = out.reshape(B, H, dh).to(q.dtype)
    if not return_stats:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return out, m.reshape(B, H), l.reshape(B, H)


def decode_attention_merge_ref(outs, ms, ls):
    """The merge of a cache's length shards, in one process: each shard's
    normalised output (B, H, dh) and its ``(m, l)`` (``return_stats``)
    combine as ``sum_r e^(m_r - m*) l_r out_r / sum_r e^(m_r - m*) l_r``
    with ``m* = max_r m_r``, in f32, cast to the outputs' dtype.  A shard
    with no valid slot weighs ``e^(-1e30 - m*) = 0``; a row with no valid
    slot anywhere has ``m_r = -1e30`` on every shard, so it gets the mean
    of V over every shard's slots, as over the whole cache."""
    m = torch.stack([x.float() for x in ms])                  # (R, B, H)
    w = torch.exp(m - m.amax(dim=0)) * torch.stack([x.float() for x in ls])
    num = (w[..., None] * torch.stack([o.float() for o in outs])).sum(0)
    return (num / w.sum(0)[..., None]).to(outs[0].dtype)


def decode_attention_split_ref(q, k, v, pos, cur_pos, *, split_len: int,
                               window: Optional[int] = None):
    """The CUDA kernel's two passes in plain torch, for the tests: per split
    of ``split_len`` slots the unnormalised ``(m, l, acc)`` of its slots
    (masked slots score NEG_INF and take part, as in the kernel), then the
    merge ``sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30)``.
    Equal to :func:`decode_attention_ref` in every case, a row with no valid
    slot included (both average V over the C slots)."""
    B, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, dh).float()
    s = torch.einsum("bgid,bkgd->bgik", qg, k.float()) / math.sqrt(dh)
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    if window is not None:
        valid &= pos > (cur_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    ms, ls, accs = [], [], []
    for c0 in range(0, C, split_len):
        s_i = s[..., c0:c0 + split_len]
        m_i = s_i.amax(dim=-1, keepdim=True)
        p_i = torch.exp(s_i - m_i)
        ms.append(m_i)
        ls.append(p_i.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bgik,bkgd->bgid", p_i,
                                 v[:, c0:c0 + split_len].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(dim=0))
    out = (w * torch.stack(accs)).sum(0) / (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    return out.reshape(B, H, dh).to(q.dtype)
