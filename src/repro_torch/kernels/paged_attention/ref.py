"""Plain PyTorch versions of the paged decode- and verify-attention
kernels: the materialised-gather oracles, line for line after
``repro.kernels.paged_attention.ref.paged_decode_attention_ref`` and
``paged_verify_attention_ref``."""

from __future__ import annotations

import math

import torch

from ..common import NEG_INF


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, H, dh); k_pool/v_pool: (n_pages + 1, page_size, Hkv, dh) with
    the trash page at index ``n_pages``; page_table: (B, max_pages) int32,
    -1 = unmapped; cur_pos: (B,) int32.  Returns (B, H, dh).

    Gathers the slot's pages into a flat (B, max_pages*page_size, Hkv, dh)
    view (unmapped pages read the trash page), masks to mapped pages and
    positions <= cur_pos, and takes a masked softmax.  An entry outside
    ``[0, n_pages)`` counts as unmapped (an index past the pool never
    reaches the gather)."""
    B, H, dh = q.shape
    n_pages = k_pool.shape[0] - 1
    ps = k_pool.shape[1]
    Hkv = k_pool.shape[2]
    group = H // Hkv
    maxp = page_table.shape[1]
    L = maxp * ps

    mapped = (page_table >= 0) & (page_table < n_pages)
    gather = torch.where(mapped, page_table, n_pages).long()
    kg = k_pool[gather].reshape(B, L, Hkv, dh)
    vg = v_pool[gather].reshape(B, L, Hkv, dh)
    pos = torch.arange(L, device=q.device)
    valid = mapped[:, pos // ps] & (pos[None, :] <= cur_pos[:, None])

    qg = (q.reshape(B, Hkv, group, dh).float() / math.sqrt(dh)).to(q.dtype)
    s = torch.einsum("bgid,bkgd->bgik", qg.float(), kg.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgik,bkgd->bgid", w.to(vg.dtype).float(), vg.float())
    return out.reshape(B, H, dh).to(q.dtype)


def paged_verify_attention_ref(q, k_pool, v_pool, page_table, cur_pos):
    """Multi-query twin of :func:`paged_decode_attention_ref`: q (B, W, H,
    dh), query ``w`` at absolute position ``cur_pos + w`` attending mapped
    keys at positions ``<= cur_pos + w``.  Returns (B, W, H, dh).

    A row with no valid key averages V over all ``max_pages * page_size``
    gathered rows, trash page included; an entry outside ``[0, n_pages)``
    counts as unmapped."""
    B, W, H, dh = q.shape
    n_pages = k_pool.shape[0] - 1
    ps = k_pool.shape[1]
    Hkv = k_pool.shape[2]
    group = H // Hkv
    maxp = page_table.shape[1]
    L = maxp * ps

    mapped = (page_table >= 0) & (page_table < n_pages)
    gather = torch.where(mapped, page_table, n_pages).long()
    kg = k_pool[gather].reshape(B, L, Hkv, dh)
    vg = v_pool[gather].reshape(B, L, Hkv, dh)
    pos = torch.arange(L, device=q.device)
    q_pos = cur_pos[:, None] + torch.arange(W, device=q.device)[None, :]
    valid = (mapped[:, pos // ps][:, None, :]
             & (pos[None, None, :] <= q_pos[:, :, None]))          # (B, W, L)

    qg = (q.reshape(B, W, Hkv, group, dh).float() / math.sqrt(dh)).to(q.dtype)
    s = torch.einsum("bwgid,bkgd->bwgik", qg.float(), kg.float())
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bwgik,bkgd->bwgid", w.to(vg.dtype).float(), vg.float())
    return out.reshape(B, W, H, dh).to(q.dtype)
