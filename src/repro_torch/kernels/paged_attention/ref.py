"""Plain PyTorch versions of the paged decode- and verify-attention
kernels: the materialised-gather oracles, line for line after
``repro.kernels.paged_attention.ref.paged_decode_attention_ref`` and
``paged_verify_attention_ref``, and the CUDA kernels' split-and-merge
arithmetic (:func:`paged_decode_attention_split_ref`,
:func:`paged_verify_attention_split_ref`), which only the tests use."""

from __future__ import annotations

import math

import torch

from ..common import NEG_INF, cdiv


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


def _split_merge(s, vg, ps, n_split, pages_per_split, *, round_p=False):
    """Per split of ``pages_per_split`` pages of the gathered keys (the
    last axis of the scores ``s``, ``ps`` keys a page): the unnormalised
    ``(m, l, acc)`` of its keys (``m = -inf``, ``l = 0``, ``acc = 0`` where
    every score is -inf), then the merge ``sum_s e^(m_s - m*) acc_s /
    max(sum_s e^(m_s - m*) l_s, 1e-30)``, a split with ``m_s = -inf``
    weighing 0.  ``round_p`` rounds p to bf16 before it weighs V (l adds
    the unrounded p).  ``s``: (B, [W,] Hkv, group, L); ``vg``: (B, L, Hkv,
    dh) f32."""
    ms, ls, accs = [], [], []
    for i in range(n_split):
        ks = slice(i * pages_per_split * ps, (i + 1) * pages_per_split * ps)
        s_i = s[..., ks]
        m_i = s_i.amax(dim=-1, keepdim=True)
        p_i = torch.exp(s_i - torch.where(m_i == float("-inf"), 0.0, m_i))
        p_v = p_i.to(torch.bfloat16).float() if round_p else p_i
        ms.append(m_i)
        ls.append(p_i.sum(dim=-1, keepdim=True))
        sub = "bwgik" if s.dim() == 5 else "bgik"
        accs.append(torch.einsum(f"{sub},bkgd->{sub[:-1]}d", p_v, vg[:, ks]))
    m = torch.stack(ms)
    m_star = m.amax(dim=0)
    w = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_star))
    return ((w * torch.stack(accs)).sum(0)
            / (w * torch.stack(ls)).sum(0).clamp_min(1e-30))


def paged_decode_attention_split_ref(q, k_pool, v_pool, page_table, cur_pos,
                                     *, n_split: int, pages_per_split: int):
    """The CUDA decode kernel's two passes in plain torch, for the tests.

    Scores over the gathered pages as in :func:`paged_decode_attention_ref`
    (masked keys at NEG_INF).  When the slot attends to some position
    (``has_valid``: a mapped page ``j`` with ``j * page_size <= cur_pos``),
    only its valid keys take part: the kernel neither loads nor scores the
    others (their weight is exactly 0 in the one-pass softmax).  Otherwise
    every key takes part at NEG_INF, the trash page included.  Then
    ``n_split`` splits of ``pages_per_split`` table entries and the merge
    (:func:`_split_merge`).  Returns (B, H, dh) in q's dtype."""
    B, H, dh = q.shape
    n_pages = k_pool.shape[0] - 1
    ps = k_pool.shape[1]
    Hkv = k_pool.shape[2]
    group = H // Hkv
    maxp = page_table.shape[1]
    L = maxp * ps

    mapped = (page_table >= 0) & (page_table < n_pages)
    gather = torch.where(mapped, page_table, n_pages).long()
    kg = k_pool[gather].reshape(B, L, Hkv, dh).float()
    vg = v_pool[gather].reshape(B, L, Hkv, dh).float()
    pos = torch.arange(L, device=q.device)
    cur = cur_pos.long()
    valid = mapped[:, pos // ps] & (pos[None, :] <= cur[:, None])   # (B, L)
    qg = q.reshape(B, Hkv, group, dh).float()
    s = torch.einsum("bgid,bkgd->bgik", qg, kg) / math.sqrt(dh)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)

    first = torch.arange(maxp, device=q.device)[None, :] * ps      # (1, maxp)
    has_valid = (mapped & (first <= cur[:, None])).any(dim=1)      # (B,)
    kept = ~has_valid[:, None] | valid
    s = torch.where(kept[:, None, None, :], s, float("-inf"))
    out = _split_merge(s, vg, ps, n_split, pages_per_split)
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


def paged_verify_attention_split_ref(q, k_pool, v_pool, page_table, cur_pos,
                                     *, pages_per_split: int,
                                     round_p: bool = False):
    """The CUDA verify kernel's two passes in plain torch, for the tests.

    Scores over the gathered pages as in :func:`paged_verify_attention_ref`
    (masked keys at NEG_INF).  When row 0 has a valid key, the pages that
    no row of the window attends take no part (the kernel skips them);
    otherwise every page takes part.  Then splits of ``pages_per_split``
    pages and the merge (:func:`_split_merge`).  ``round_p`` rounds p to
    bf16 before P V, as the bf16 route does (relative to the split's max,
    where the kernel's warps use their running max over 16-key tiles).
    Returns (B, W, H, dh) in q's dtype."""
    B, W, H, dh = q.shape
    n_pages = k_pool.shape[0] - 1
    ps = k_pool.shape[1]
    Hkv = k_pool.shape[2]
    group = H // Hkv
    maxp = page_table.shape[1]
    L = maxp * ps

    mapped = (page_table >= 0) & (page_table < n_pages)
    gather = torch.where(mapped, page_table, n_pages).long()
    kg = k_pool[gather].reshape(B, L, Hkv, dh).float()
    vg = v_pool[gather].reshape(B, L, Hkv, dh).float()
    pos = torch.arange(L, device=q.device)
    cur = cur_pos.long()
    q_pos = cur[:, None] + torch.arange(W, device=q.device)[None, :]
    valid = (mapped[:, pos // ps][:, None, :]
             & (pos[None, None, :] <= q_pos[:, :, None]))          # (B, W, L)
    qg = q.reshape(B, W, Hkv, group, dh).float()
    s = torch.einsum("bwgid,bkgd->bwgik", qg, kg) / math.sqrt(dh)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)

    first = torch.arange(maxp, device=q.device)[None, :] * ps      # (1, maxp)
    has_valid = (mapped & (first <= cur[:, None])).any(dim=1)      # (B,)
    kept = ~has_valid[:, None] | (mapped & (first <= (cur + W - 1)[:, None]))
    s = torch.where(kept[:, pos // ps][:, None, None, None, :], s,
                    float("-inf"))

    out = _split_merge(s, vg, ps, cdiv(maxp, pages_per_split),
                       pages_per_split, round_p=round_p)
    return out.reshape(B, W, H, dh).to(q.dtype)
