"""Launcher of the hand-written CUDA paged decode-attention kernel
(``repro_torch/csrc/paged_decode_attention.cu``), the port of
``repro.kernels.paged_attention.kernel.paged_decode_attention_kernel``.

The kernel walks the page table itself: it reads ``page_table[b, j]`` and
loads only that page's rows for the block's kv head; the (B, max_pages *
page_size, Hkv, dh) gather is never made.  This module builds nothing when
imported: the library is built at the first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # q heads per kv head (the largest G bucket in the source)


def check_inputs(q, k_pool, v_pool, page_table, cur_pos) -> None:
    """Raise on what the kernel does not take."""
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("cur_pos", cur_pos)):
        if t.device.type != "cuda":
            raise ValueError(f"paged_decode_attention kernel: {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention kernel: {name} is not "
                             f"contiguous")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"paged_decode_attention kernel: q/k/v dtypes {q.dtype}, "
            f"{k_pool.dtype}, {v_pool.dtype}; one of {DTYPES} expected")
    if page_table.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise ValueError("paged_decode_attention kernel: page_table and "
                         "cur_pos must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_decode_attention kernel: q must be 3-D, the "
                         "pools 4-D and the page table 2-D")
    B, H, dh = q.shape
    P1, ps, Hkv, _ = k_pool.shape
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != dh or P1 < 2
            or page_table.shape[0] != B or page_table.shape[1] < 1
            or cur_pos.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention kernel: shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} page_table "
            f"{tuple(page_table.shape)} cur_pos {tuple(cur_pos.shape)} disagree")
    if H % Hkv != 0 or H // Hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention kernel: H={H}, Hkv={Hkv} "
                         f"needs a group H/Hkv <= {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel: dh={dh} not in "
                         f"{HEAD_DIMS}")


def paged_decode_attention_kernel(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, H, dh); k_pool/v_pool: (n_pages + 1, page_size, Hkv, dh);
    page_table: (B, max_pages) int32 (entries outside ``[0, n_pages)`` are
    unmapped and read the trash page); cur_pos: (B,) int32, all on the card
    → (B, H, dh) in q's dtype, launched on the current stream without
    synchronising."""
    check_inputs(q, k_pool, v_pool, page_table, cur_pos)
    B, H, dh = q.shape
    P1, ps, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
            B, H, Hkv, dh, P1 - 1, ps, page_table.shape[1],
            int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_paged_decode_attention")
    return out
