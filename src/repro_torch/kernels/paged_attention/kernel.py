"""Launchers of the hand-written CUDA paged attention kernels: decode
(``repro_torch/csrc/paged_decode_attention.cu``) and the multi-query draft
verify (``repro_torch/csrc/paged_verify_attention.cu``), the ports of
``repro.kernels.paged_attention.kernel.paged_decode_attention_kernel`` and
``paged_verify_attention_kernel``.

Both kernels walk the page table themselves: they read ``page_table[b, j]``
and load only that page's rows for the block's kv head; the (B, max_pages *
page_size, Hkv, dh) gather is never made.  Both split the table's pages
across blocks (flash-decoding): a split pass writes unnormalised partials
to f32 scratch this wrapper allocates, and a merge pass combines them;
:func:`plan_page_splits` picks the split in plain Python.  This module
builds nothing when imported: the library is built at the first launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, load_library
from ..common import cdiv

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # q heads per kv head (the largest G bucket in the source)
MAX_VERIFY_ROWS = 32    # W * group, the largest row bucket of the verify kernel
MIN_BLOCKS = 2 * 132    # a split pass fills the H100's 132 SMs twice


def plan_page_splits(B: int, Hkv: int, max_pages: int) -> Tuple[int, int]:
    """``(n_split, pages_per_split)`` for a table of ``max_pages`` pages,
    the split of both paged kernels: contiguous runs of
    ``pages_per_split`` pages, cut down so the grid ``n_split * Hkv * B``
    reaches ``MIN_BLOCKS`` where the table has the pages, and ``n_split =
    ceil(max_pages / pages_per_split)`` so every split holds at least one
    page of the table.  On the paged and speculative paths (B=8, Hkv=8, 21
    pages) that is (6, 4): four pages of 16 are one staging round of the
    bf16 verify kernel's four warps and two 32-row tiles of the decode
    kernel."""
    want = min(max_pages, cdiv(MIN_BLOCKS, B * Hkv))
    pages_per_split = max_pages // want
    return cdiv(max_pages, pages_per_split), pages_per_split


def check_pool_inputs(kernel: str, q, k_pool, v_pool, page_table,
                      cur_pos) -> None:
    """Raise on a pool, table or positions the paged kernels do not take
    (the pools' rows are copied by 16-byte cp.async, so they must start on
    the 16-byte boundary).  ``q`` is (B, ..., H, dh); each launcher checks
    its own rank of q first.
    ``kernel`` names the caller in the messages."""
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("cur_pos", cur_pos)):
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"{kernel} kernel: q/k/v dtypes {q.dtype}, {k_pool.dtype}, "
            f"{v_pool.dtype}; one of {DTYPES} expected")
    if page_table.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise ValueError(f"{kernel} kernel: page_table and cur_pos must be "
                         f"int32")
    if k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"{kernel} kernel: the pools must be 4-D and the "
                         f"page table 2-D")
    B, H, dh = q.shape[0], q.shape[-2], q.shape[-1]
    P1, ps, Hkv, _ = k_pool.shape
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != dh or P1 < 2
            or page_table.shape[0] != B or page_table.shape[1] < 1
            or cur_pos.shape != (B,)):
        raise ValueError(
            f"{kernel} kernel: shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} page_table "
            f"{tuple(page_table.shape)} cur_pos {tuple(cur_pos.shape)} disagree")
    if H % Hkv != 0 or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel} kernel: H={H}, Hkv={Hkv} needs a group "
                         f"H/Hkv <= {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: dh={dh} not in {HEAD_DIMS}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} is not 16-byte "
                             f"aligned for its cp.async copies")


def paged_decode_attention_kernel(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, H, dh); k_pool/v_pool: (n_pages + 1, page_size, Hkv, dh);
    page_table: (B, max_pages) int32 (entries outside ``[0, n_pages)`` are
    unmapped and read the trash page); cur_pos: (B,) int32, all on the card
    → (B, H, dh) in q's dtype, launched on the current stream without
    synchronising.  Two kernels run (the split pass, then the merge); it
    is one call."""
    if q.dim() != 3:
        raise ValueError("paged_decode_attention kernel: q must be (B, H, dh)")
    check_pool_inputs("paged_decode_attention", q, k_pool, v_pool,
                      page_table, cur_pos)
    B, H, dh = q.shape
    P1, ps, Hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    n_split, pages_per_split = plan_page_splits(B, Hkv, max_pages)
    out = torch.empty_like(q)
    # one scratch allocation: acc (B, H, n_split, dh), then (m, l)
    n_acc = B * H * n_split * dh
    scratch = torch.empty(n_acc + B * H * n_split * 2, dtype=torch.float32,
                          device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), cur_pos.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * n_acc, out.data_ptr(), B, H, Hkv, dh,
            P1 - 1, ps, max_pages, n_split, pages_per_split,
            int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_paged_decode_attention")
    return out


def paged_verify_attention_kernel(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, W, H, dh), the model layout (query ``w`` at position
    ``cur_pos + w``); pools, table and cur_pos as in
    :func:`paged_decode_attention_kernel`, all on the card → (B, W, H, dh)
    in q's dtype, launched on the current stream without synchronising.
    The window-major row order of the reference (``row = w * group + h``)
    is the kernel's indexing of q and out; nothing is transposed.  Two
    kernels run (the split pass, then the merge); it is one call."""
    if q.dim() != 4:
        raise ValueError("paged_verify_attention kernel: q must be "
                         "(B, W, H, dh)")
    check_pool_inputs("paged_verify_attention", q, k_pool, v_pool,
                      page_table, cur_pos)
    B, W, H, dh = q.shape
    P1, ps, Hkv, _ = k_pool.shape
    rows = W * (H // Hkv)
    if rows > MAX_VERIFY_ROWS:
        raise ValueError(
            f"paged_verify_attention kernel: W * group = {W} * {H // Hkv} "
            f"query rows per kv head; at most {MAX_VERIFY_ROWS}")
    if q.data_ptr() % 16:
        raise ValueError("paged_verify_attention kernel: q is not 16-byte "
                         "aligned for its cp.async copies")
    max_pages = page_table.shape[1]
    n_split, pages_per_split = plan_page_splits(B, Hkv, max_pages)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, Hkv, rows, n_split, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hkv, rows, n_split, 2), dtype=torch.float32,
                          device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_paged_verify_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), cur_pos.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), B, W, H, Hkv, dh, P1 - 1, ps,
            max_pages, n_split, pages_per_split,
            int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_paged_verify_attention")
    return out
