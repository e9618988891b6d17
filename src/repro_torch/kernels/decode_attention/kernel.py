"""Launcher of the hand-written CUDA dense decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``), the port of
``repro.kernels.decode_attention.kernel.decode_attention_kernel``.

The kernel reads the model layout (q (B, H, dh), k/v (B, C, Hkv, dh))
directly.  It splits the cache axis across blocks (flash-decoding): the
split pass writes unnormalised partials to f32 scratch this wrapper
allocates, and a merge pass combines them; :func:`plan_splits` picks the
split in plain Python.  With ``return_stats=True`` the merge pass also
writes each (row, q head)'s running max ``m`` and denominator ``l``
(f32), with which a cache whose length is sharded over several ranks
merges their outputs.  This module builds nothing when imported: the
library is built at the first launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._build import check, load_library
from ..common import cdiv

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # q heads per kv head (MAX_GROUP in the source)
SPLIT_TILE = 32         # cache slots per tile (BC in the source)
MIN_BLOCKS = 2 * 132    # the split pass's grid fills the H100's 132 SMs twice


def plan_splits(B: int, C: int, Hkv: int) -> Tuple[int, int]:
    """``(n_split, split_len)`` for a cache of ``C`` slots: ``split_len`` a
    multiple of ``SPLIT_TILE``, cut down so the grid ``n_split * Hkv * B``
    reaches ``MIN_BLOCKS`` where ``C`` allows, and ``n_split = ceil(C /
    split_len)`` so every split holds at least one real slot."""
    want = cdiv(MIN_BLOCKS, B * Hkv)
    split_len = max(SPLIT_TILE, cdiv(C, want) // SPLIT_TILE * SPLIT_TILE)
    return cdiv(C, split_len), split_len


def check_inputs(q, k, v, pos, cur_pos) -> None:
    """Raise on what the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos),
                    ("cur_pos", cur_pos)):
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} is not contiguous")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention kernel: q/k/v dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; one of {DTYPES} expected")
    if pos.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise ValueError("decode_attention kernel: pos and cur_pos must be int32")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("decode_attention kernel: q must be 3-D, k/v 4-D")
    B, H, dh = q.shape
    _, C, Hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh
            or pos.shape != (B, C) or cur_pos.shape != (B,)):
        raise ValueError(
            f"decode_attention kernel: shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} pos {tuple(pos.shape)} "
            f"cur_pos {tuple(cur_pos.shape)} disagree")
    if H % Hkv != 0 or H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention kernel: H={H}, Hkv={Hkv} needs "
                         f"a group H/Hkv <= {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: dh={dh} not in {HEAD_DIMS}")
    for name, t, align in (("k", k, 16), ("v", v, 16), ("pos", pos, 4)):
        if t.data_ptr() % align:
            raise ValueError(f"decode_attention kernel: {name} is not aligned "
                             f"for its cp.async copies")


def decode_attention_kernel(q, k, v, pos, cur_pos, *,
                            window: Optional[int] = None,
                            return_stats: bool = False):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C) int32; cur_pos: (B,)
    int32, all on the card → (B, H, dh) in q's dtype, launched on the current
    stream without synchronising.  With ``return_stats`` → (out, m, l), m
    and l f32 (B, H)."""
    check_inputs(q, k, v, pos, cur_pos)
    B, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    n_split, split_len = plan_splits(B, C, Hkv)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, n_split, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    ml = (torch.empty((B, H, 2), dtype=torch.float32, device=q.device)
          if return_stats else None)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            cur_pos.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), None if ml is None else ml.data_ptr(), B, C, H,
            Hkv, dh, n_split, split_len, int(window is not None),
            int(window or 0), int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_decode_attention")
    if ml is None:
        return out
    return out, ml[..., 0], ml[..., 1]
