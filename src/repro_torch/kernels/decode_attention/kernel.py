"""Launcher of the hand-written CUDA dense decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``), the port of
``repro.kernels.decode_attention.kernel.decode_attention_kernel``.

The kernel reads the model layout (q (B, H, dh), k/v (B, C, Hkv, dh))
directly.  This module builds nothing when imported: the library is built
at the first launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # q heads per kv head (MAX_GROUP in the source)


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


def decode_attention_kernel(q, k, v, pos, cur_pos, *,
                            window: Optional[int] = None):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C) int32; cur_pos: (B,)
    int32, all on the card → (B, H, dh) in q's dtype, launched on the current
    stream without synchronising."""
    check_inputs(q, k, v, pos, cur_pos)
    B, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            cur_pos.data_ptr(), out.data_ptr(), B, C, H, Hkv, dh,
            int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_decode_attention")
    return out
