"""Launcher of the hand-written CUDA prefill flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``), the port of
``repro.kernels.flash_attention.kernel.flash_attention_kernel``.

The kernel reads the model layout (B, S, H, dh) directly, so no transposes
are made around it, and it masks ragged Sq and Sk itself.  This module
builds nothing when imported: the library is built at the first launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, k, v) -> None:
    """Raise on what the kernel does not take: it needs CUDA tensors of one
    dtype (f32 or bf16), contiguous in the (B, S, H, dh) layout."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not contiguous")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in {DTYPES}")
    B, Sq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if H % k.shape[2] != 0:
        raise ValueError(f"flash_attention kernel: H={H} is not a multiple "
                         f"of Hkv={k.shape[2]}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: dh={dh} not in {HEAD_DIMS}")


def flash_attention_kernel(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0,
):
    """q: (B, Sq, H, dh); k, v: (B, Sk, Hkv, dh) on the card → (B, Sq, H, dh)
    in q's dtype, launched on the current stream without synchronising."""
    check_inputs(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, dh, int(causal), int(window is not None),
            int(window or 0), int(q_offset), int(q.dtype == torch.bfloat16),
            stream)
    check(status, "repro_flash_attention")
    return out
