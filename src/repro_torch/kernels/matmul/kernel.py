"""Launcher of the hand-written CUDA tiled matmul kernel
(``repro_torch/csrc/matmul.cu``), the port of
``repro.kernels.matmul.kernel.matmul_kernel``.

This module builds nothing when imported: the library is built at the
first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(a, b, out_dtype) -> None:
    """Raise on what the kernel does not take."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"matmul kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"matmul kernel: {name} is not contiguous")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"matmul kernel: a/b dtypes {a.dtype}, {b.dtype}; "
                         f"both one of {DTYPES} expected")
    if out_dtype not in DTYPES:
        raise ValueError(f"matmul kernel: out_dtype {out_dtype}; one of "
                         f"{DTYPES} expected")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul kernel: shapes a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be (M, K) and (K, N)")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError("matmul kernel: an empty dimension")


def matmul_kernel(a, b, *, out_dtype=None):
    """a: (M, K) @ b: (K, N), both on the card → (M, N) in ``out_dtype``
    (default a's dtype), launched on the current stream without
    synchronising."""
    out_dtype = out_dtype or a.dtype
    check_inputs(a, b, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.repro_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            stream)
    check(status, "repro_matmul")
    return out
