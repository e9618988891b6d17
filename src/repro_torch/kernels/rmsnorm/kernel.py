"""Launcher of the hand-written CUDA RMSNorm kernel
(``repro_torch/csrc/rmsnorm.cu``), the port of
``repro.kernels.rmsnorm.kernel.rmsnorm_kernel``.

This module builds nothing when imported: the library is built at the
first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 12288           # widest row the reference takes (MAX_D in the source)


def check_inputs(x2d, scale) -> None:
    """Raise on what the kernel does not take."""
    for name, t in (("x", x2d), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"rmsnorm kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm kernel: {name} is not contiguous")
        if t.dtype not in DTYPES:
            raise ValueError(f"rmsnorm kernel: {name} dtype {t.dtype}; one "
                             f"of {DTYPES} expected")
    if x2d.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x2d.shape[1]:
        raise ValueError(f"rmsnorm kernel: x {tuple(x2d.shape)} must be "
                         f"(T, d) and scale {tuple(scale.shape)} (d,)")
    T, d = x2d.shape
    if T < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel: T={T}, d={d}; needs T >= 1 and "
                         f"1 <= d <= {MAX_D}")


def rmsnorm_kernel(x2d, scale, *, eps: float = 1e-6):
    """x2d: (T, d); scale: (d,), both on the card → (T, d) in x2d's dtype,
    launched on the current stream without synchronising."""
    check_inputs(x2d, scale)
    T, d = x2d.shape
    out = torch.empty_like(x2d)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        status = lib.repro_rmsnorm(
            x2d.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d,
            float(eps), int(x2d.dtype == torch.bfloat16),
            int(scale.dtype == torch.bfloat16), stream)
    check(status, "repro_rmsnorm")
    return out
