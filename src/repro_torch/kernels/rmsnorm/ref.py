"""Plain PyTorch version of the RMSNorm kernel, line for line after
``repro.kernels.rmsnorm.ref``."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  f32 accumulation, x's dtype out."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
