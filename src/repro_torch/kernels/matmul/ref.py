"""Plain PyTorch version of the matmul kernel, line for line after
``repro.kernels.matmul.ref``."""

from __future__ import annotations


def matmul_ref(a, b, *, out_dtype=None):
    """a: (M, K); b: (K, N) — f32 accumulation, ``out_dtype`` (default
    a's dtype) out."""
    out = a.float() @ b.float()
    return out.to(out_dtype or a.dtype)
