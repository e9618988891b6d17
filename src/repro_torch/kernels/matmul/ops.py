"""Public wrapper for the tiled matmul.

The leading dims of ``a`` are flattened into M and both operands made
contiguous, as ``repro.kernels.matmul.ops`` does.  The route follows the
tensor's device: a CPU tensor takes the plain version (:mod:`.ref`), a
CUDA tensor launches the kernel or raises.  There is no fallback between
the two.  ``matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

from .kernel import matmul_kernel
from .ref import matmul_ref


def matmul(a, b, *, out_dtype=None):
    """(..., K) @ (K, N) → (..., N) in ``out_dtype`` (default a's dtype)."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type == "cpu":
        out = matmul_ref(a2, b, out_dtype=out_dtype)
    else:
        out = matmul_kernel(a2.contiguous(), b.contiguous(),
                            out_dtype=out_dtype)
        matmul.launches += 1
    return out.reshape(*lead, b.shape[-1])


matmul.launches = 0
