"""Public wrapper for the tiled matmul.

The leading dims of ``a`` are flattened into M and both operands made
contiguous, as ``repro.kernels.matmul.ops`` does.  The route follows the
tensor's device: a CPU tensor takes the plain version (:mod:`.ref`), a
CUDA tensor launches a kernel or raises.  There is no fallback between
the two, nor between the kernel's routes (``kernel.matmul_route``).
``matmul.launches`` counts kernel launches, and ``matmul.route_launches``
counts them by route.  A ``meta`` tensor launches nothing: the wrapper
returns an empty output and adds :func:`matmul_cost` to the open cost sinks
(``distributed.op_static``).
"""

from __future__ import annotations

from ..common import count_launch, record_kernel
from .kernel import ROUTES, matmul_kernel, route_of
from .ref import matmul_ref


def matmul(a, b, *, out_dtype=None):
    """(..., K) @ (K, N) → (..., N) in ``out_dtype`` (default a's dtype)."""
    lead = a.shape[:-1]
    if a.device.type == "meta":
        record_kernel(matmul, matmul_cost(a, b, out_dtype=out_dtype))
        return a.new_empty((*lead, b.shape[-1]), dtype=out_dtype or a.dtype)
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type == "cpu":
        out = matmul_ref(a2, b, out_dtype=out_dtype)
    else:
        a2, b2 = a2.contiguous(), b.contiguous()
        route = route_of(a2, b2)
        out = matmul_kernel(a2, b2, out_dtype=out_dtype, route=route)
        count_launch(matmul, route)
    return out.reshape(*lead, b.shape[-1])


def matmul_cost(a, b, *, out_dtype=None):
    """(flops, bytes) of one call: 2 M N K; a and b read once, c written
    once in ``out_dtype``."""
    K, N = b.shape
    M = a.numel() // K
    out_size = (out_dtype or a.dtype).itemsize
    return (2.0 * M * N * K, M * K * a.element_size()
            + K * N * b.element_size() + M * N * out_size)


matmul.launches = 0
matmul.cost = matmul_cost
matmul.route_launches = dict.fromkeys(ROUTES, 0)
