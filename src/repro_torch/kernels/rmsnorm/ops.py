"""Public wrapper for RMSNorm over the last axis.

The route follows the tensor's device: a CPU tensor takes the plain version
(:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two.  ``rmsnorm.launches`` counts kernel launches.
"""

from __future__ import annotations

from .kernel import rmsnorm_kernel
from .ref import rmsnorm_ref


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,) → x's shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    shape = x.shape
    out = rmsnorm_kernel(x.reshape(-1, shape[-1]).contiguous(),
                         scale.contiguous(), eps=eps)
    rmsnorm.launches += 1
    return out.reshape(shape)


rmsnorm.launches = 0
