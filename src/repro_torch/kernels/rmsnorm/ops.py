"""Public wrapper for RMSNorm over the last axis.

The route follows the tensor's device: a CPU tensor takes the plain version
(:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two, nor between the kernel's routes
(``kernel.rmsnorm_route``).  ``rmsnorm.launches`` counts kernel launches,
and ``rmsnorm.route_launches`` counts them by route.  A ``meta`` tensor
launches nothing: the wrapper returns an empty output and adds
:func:`rmsnorm_cost` to the open cost sinks (``distributed.op_static``).
"""

from __future__ import annotations

from ..common import count_launch, record_kernel
from .kernel import ROUTES, rmsnorm_kernel, route_of
from .ref import rmsnorm_ref


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,) → x's shape and dtype."""
    if x.device.type == "meta":
        record_kernel(rmsnorm, rmsnorm_cost(x, scale))
        return x.new_empty(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    route = route_of(x2d)
    out = rmsnorm_kernel(x2d, scale.contiguous(), eps=eps, route=route)
    count_launch(rmsnorm, route)
    return out.reshape(shape)


def rmsnorm_cost(x, scale):
    """(flops, bytes) of one call: square, sum and two products an element;
    x read and y written once, the scale read once."""
    T = x.numel() // x.shape[-1]
    d = x.shape[-1]
    return 4.0 * T * d, 2 * T * d * x.element_size() + d * scale.element_size()


rmsnorm.launches = 0
rmsnorm.cost = rmsnorm_cost
rmsnorm.route_launches = dict.fromkeys(ROUTES, 0)
