"""Launcher of the hand-written CUDA RMSNorm kernels
(``repro_torch/csrc/rmsnorm.cu``), the port of
``repro.kernels.rmsnorm.kernel.rmsnorm_kernel``.

Two routes, picked by :func:`rmsnorm_route` from the width, the dtype and
the alignment alone, never by failure: ``"registers"`` (one pass, each row
held in registers: a warp a row up to d = 1024, a block a row above) for
rows that start on a 16-byte boundary and span a multiple of 16 bytes,
``"two_pass"`` (the sum of squares, then y from a second read) for every
other row.  A route that fails to launch raises.  This module builds
nothing when imported: the library is built at the first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 12288           # widest row the reference takes (MAX_D in the source)
ROUTES = ("registers", "two_pass")
VEC_BYTES = 16          # the register route's loads and stores


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


def rmsnorm_route(d: int, itemsize: int, x_addr: int) -> str:
    """The route of rows of ``d`` elements of ``itemsize`` bytes, the first
    at address ``x_addr``: ``"registers"`` when every row starts on a
    16-byte boundary (the first does, and a row spans a multiple of 16
    bytes), else ``"two_pass"``."""
    if x_addr % VEC_BYTES == 0 and (d * itemsize) % VEC_BYTES == 0:
        return "registers"
    return "two_pass"


def route_of(x2d) -> str:
    """:func:`rmsnorm_route` of a (T, d) tensor."""
    return rmsnorm_route(x2d.shape[1], x2d.element_size(), x2d.data_ptr())


def rmsnorm_kernel(x2d, scale, *, eps: float = 1e-6, route=None):
    """x2d: (T, d); scale: (d,), both on the card → (T, d) in x2d's dtype,
    launched on the current stream without synchronising, through
    ``route`` (default :func:`route_of`)."""
    check_inputs(x2d, scale)
    route = route or route_of(x2d)
    if route not in ROUTES:
        raise ValueError(f"rmsnorm kernel: route {route!r} not in {ROUTES}")
    T, d = x2d.shape
    out = torch.empty_like(x2d)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        status = lib.repro_rmsnorm(
            x2d.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d,
            float(eps), int(x2d.dtype == torch.bfloat16),
            int(scale.dtype == torch.bfloat16), int(route == "registers"),
            stream)
    check(status, f"repro_rmsnorm ({route})")
    return out
