"""Launcher of the hand-written CUDA tiled matmul kernels
(``repro_torch/csrc/matmul.cu``), the port of
``repro.kernels.matmul.kernel.matmul_kernel``.

Two routes, picked by :func:`matmul_route` from the dtypes, shapes,
strides and alignment alone, never by failure: ``"wgmma"`` (bf16 tiles fed
by TMA to the Hopper tensor cores) where TMA can describe both operands,
``"cuda_core"`` (the f32-FMA tile kernel) everywhere else, f32 included so
that f32 products stay exact without TF32.  A route that fails to build or
launch raises.  This module builds nothing when imported: the library is
built at the first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("wgmma", "cuda_core")
TMA_ALIGN = 16                     # bytes: TMA's base and row-stride unit


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


def matmul_route(dtype, M: int, K: int, N: int, a_strides, b_strides,
                 a_addr: int, b_addr: int) -> str:
    """The route of an (M, K) @ (K, N) product of ``dtype`` operands with
    the given element strides and base addresses: ``"wgmma"`` for bf16
    row-major operands whose bases and rows are 16-byte aligned (TMA's
    rule: K and N multiples of 8), else ``"cuda_core"``."""
    row_major = (tuple(a_strides) == (K, 1) and tuple(b_strides) == (N, 1))
    aligned = (a_addr % TMA_ALIGN == 0 and b_addr % TMA_ALIGN == 0
               and (2 * K) % TMA_ALIGN == 0 and (2 * N) % TMA_ALIGN == 0)
    if dtype == torch.bfloat16 and row_major and aligned:
        return "wgmma"
    return "cuda_core"


def route_of(a, b) -> str:
    """:func:`matmul_route` of two tensors."""
    (M, K), N = a.shape, b.shape[1]
    return matmul_route(a.dtype, M, K, N, a.stride(), b.stride(),
                        a.data_ptr(), b.data_ptr())


def matmul_kernel(a, b, *, out_dtype=None, route=None):
    """a: (M, K) @ b: (K, N), both on the card → (M, N) in ``out_dtype``
    (default a's dtype), launched on the current stream without
    synchronising, through ``route`` (default :func:`route_of`)."""
    out_dtype = out_dtype or a.dtype
    check_inputs(a, b, out_dtype)
    route = route or route_of(a, b)
    if route not in ROUTES:
        raise ValueError(f"matmul kernel: route {route!r} not in {ROUTES}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.repro_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(route == "wgmma"), stream)
    check(status, f"repro_matmul ({route})")
    return out
