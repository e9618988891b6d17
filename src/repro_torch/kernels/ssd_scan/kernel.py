"""Launcher of the hand-written CUDA SSD chunked scan
(``repro_torch/csrc/ssd_scan.cu``), the port of
``repro.kernels.ssd_scan.kernel.ssd_scan_kernel``.

It reads the model layout through strides, so the SSM block's views go in
as they are: x (B, S, nh, hd), e.g. ``xBC[..., :d_in]`` with a row stride
of the conv width; dt (B, S, nh) f32; A (nh,) f32 (dA = dt · A is formed
in the kernel); Bm and Cm (B, S, G, N) shared over nh/G heads.  S must be
a multiple of the chunk.  y comes back (B, S, nh, hd) contiguous.

Two routes, picked by :func:`ssd_route` from the dtype alone, never by
failure: ``"passes"`` (bf16: five kernels on the tensor cores, with
scratch this module allocates) and ``"f32"`` (one CUDA-core kernel).  This
module builds nothing when imported: the library is built at the first
launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64, 128)         # 128: jamba-1.5-large's SSM heads
STATE_DIMS = (16, 128)
MAX_CHUNK = 256
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("passes", "f32")
CB_TILE = 64                       # the passes' C.B^T tiles (64 x 64)
CP_ASYNC_BYTES = 16                # the passes stage rows in 16-byte copies
INT32_MAX = 2**31 - 1


def _strides(t):
    """``t.stride()`` with 0 for an axis of size 1, whose stride no element
    is read through."""
    return tuple(0 if n == 1 else st for n, st in zip(t.shape, t.stride()))


def ssd_route(dtype) -> str:
    """``"passes"`` for bf16 inputs, ``"f32"`` for f32."""
    return "passes" if dtype == torch.bfloat16 else "f32"


def check_inputs(x, dt, A, Bm, Cm, chunk: int) -> None:
    """Raise on what the kernel does not take: CUDA tensors; x, Bm and Cm of
    one dtype (f32 or bf16), dt and A f32; unit stride on every last axis,
    x's head stride hd, Bm's and Cm's group stride N, dt's head stride 1
    and A contiguous, with the other strides given to the kernel; for the
    bf16 passes, 16-byte aligned bases and rows (they stage rows with
    16-byte copies); hd in :data:`HEAD_DIMS`, N in :data:`STATE_DIMS`,
    1 <= chunk <= 256 dividing S, and nh a multiple of G."""
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan kernel: {name} is on {t.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan kernel: dtype {x.dtype} not in {DTYPES}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan kernel: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan kernel: {name} must be float32, got "
                             f"{t.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan kernel: x and Bm must be 4-D")
    Bsz, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, nh) or A.shape != (nh,)
            or Bm.shape != (Bsz, S, G, N) or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd_scan kernel: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
            f"disagree")
    inner = (("x", x, (hd, 1)), ("dt", dt, (1,)), ("Bm", Bm, (N, 1)),
             ("Cm", Cm, (N, 1)))
    for name, t, want in inner:
        if _strides(t)[2:] != tuple(0 if n == 1 else w
                                     for n, w in zip(t.shape[2:], want)):
            raise ValueError(f"ssd_scan kernel: {name} strides {t.stride()}; "
                             f"the inner ones must be {want}")
        if max(_strides(t)[:2]) > INT32_MAX:
            raise ValueError(f"ssd_scan kernel: {name} strides {t.stride()} "
                             f"do not fit in 32 bits")
    if _strides(A) not in ((1,), (0,)):
        raise ValueError("ssd_scan kernel: A must be contiguous")
    if ssd_route(x.dtype) == "passes":
        unit = CP_ASYNC_BYTES // x.element_size()
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if (t.data_ptr() % CP_ASYNC_BYTES
                    or any(s % unit for s in _strides(t)[:2])):
                raise ValueError(
                    f"ssd_scan kernel: {name} (strides {t.stride()}, base "
                    f"{t.data_ptr() % CP_ASYNC_BYTES} bytes off) is not "
                    f"16-byte aligned by row")
    if G < 1 or nh % G != 0:
        raise ValueError(f"ssd_scan kernel: nh={nh} is not a multiple of G={G}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_scan kernel: hd={hd} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel: N={N} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or S < 1 or S % chunk != 0:
        raise ValueError(f"ssd_scan kernel: chunk={chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide S={S}")


def workspace_shapes(Bsz: int, S: int, nh: int, hd: int, G: int, N: int,
                     chunk: int):
    """Scratch of the bf16 passes, as (name, shape, dtype): cum and dt
    head-major, C.B^T per (batch, group, chunk) in whole 64 x 64 tiles,
    each chunk's own state (f32) and the state entering it (bf16)."""
    nc = S // chunk
    lt = -(-chunk // CB_TILE) * CB_TILE
    return (("cum", (Bsz, nh, S), torch.float32),
            ("dt", (Bsz, nh, S), torch.float32),
            ("cb", (Bsz * G, nc, lt, lt), torch.bfloat16),
            ("states", (Bsz, nc, nh, hd, N), torch.float32),
            ("state_in", (Bsz, nc, nh, hd, N), torch.bfloat16))


def ssd_scan_kernel(x, dt, A, Bm, Cm, *, chunk: int):
    """x: (B, S, nh, hd); dt: (B, S, nh) f32; A: (nh,) f32; Bm/Cm: (B, S, G,
    N), all on the card, strided as :func:`check_inputs` allows → (y (B, S,
    nh, hd) in x's dtype, final state (B, nh, hd, N) f32), launched on the
    current stream without synchronising, through :func:`ssd_route`."""
    check_inputs(x, dt, A, Bm, Cm, chunk)
    Bsz, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, nh, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    ws = [0] * 5
    if ssd_route(x.dtype) == "passes":
        ws = [torch.empty(shape, dtype=dtype, device=x.device)
              for _, shape, dtype in workspace_shapes(Bsz, S, nh, hd, G, N,
                                                      chunk)]
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            *(w if isinstance(w, int) else w.data_ptr() for w in ws),
            Bsz, nh, S, hd, G, N, int(chunk), int(x.dtype == torch.bfloat16),
            *_strides(x)[:2], *_strides(dt)[:2], *_strides(Bm)[:2],
            *_strides(Cm)[:2], stream)
    check(status, f"repro_ssd_scan ({ssd_route(x.dtype)})")
    return y, state
