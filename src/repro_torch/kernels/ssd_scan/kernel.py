"""Launcher of the hand-written CUDA SSD chunked-scan kernel
(``repro_torch/csrc/ssd_scan.cu``), the port of
``repro.kernels.ssd_scan.kernel.ssd_scan_kernel``.

It takes the TPU kernel's layout: x (B, nh, S, hd), dt and dA (B, nh, S)
f32, Bm and Cm (B, G, S, N) shared over nh/G heads, with S a multiple of
the chunk.  This module builds nothing when imported: the library is built
at the first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 128)
MAX_CHUNK = 256
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(x, dt, dA, Bm, Cm, chunk: int) -> None:
    """Raise on what the kernel does not take: CUDA tensors, contiguous, x,
    Bm and Cm of one dtype (f32 or bf16), dt and dA f32; hd in
    :data:`HEAD_DIMS`, N in :data:`STATE_DIMS`, 1 <= chunk <= 256 dividing
    S, and nh a multiple of G."""
    named = (("x", x), ("dt", dt), ("dA", dA), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel: {name} is not contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan kernel: dtype {x.dtype} not in {DTYPES}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan kernel: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    for name, t in (("dt", dt), ("dA", dA)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan kernel: {name} must be float32, got "
                             f"{t.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan kernel: x and Bm must be 4-D")
    Bsz, nh, S, hd = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if (dt.shape != (Bsz, nh, S) or dA.shape != dt.shape
            or Bm.shape != (Bsz, G, S, N) or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd_scan kernel: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"dA {tuple(dA.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
            f"disagree")
    if G < 1 or nh % G != 0:
        raise ValueError(f"ssd_scan kernel: nh={nh} is not a multiple of G={G}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_scan kernel: hd={hd} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel: N={N} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or S < 1 or S % chunk != 0:
        raise ValueError(f"ssd_scan kernel: chunk={chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide S={S}")


def ssd_scan_kernel(x, dt, dA, Bm, Cm, *, chunk: int):
    """x: (B, nh, S, hd); dt/dA: (B, nh, S) f32; Bm/Cm: (B, G, S, N) on the
    card → (y (B, nh, S, hd) in x's dtype, final state (B, nh, hd, N) f32),
    launched on the current stream without synchronising."""
    check_inputs(x, dt, dA, Bm, Cm, chunk)
    Bsz, nh, S, hd = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, nh, S, hd,
            G, N, int(chunk), int(x.dtype == torch.bfloat16), stream)
    check(status, "repro_ssd_scan")
    return y, state
