"""Launcher of the hand-written CUDA prefix-context flash-attention kernel
(``repro_torch/csrc/prefix_flash_attention.cu``), the port of
``repro.kernels.prefix_attention.kernel.prefix_flash_attention_kernel``.

The kernel reads the cached prefix and the fresh suffix as two operands in
the model layout (B, S, Hkv, dh), so no concat, transpose or padding is
made around it; ragged Sq, Lp and Sk are masked in the kernel.  bf16 inputs
run on the tensor cores (``csrc/attn_mma.cuh``), f32 inputs in full f32 on
the CUDA cores (``csrc/attn_common.cuh``): a dispatch on dtype inside the
one C entry point.  This module builds nothing when imported: the library
is built at the first launch.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, pk, pv, k, v) -> None:
    """Raise on what the kernel does not take: CUDA tensors of one dtype
    (f32 or bf16), contiguous in the (B, S, H, dh) layout."""
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"prefix_flash_attention kernel: {name} is on "
                             f"{t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"prefix_flash_attention kernel: {name} is "
                             f"{t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"prefix_flash_attention kernel: {name} is not "
                             f"contiguous")
        if t.dim() != 4:
            raise ValueError(f"prefix_flash_attention kernel: {name} must be 4-D")
    if q.dtype not in DTYPES:
        raise ValueError(f"prefix_flash_attention kernel: dtype {q.dtype} not "
                         f"in {DTYPES}")
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    if (pk.shape != pv.shape or k.shape != v.shape or pk.shape[0] != B
            or k.shape[0] != B or pk.shape[2] != Hkv or pk.shape[3] != dh
            or k.shape[3] != dh or Sq < 1 or pk.shape[1] + k.shape[1] < 1):
        raise ValueError(
            f"prefix_flash_attention kernel: shapes q {tuple(q.shape)} pk "
            f"{tuple(pk.shape)} pv {tuple(pv.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} disagree")
    if H % Hkv != 0:
        raise ValueError(f"prefix_flash_attention kernel: H={H} is not a "
                         f"multiple of Hkv={Hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"prefix_flash_attention kernel: dh={dh} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"prefix_flash_attention kernel: {name} is not "
                             f"16-byte aligned for its cp.async copies")


def prefix_flash_attention_kernel(q, pk, pv, k, v, *, q_offset: int = 0):
    """q: (B, Sq, H, dh); pk/pv: (B, Lp, Hkv, dh); k/v: (B, Sk, Hkv, dh) on
    the card → (B, Sq, H, dh) in q's dtype, launched on the current stream
    without synchronising."""
    check_inputs(q, pk, pv, k, v)
    B, Sq, H, dh = q.shape
    Lp, Sk, Hkv = pk.shape[1], k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.repro_prefix_flash_attention(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, Sq, Lp, Sk, H, Hkv, dh,
            int(q_offset), int(q.dtype == torch.bfloat16), stream)
    check(status, "repro_prefix_flash_attention")
    return out
