"""Gradient compression: block-wise symmetric int8 quantization with error
feedback.  Counterpart of ``repro.distributed.compression`` (lines 26-75):
the AdamW moments of ``optim.adamw(quantize=True)`` are stored this way.

Rounding is half to even in both packages (``torch.round``,
``jnp.round``).  The cross-pod all-reduce on an int8 wire,
``pod_psum_compressed``, needs a mesh of several cards with a ``"pod"``
axis and waits for ROADMAP item 18; ``training.make_train_step`` takes the
reference's own uncompressed branch whenever there is no such mesh.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_map


def _blockify(x, block: int):
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = (n + block - 1) // block
    pad = nb * block - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(nb, block), n


def quantize_int8(x, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8.  Returns (q (nb, block) int8, scale
    (nb, 1) f32)."""
    xb, _ = _blockify(x.float(), block)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape, *, block: int = 256):
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def quantization_error(x, *, block: int = 256):
    q, s = quantize_int8(x, block=block)
    return x - dequantize_int8(q, s, x.shape, block=block).to(x.dtype)


def init_error_feedback(params):
    """Zero f32 residual tree matching the grads."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(g, e, *, block: int = 256):
    """One tensor: returns (q, scale, new_residual)."""
    corrected = g.float() + e
    q, s = quantize_int8(corrected, block=block)
    deq = dequantize_int8(q, s, g.shape, block=block)
    return q, s, corrected - deq


__all__ = ["compress_with_feedback", "dequantize_int8", "init_error_feedback",
           "quantization_error", "quantize_int8"]
