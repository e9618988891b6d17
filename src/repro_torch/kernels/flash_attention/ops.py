"""Public wrapper for prefill flash attention in the model layout.

``flash_attention`` is what ``models.attention.self_attention(impl="cuda")``
calls.  The route follows the tensor's device: a CPU tensor takes the plain
version (:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There
is no fallback between the two.  ``flash_attention.launches`` counts kernel
launches, so a run can show that its prefills went through the kernel.
``return_lse=True`` also returns the rows' (B, Sq, H) f32 log-sum-exp, the
training forward's residual (``models.attention.FlashAttentionFn``).  A
``meta`` tensor launches nothing: the wrapper returns empty outputs and
adds :func:`flash_attention_cost` to the open cost sinks
(``distributed.op_static``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common import attended_pairs, count_launch, record_kernel
from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0, return_lse: bool = False,
):
    """q: (B, Sq, H, dh); k, v: (B, Sk, Hkv, dh) → (B, Sq, H, dh) [, lse
    (B, Sq, H) f32]."""
    if q.device.type == "meta":
        record_kernel(flash_attention, flash_attention_cost(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            return_lse=return_lse))
        out = q.new_empty(q.shape)
        if return_lse:
            return out, q.new_empty(q.shape[:3], dtype=torch.float32)
        return out
    if q.device.type == "cpu":
        got = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset,
            return_lse=return_lse)
        if return_lse:
            return got[0].transpose(1, 2), got[1].transpose(1, 2)
        return got.transpose(1, 2)
    got = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=return_lse)
    count_launch(flash_attention)
    return got


def flash_attention_cost(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         return_lse: bool = False):
    """(flops, bytes) of one call: QK^T and PV over the attended pairs
    only, 4 dh a pair a head; q and k, v read once, out (and the f32 LSE)
    written once."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window,
                           q_offset=q_offset)
    n_bytes = (2 * B * Sq * H * dh + 2 * B * Sk * Hkv * dh) * q.element_size()
    if return_lse:
        n_bytes += 4 * B * Sq * H
    return 4.0 * dh * pairs * B * H, n_bytes


flash_attention.launches = 0
flash_attention.cost = flash_attention_cost
