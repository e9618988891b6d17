"""Public wrapper for prefill flash attention in the model layout.

``flash_attention`` is what ``models.attention.self_attention(impl="cuda")``
calls.  The route follows the tensor's device: a CPU tensor takes the plain
version (:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There
is no fallback between the two.  ``flash_attention.launches`` counts kernel
launches, so a run can show that its prefills went through the kernel.
``return_lse=True`` also returns the rows' (B, Sq, H) f32 log-sum-exp, the
training forward's residual (``models.attention.FlashAttentionFn``).
"""

from __future__ import annotations

from typing import Optional

from ..common import count_launch
from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0, return_lse: bool = False,
):
    """q: (B, Sq, H, dh); k, v: (B, Sk, Hkv, dh) → (B, Sq, H, dh) [, lse
    (B, Sq, H) f32]."""
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


flash_attention.launches = 0
