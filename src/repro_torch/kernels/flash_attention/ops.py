"""Public wrapper for prefill flash attention in the model layout.

``flash_attention`` is what ``models.attention.self_attention(impl="cuda")``
calls.  The route follows the tensor's device: a CPU tensor takes the plain
version (:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There
is no fallback between the two.  ``flash_attention.launches`` counts kernel
launches, so a run can show that its prefills went through the kernel.
"""

from __future__ import annotations

from typing import Optional

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0,
):
    """q: (B, Sq, H, dh); k, v: (B, Sk, Hkv, dh) → (B, Sq, H, dh)."""
    if q.device.type == "cpu":
        out = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset)
        return out.transpose(1, 2)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
