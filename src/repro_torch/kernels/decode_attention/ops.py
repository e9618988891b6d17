"""Public wrapper for dense decode attention in the model layout.

The route follows the tensor's device: a CPU tensor takes the plain version
(:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two.  ``decode_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Optional

from ..common import count_launch
from .kernel import decode_attention_kernel
from .ref import decode_attention_ref


def decode_attention(q, k, v, pos, cur_pos, *, window: Optional[int] = None):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C); cur_pos: (B,).
    Returns (B, H, dh)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, cur_pos, window=window)
    out = decode_attention_kernel(q, k, v, pos, cur_pos, window=window)
    count_launch(decode_attention)
    return out


decode_attention.launches = 0
