"""Public wrapper for prefix-context flash attention in the model layout.

``prefix_flash_attention`` is what ``models.attention.self_attention``
calls when ``prefix_kv`` is set and ``impl == "cuda"``: suffix queries
attend to the cached prefix K/V plus the fresh suffix K/V without the two
ever being concatenated.  The route follows the tensor's device: a CPU
tensor takes the plain version (:mod:`.ref`), a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
``prefix_flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

from ..common import count_launch
from .kernel import prefix_flash_attention_kernel
from .ref import prefix_flash_attention_ref


def prefix_flash_attention(q, pk, pv, k, v, *, q_offset: int = 0):
    """q: (B, Sq, H, dh); pk/pv: (B, Lp, Hkv, dh); k/v: (B, Sk, Hkv, dh).
    Query row i is suffix position ``q_offset + i``; it sees the full
    prefix and suffix cols ``<= q_offset + i``.  Returns (B, Sq, H, dh)."""
    if q.device.type == "cpu":
        return prefix_flash_attention_ref(q, pk, pv, k, v, q_offset=q_offset)
    out = prefix_flash_attention_kernel(q, pk, pv, k, v, q_offset=q_offset)
    count_launch(prefix_flash_attention)
    return out


prefix_flash_attention.launches = 0
