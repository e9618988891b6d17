"""Public wrapper for prefix-context flash attention in the model layout.

``prefix_flash_attention`` is what ``models.attention.self_attention``
calls when ``prefix_kv`` is set and ``impl == "cuda"``: suffix queries
attend to the cached prefix K/V plus the fresh suffix K/V without the two
ever being concatenated.  The route follows the tensor's device: a CPU
tensor takes the plain version (:mod:`.ref`), a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
``prefix_flash_attention.launches`` counts kernel launches.  A ``meta``
tensor launches nothing: the wrapper returns an empty output and adds
:func:`prefix_attention_cost` to the open cost sinks
(``distributed.op_static``).
"""

from __future__ import annotations

from ..common import attended_pairs, count_launch, record_kernel
from .kernel import prefix_flash_attention_kernel
from .ref import prefix_flash_attention_ref


def prefix_flash_attention(q, pk, pv, k, v, *, q_offset: int = 0):
    """q: (B, Sq, H, dh); pk/pv: (B, Lp, Hkv, dh); k/v: (B, Sk, Hkv, dh).
    Query row i is suffix position ``q_offset + i``; it sees the full
    prefix and suffix cols ``<= q_offset + i``.  Returns (B, Sq, H, dh)."""
    if q.device.type == "meta":
        record_kernel(prefix_flash_attention, prefix_attention_cost(
            q, pk, pv, k, v, q_offset=q_offset))
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return prefix_flash_attention_ref(q, pk, pv, k, v, q_offset=q_offset)
    out = prefix_flash_attention_kernel(q, pk, pv, k, v, q_offset=q_offset)
    count_launch(prefix_flash_attention)
    return out


def prefix_attention_cost(q, pk, pv, k, v, *, q_offset: int = 0):
    """(flops, bytes) of one call: every prefix column and the causal
    suffix pairs, 4 dh a pair a head; q, the prefix and suffix K/V read
    once, out written once."""
    B, Sq, H, dh = q.shape
    Lp, Sk, Hkv = pk.shape[1], k.shape[1], k.shape[2]
    pairs = Sq * Lp + attended_pairs(Sq, Sk, q_offset=q_offset)
    n_bytes = ((2 * B * Sq * H * dh + 2 * B * (Lp + Sk) * Hkv * dh)
               * q.element_size())
    return 4.0 * dh * pairs * B * H, n_bytes


prefix_flash_attention.launches = 0
prefix_flash_attention.cost = prefix_attention_cost
