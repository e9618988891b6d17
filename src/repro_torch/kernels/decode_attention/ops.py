"""Public wrapper for dense decode attention in the model layout.

The route follows the tensor's device: a CPU tensor takes the plain version
(:mod:`.ref`), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two.  ``decode_attention.launches`` counts kernel
launches.  A ``meta`` tensor launches nothing: the wrapper returns an empty
output and adds :func:`decode_attention_cost` to the open cost sinks
(``distributed.op_static``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common import count_launch, record_kernel
from .kernel import decode_attention_kernel
from .ref import decode_attention_ref


def decode_attention(q, k, v, pos, cur_pos, *, window: Optional[int] = None,
                     return_stats: bool = False):
    """q: (B, H, dh); k/v: (B, C, Hkv, dh); pos: (B, C); cur_pos: (B,).
    Returns (B, H, dh); with ``return_stats``, (out, m, l): each (row, q
    head)'s running max of its scaled scores (masked slots score NEG_INF)
    and its denominator ``sum exp(s - m)``, f32 (B, H), so that shards of
    the cache's length merge as ``distributed.spmd`` does."""
    if q.device.type == "meta":
        record_kernel(decode_attention, decode_attention_cost(
            q, k, v, pos, cur_pos, window=window))
        out = q.new_empty(q.shape)
        if not return_stats:
            return out
        stat = q.new_empty(q.shape[:2], dtype=torch.float32)
        return out, stat, stat.new_empty(stat.shape)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, cur_pos, window=window,
                                    return_stats=return_stats)
    out = decode_attention_kernel(q, k, v, pos, cur_pos, window=window,
                                  return_stats=return_stats)
    count_launch(decode_attention)
    return out


def valid_slots(pos, cur_pos, window: Optional[int] = None):
    """(B, C) slots a decode row attends to: filled, at or before its
    position, inside the window."""
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    if window is not None:
        valid &= pos > cur_pos[:, None] - window
    return valid


def decode_attention_cost(q, k, v, pos, cur_pos, *,
                          window: Optional[int] = None):
    """(flops, bytes) of one call over the valid K/V rows only: q·k and p·v,
    4 dh a valid slot a query head; q read and out written once, each valid
    K and V row read once, pos and cur_pos read once.  On ``meta`` tensors,
    where no position is known, every slot counts (a full cache, as the
    decode cells hold)."""
    B, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    n_valid = (B * C if pos.device.type == "meta"
               else int(valid_slots(pos, cur_pos, window).sum().item()))
    n_bytes = (2 * B * H * dh * q.element_size()
               + 2 * n_valid * Hkv * dh * k.element_size()
               + B * C * pos.element_size() + B * cur_pos.element_size())
    return 4.0 * dh * H * n_valid, n_bytes


decode_attention.launches = 0
decode_attention.cost = decode_attention_cost
