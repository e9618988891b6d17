"""Public wrappers for paged decode and paged verify attention in the
reference's layout.

``paged_decode_attention`` is what
``models.attention.paged_decode_attention(impl="cuda")`` calls, and
``paged_verify_attention`` what ``models.attention.paged_verify_attention
(impl="cuda")`` calls.  The route follows the tensor's device: a CPU tensor
takes the plain version (:mod:`.ref`), a CUDA tensor launches the kernel or
raises.  There is no fallback between the two.  Each wrapper's
``launches`` counts its kernel's launches.  A ``meta`` tensor launches
nothing: the wrapper returns an empty output and adds its kernel's
``cost`` to the open cost sinks (``distributed.op_static``).

The reference's wrapper maps ``-1`` table entries to the trash page before
its kernel (``repro/kernels/paged_attention/ops.py:38``).  Here the CUDA
kernel does that mapping itself as it reads the table (any entry outside
``[0, n_pages)`` loads the trash page and is masked), so the raw table goes
in unchanged and no extra elementwise launch is made per layer.  The
reference's verify wrapper also transposes q into window-major rows per kv
head and the output back (``ops.py:60-69``); the verify kernel reads and
writes the model layout in that row order by its indexing instead.
"""

from __future__ import annotations

import torch

from ..common import count_launch, record_kernel
from .kernel import paged_decode_attention_kernel, paged_verify_attention_kernel
from .ref import paged_decode_attention_ref, paged_verify_attention_ref


def paged_decode_attention(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, H, dh); k_pool/v_pool: (n_pages + 1, page_size, Hkv, dh);
    page_table: (B, max_pages) int32, -1 = unmapped; cur_pos: (B,) int32.
    Returns (B, H, dh)."""
    if q.device.type == "meta":
        record_kernel(paged_decode_attention, paged_decode_cost(
            q, k_pool, v_pool, page_table, cur_pos))
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          cur_pos)
    out = paged_decode_attention_kernel(q, k_pool, v_pool, page_table, cur_pos)
    count_launch(paged_decode_attention)
    return out


def _paged_valid(page_table, cur_pos, page_size: int, W: int):
    """(B, W, L) keys each of a slot's W query rows attends to: mapped
    pages, positions at or before ``cur_pos + w``."""
    L = page_table.shape[1] * page_size
    pos = torch.arange(L, device=page_table.device)
    mapped = (page_table >= 0)[:, pos // page_size]
    rows = cur_pos[:, None] + torch.arange(W, device=cur_pos.device)[None, :]
    return mapped[:, None, :] & (pos[None, None, :] <= rows[:, :, None])


def _paged_cost(q, k_pool, page_table, cur_pos, W: int):
    """(flops, bytes) of a paged call of W query rows a slot: 4 dh a
    (row, key) pair a query head over the mapped keys at or before each
    row; q read and out written once, each K and V row some row of the
    window attends read once, the table and cur_pos read once.  On
    ``meta`` tensors every table entry counts as mapped and every position
    as attended."""
    B, H, dh = q.shape[0], q.shape[-2], q.shape[-1]
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    maxp = page_table.shape[1]
    if q.device.type == "meta":
        n_pairs, n_rows = B * W * maxp * ps, B * maxp * ps
    else:
        valid = _paged_valid(page_table, cur_pos, ps, W)
        n_pairs = int(valid.sum().item())
        n_rows = int(valid[:, -1].sum().item())
    n_bytes = (2 * B * W * H * dh * q.element_size()
               + 2 * n_rows * Hkv * dh * k_pool.element_size()
               + B * maxp * page_table.element_size()
               + B * cur_pos.element_size())
    return 4.0 * dh * H * n_pairs, n_bytes


def paged_decode_cost(q, k_pool, v_pool, page_table, cur_pos):
    """(flops, bytes) of one :func:`paged_decode_attention` call."""
    return _paged_cost(q, k_pool, page_table, cur_pos, 1)


def paged_verify_cost(q, k_pool, v_pool, page_table, cur_pos):
    """(flops, bytes) of one :func:`paged_verify_attention` call."""
    return _paged_cost(q, k_pool, page_table, cur_pos, q.shape[1])


paged_decode_attention.launches = 0
paged_decode_attention.cost = paged_decode_cost


def paged_verify_attention(q, k_pool, v_pool, page_table, cur_pos):
    """Multi-query verify leg (draft-and-verify window).  q: (B, W, H, dh),
    W query tokens per slot at absolute positions ``cur_pos + [0, W)``,
    their K/V already written into the pool by the caller; pools, table and
    cur_pos as in :func:`paged_decode_attention`.  Returns (B, W, H, dh)."""
    if q.device.type == "meta":
        record_kernel(paged_verify_attention, paged_verify_cost(
            q, k_pool, v_pool, page_table, cur_pos))
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k_pool, v_pool, page_table,
                                          cur_pos)
    out = paged_verify_attention_kernel(q, k_pool, v_pool, page_table, cur_pos)
    count_launch(paged_verify_attention)
    return out


paged_verify_attention.launches = 0
paged_verify_attention.cost = paged_verify_cost
