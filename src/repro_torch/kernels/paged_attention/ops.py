"""Public wrappers for paged decode and paged verify attention in the
reference's layout.

``paged_decode_attention`` is what
``models.attention.paged_decode_attention(impl="cuda")`` calls, and
``paged_verify_attention`` what ``models.attention.paged_verify_attention
(impl="cuda")`` calls.  The route follows the tensor's device: a CPU tensor
takes the plain version (:mod:`.ref`), a CUDA tensor launches the kernel or
raises.  There is no fallback between the two.  Each wrapper's
``launches`` counts its kernel's launches.

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

from ..common import count_launch
from .kernel import paged_decode_attention_kernel, paged_verify_attention_kernel
from .ref import paged_decode_attention_ref, paged_verify_attention_ref


def paged_decode_attention(q, k_pool, v_pool, page_table, cur_pos):
    """q: (B, H, dh); k_pool/v_pool: (n_pages + 1, page_size, Hkv, dh);
    page_table: (B, max_pages) int32, -1 = unmapped; cur_pos: (B,) int32.
    Returns (B, H, dh)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          cur_pos)
    out = paged_decode_attention_kernel(q, k_pool, v_pool, page_table, cur_pos)
    count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0


def paged_verify_attention(q, k_pool, v_pool, page_table, cur_pos):
    """Multi-query verify leg (draft-and-verify window).  q: (B, W, H, dh),
    W query tokens per slot at absolute positions ``cur_pos + [0, W)``,
    their K/V already written into the pool by the caller; pools, table and
    cur_pos as in :func:`paged_decode_attention`.  Returns (B, W, H, dh)."""
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k_pool, v_pool, page_table,
                                          cur_pos)
    out = paged_verify_attention_kernel(q, k_pool, v_pool, page_table, cur_pos)
    count_launch(paged_verify_attention)
    return out


paged_verify_attention.launches = 0
