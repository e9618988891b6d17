"""KV-cache lifecycle for serving: ring-buffer seeding from prefill outputs
and the byte accounting used for admission control.

Counterpart of the dense parts of ``repro.serving.kv_cache``.  The paged
pool (``PagedKVPool``, ``pages_for``, ``page_bytes``) arrives with the
paged slice (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import torch

from ..device import torch_dtype
from ..models.attention import KVCacheView


def cache_len(cfg, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def seed_kv_cache(cfg, k, v, *, max_len: int, seq_positions=None) -> KVCacheView:
    """Seed a decode cache from prefill K/V.

    k, v: (nb, B, S, Hkv, dh) — stacked over blocks.
    Ring-buffer placement: absolute position s lands in slot s % C, so decode
    can continue writing at cur_pos % C without any copy.  Only the last C
    positions are kept (for sliding-window archs C = window; older K/V is
    dead weight by definition of the mask).
    """
    nb, B, S, Hkv, dh = k.shape
    C = cache_len(cfg, max_len)
    keep = min(S, C)
    pos = torch.arange(S - keep, S, device=k.device)   # absolute positions kept
    slots = pos % C                                      # ring slots
    ck = torch.zeros((nb, B, C, Hkv, dh), dtype=k.dtype, device=k.device)
    cv = torch.zeros((nb, B, C, Hkv, dh), dtype=v.dtype, device=v.device)
    cpos = torch.full((nb, B, C), -1, dtype=torch.int32, device=k.device)
    ck[:, :, slots] = k[:, :, S - keep:]
    cv[:, :, slots] = v[:, :, S - keep:]
    cpos[:, :, slots] = pos.to(torch.int32)
    return KVCacheView(k=ck, v=cv, pos=cpos)


def tree_bytes(tree) -> int:
    """Resident bytes of a cache tree (tensors in nested tuples, lists and
    dicts) — reported as ``BatcherStats.cache_bytes``."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(x) for x in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(x) for x in tree)
    return 0


def kv_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Device bytes of the full decode cache for admission control."""
    from ..models.transformer import n_blocks, period_structure

    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    C = cache_len(cfg, max_len)
    dt = torch_dtype(cfg.dtype).itemsize
    total = 0
    for spec in specs:
        if spec.mixer == "attn":
            total += nb * batch * C * cfg.n_kv_heads * cfg.d_head * 2 * dt
            total += nb * batch * C * 4                     # pos int32
    return total
