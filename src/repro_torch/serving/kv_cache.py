"""KV-cache lifecycle for serving: ring-buffer seeding from prefill outputs
and the byte accounting used for admission control.

Counterpart of ``repro.serving.kv_cache``: the dense ring-buffer seeding,
the SSM state hand-over, and the
paged pool's host-side ledger
(:class:`PagedKVPool`, copied from the reference; it deals in page counts
and shared-page refcounts, never in tensors) with its byte accounting.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Optional

import torch

from ..device import torch_dtype
from ..models.attention import KVCacheView
from ..models.ssm import SSMState, ssm_dims


def cache_len(cfg, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def seed_kv_cache(cfg, k, v, *, max_len: int, seq_positions=None,
                  block=None) -> KVCacheView:
    """Seed a decode cache from prefill K/V.

    k, v: (nb, B, S, Hkv, dh) — stacked over blocks.
    Ring-buffer placement: absolute position s lands in slot s % C, so decode
    can continue writing at cur_pos % C without any copy.  Only the last C
    positions are kept (for sliding-window archs C = window; older K/V is
    dead weight by definition of the mask).

    ``block=(lo, hi)`` seeds only ring slots ``[lo, hi)``: a cache whose
    length is sharded over ranks (``distributed.spmd``), each rank's block
    made without the whole ring.
    """
    nb, B, S, Hkv, dh = k.shape
    C = cache_len(cfg, max_len)
    keep = min(S, C)
    pos = torch.arange(S - keep, S, device=k.device)   # absolute positions kept
    slots = pos % C                                      # ring slots
    kk, vv = k[:, :, S - keep:], v[:, :, S - keep:]
    lo, hi = (0, C) if block is None else block
    if block is not None:
        mine = (slots >= lo) & (slots < hi)
        pos, slots = pos[mine], slots[mine] - lo
        kk, vv = kk[:, :, mine], vv[:, :, mine]
    ck = torch.zeros((nb, B, hi - lo, Hkv, dh), dtype=k.dtype, device=k.device)
    cv = torch.zeros((nb, B, hi - lo, Hkv, dh), dtype=v.dtype, device=v.device)
    cpos = torch.full((nb, B, hi - lo), -1, dtype=torch.int32, device=k.device)
    ck[:, :, slots] = kk
    cv[:, :, slots] = vv
    cpos[:, :, slots] = pos.to(torch.int32)
    return KVCacheView(k=ck, v=cv, pos=cpos)


def seed_ssm_state(state: SSMState) -> SSMState:
    """Prefill already produces the exact decode state; pass it through
    (the hook where a quantized-state server would intercept)."""
    return state


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


# ---------------------------------------------------------------------------
# Paged KV pool — host-side allocator / quota ledger
# ---------------------------------------------------------------------------


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV entries."""
    return -(-max(int(n_tokens), 0) // max(int(page_size), 1))


class PageQuotaError(RuntimeError):
    """A page allocation would exceed the pool or an owner's quota."""


class PagedKVPool:
    """Host-side ledger for one tenant-visible pool of fixed-size KV pages.

    The *device* owns the authoritative free stack and page tables (see
    ``repro_torch.serving.engine.PageState`` — allocation happens inside the jitted
    chunk and admission steps); this class is the admission-control mirror: it
    tracks how many pages each owner (a request, a slot, a tenant…) has
    reserved, enforces per-owner quotas and the pool bound, and does the
    byte accounting the tenancy layer leases against.  It deliberately
    deals in *counts*, not page ids — ids are device state.

    Conservation invariant (checked by :meth:`check`): the sum of all
    owners' reservations never exceeds ``n_pages``, and no owner exceeds
    its quota.  Over-subscription is expressed through quotas: the sum of
    quotas may exceed the pool (that is the point of paging) — the pool
    bound is enforced on actual reservations.

    **Shared pages** (the prefix cache, :mod:`repro_torch.serving.prefix_cache`) are the
    one place the ledger tracks *ids*, not counts: a page whose contents are
    reusable across requests is moved out of its admitting owner's count
    (:meth:`share`) into a per-namespace shared set with a per-page
    **refcount** of active users (:meth:`acquire`/:meth:`release`).  A
    shared page is recyclable only at ``refcount == 0`` and only through an
    explicit cache eviction (:meth:`drop_shared`) — until then it stays off
    the free side of the conservation equation:

        free + Σ owner counts (private) + #shared == n_pages
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._held: Dict[Hashable, int] = {}
        self._quota: Dict[Hashable, int] = {}
        self._shared: Dict[int, Hashable] = {}   # page id -> owning namespace
        self._ref: Dict[int, int] = {}           # page id -> active users

    # -- queries --------------------------------------------------------
    @property
    def used(self) -> int:
        return sum(self._held.values()) + len(self._shared)

    @property
    def available(self) -> int:
        return self.n_pages - self.used

    def held_by(self, owner: Hashable) -> int:
        return self._held.get(owner, 0)

    def quota_of(self, owner: Hashable) -> int:
        return self._quota.get(owner, self.n_pages)

    def can_alloc(self, owner: Hashable, n: int) -> bool:
        return (n <= self.available
                and self.held_by(owner) + n <= self.quota_of(owner))

    # -- lifecycle ------------------------------------------------------
    def set_quota(self, owner: Hashable, quota: Optional[int]) -> None:
        """Cap ``owner``'s reservation; ``None`` removes the cap.  A quota
        below the owner's current holding is allowed (it only blocks further
        growth — the hypervisor shrinks leases the same way)."""
        if quota is None:
            self._quota.pop(owner, None)
        else:
            self._quota[owner] = max(int(quota), 0)

    def alloc(self, owner: Hashable, n: int) -> int:
        """Reserve ``n`` pages for ``owner``; returns the owner's new total.
        Raises :class:`PageQuotaError` when the pool or quota is exceeded."""
        if n < 0:
            raise ValueError("cannot alloc a negative page count")
        if n > self.available:
            raise PageQuotaError(
                f"want {n} pages, only {self.available}/{self.n_pages} free")
        held = self.held_by(owner) + n
        if held > self.quota_of(owner):
            raise PageQuotaError(
                f"owner {owner!r} would hold {held} pages "
                f"(quota {self.quota_of(owner)})")
        self._held[owner] = held
        return held

    def free(self, owner: Hashable, n: Optional[int] = None) -> int:
        """Return ``n`` pages (default: all) from ``owner``; returns how many
        were actually freed."""
        held = self.held_by(owner)
        n = held if n is None else min(int(n), held)
        if n < 0:
            raise ValueError("cannot free a negative page count")
        left = held - n
        if left:
            self._held[owner] = left
        else:
            self._held.pop(owner, None)
        return n

    # -- shared pages (prefix cache) ------------------------------------
    @property
    def shared(self) -> int:
        """Pages currently owned by prefix-cache namespaces."""
        return len(self._shared)

    def shared_by(self, namespace: Hashable) -> int:
        return sum(1 for ns in self._shared.values() if ns == namespace)

    def shared_ids(self) -> set:
        """Ids of all cache-owned pages — legitimately multi-mapped
        (read-only), so the batcher's page-table audit exempts them from
        double-mapping detection."""
        return set(self._shared)

    def pinned_shared(self) -> int:
        """Shared pages with at least one active user — the set a lease
        shrink cannot reclaim without faulting a live request."""
        return sum(1 for pid, rc in self._ref.items() if rc > 0)

    def refcount(self, page_id: int) -> int:
        return self._ref.get(int(page_id), 0)

    def share(self, owner: Hashable, namespace: Hashable,
              page_ids: Iterable[int]) -> None:
        """Move pages out of ``owner``'s private count into ``namespace``'s
        shared set (billed once to the namespace, refcount 0 — callers
        :meth:`acquire` separately for each active user)."""
        pids = [int(p) for p in page_ids]
        if not pids:
            return
        held = self.held_by(owner)
        if len(pids) > held:
            raise PageQuotaError(
                f"owner {owner!r} shares {len(pids)} pages but holds {held}")
        for pid in pids:
            if pid in self._shared:
                raise PageQuotaError(f"page {pid} is already shared")
            if not (0 <= pid < self.n_pages):
                raise PageQuotaError(f"page id {pid} outside the pool")
            self._shared[pid] = namespace
            self._ref[pid] = 0
        self.free(owner, len(pids))

    def acquire(self, page_ids: Iterable[int]) -> None:
        """Register one more active user on each shared page."""
        for pid in page_ids:
            pid = int(pid)
            if pid not in self._shared:
                raise PageQuotaError(f"acquire of unshared page {pid}")
            self._ref[pid] += 1

    def release(self, page_ids: Iterable[int]) -> None:
        """Drop one active user from each shared page.  A page that reaches
        refcount 0 stays shared (its contents are the cache's value) until
        an eviction calls :meth:`drop_shared`."""
        for pid in page_ids:
            pid = int(pid)
            if self._ref.get(pid, 0) < 1:
                raise PageQuotaError(f"release of page {pid} without users")
            self._ref[pid] -= 1

    def drop_shared(self, page_ids: Iterable[int]) -> int:
        """Evict pages from the shared set (cache eviction); they become
        free.  Only refcount-0 pages may be dropped; returns how many were."""
        pids = [int(p) for p in page_ids]
        for pid in pids:
            if pid not in self._shared:
                raise PageQuotaError(f"drop of unshared page {pid}")
            if self._ref.get(pid, 0) != 0:
                raise PageQuotaError(
                    f"page {pid} evicted with {self._ref[pid]} active users")
        for pid in pids:
            del self._shared[pid]
            del self._ref[pid]
        return len(pids)

    def check(self) -> None:
        """Conservation + quota invariants; raises :class:`PageQuotaError`."""
        if self.used > self.n_pages:
            raise PageQuotaError(
                f"pool oversubscribed: {self.used} > {self.n_pages}")
        for owner, held in self._held.items():
            if held < 0:
                raise PageQuotaError(f"owner {owner!r} holds {held} pages")
            if held > self.quota_of(owner):
                raise PageQuotaError(
                    f"owner {owner!r} holds {held} > quota "
                    f"{self.quota_of(owner)}")
        if set(self._ref) != set(self._shared):
            raise PageQuotaError("refcount table drifted from the shared set")
        for pid, rc in self._ref.items():
            if rc < 0:
                raise PageQuotaError(f"shared page {pid} has refcount {rc}")
            if not (0 <= pid < self.n_pages):
                raise PageQuotaError(f"shared page id {pid} outside the pool")

    def page_bytes(self, cfg) -> int:
        return page_bytes(cfg, self.page_size)

    def pool_bytes(self, cfg) -> int:
        return paged_kv_cache_bytes(cfg, self.n_pages, self.page_size)


def page_bytes(cfg, page_size: int) -> int:
    """HBM bytes of ONE pool page summed over every attention layer (the
    granularity the hypervisor's ``kv_pages`` lease dimension trades in)."""
    from ..models.transformer import n_blocks, period_structure

    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    dt = torch_dtype(cfg.dtype).itemsize
    n_attn = sum(1 for s in specs if s.mixer == "attn")
    return n_attn * nb * page_size * cfg.n_kv_heads * cfg.d_head * 2 * dt


def paged_kv_cache_bytes(cfg, n_pages: int, page_size: int, *,
                         policy=None) -> int:
    """HBM bytes of the full paged pool (incl. the trash page) — the paged
    analogue of :func:`kv_cache_bytes` for admission control.  With an
    SPMD ``policy`` (on a process mesh), one rank's pool: its kv heads,
    whole over the data axes (``distributed.spmd``)."""
    if policy is not None:
        cfg = policy.layer_cfg(cfg)
    return (n_pages + 1) * page_bytes(cfg, page_size)


def kv_cache_bytes(cfg, batch: int, max_len: int, *, policy=None) -> int:
    """Device bytes of the full decode cache for admission control.  With
    an SPMD ``policy`` made for ``batch`` rows, the bytes one rank holds:
    ``policy.init_caches``' blocks (its slots, heads or ring block, SSM
    heads and channels), counted on meta tensors."""
    from ..models.transformer import n_blocks, period_structure

    if policy is not None:
        if policy.batch != batch:
            raise ValueError(f"the policy was made for {policy.batch} rows, "
                             f"not {batch}")
        return tree_bytes(policy.init_caches(max_len, device="meta"))

    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    C = cache_len(cfg, max_len)
    dt = torch_dtype(cfg.dtype).itemsize
    total = 0
    for spec in specs:
        if spec.mixer == "attn":
            total += nb * batch * C * cfg.n_kv_heads * cfg.d_head * 2 * dt
            total += nb * batch * C * 4                     # pos int32
        else:
            s = cfg.ssm
            d_in, nh, d_bc = ssm_dims(cfg)
            total += nb * batch * (s.d_conv - 1) * (d_in + d_bc) * dt
            total += nb * batch * nh * s.head_dim * s.d_state * 4   # f32
    if cfg.family == "audio":
        # the decoder's cross-attention K/V over the encoder output
        total += cfg.n_layers * batch * cfg.enc_seq * cfg.kv_dim * 2 * dt
    return total
