"""Multi-core Hardware Resource Pool (HRP) — paper §4.2.2.

Copy of ``repro.core.hrp`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_tenancy.py`` holds the two against each other).

The HRP divides the single large accelerator into ``n_cores`` basic shareable
units and leases disjoint subsets to tenants.  Isolation invariants enforced
here (they are *the* public-cloud requirement of the paper):

* **Physical isolation** — leases never overlap; a tenant can only ever touch
  its own cores.  In the serving port a lease maps to a set of logical cores.
* **Bandwidth isolation** — every core owns a fixed off-chip port
  (128-bit DDR slice in the paper; a device's own memory here); the pool checks
  that the per-DDR-group port-bit budget is never oversubscribed
  (``sum(core ports) <= 512 bit`` per DDR bank, §4.2.2).
* **KV-page quota** — a second, memory-side lease dimension: the pool can
  own ``n_kv_pages`` cache pages (the serving layer's paged-KV pool,
  ``repro_torch.serving.kv_cache``), leased per tenant as a *count* (pages are
  fungible — placement is device state).  Like the DDR port budget, the sum
  of kv leases must never exceed the pool, and only tenants holding a core
  lease may hold pages (memory without compute is a leak).
* **Failure isolation** — each core belongs to a *fault domain* (its DDR
  group: shared bank, shared blast radius).  A failed core
  (``mark_failed``) is unplaceable — excluded from ``free_cores`` and every
  placement path — until ``mark_recovered``.  ``check_health`` asserts no
  live lease contains a failed core; the hypervisor displaces the owning
  tenant *in the same event* that delivers the failure, so the invariant
  holds at every event boundary.

The pool is pure bookkeeping — deliberately no torch here; the serving glue
(`repro_torch.serving.tenancy`) turns leases into arrays of torch devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


class HRPError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Lease:
    tenant: str
    cores: tuple  # tuple[int, ...]

    @property
    def n_cores(self) -> int:
        return len(self.cores)


class ResourcePool:
    """Disjoint-lease manager over ``n_cores`` basic shareable units."""

    def __init__(
        self,
        n_cores: int = 16,
        *,
        cores_per_ddr: int = 4,
        ddr_port_bits: int = 512,
        core_port_bits: int = 128,
        n_kv_pages: int = 0,
    ) -> None:
        if cores_per_ddr * core_port_bits > ddr_port_bits:
            raise HRPError(
                "port budget violated at construction: "
                f"{cores_per_ddr} cores x {core_port_bits}b > {ddr_port_bits}b/DDR"
            )
        self.n_cores = n_cores
        self.cores_per_ddr = cores_per_ddr
        self.ddr_port_bits = ddr_port_bits
        self.core_port_bits = core_port_bits
        self.n_kv_pages = n_kv_pages
        self._leases: Dict[str, Lease] = {}
        self._owner: List[Optional[str]] = [None] * n_cores
        self._kv_leases: Dict[str, int] = {}
        self._shared_kv: Dict[str, int] = {}
        self._failed: set = set()   # core indices marked unplaceable

    # -- queries ------------------------------------------------------------
    @property
    def leases(self) -> Dict[str, Lease]:
        return dict(self._leases)

    @property
    def kv_leases(self) -> Dict[str, int]:
        return dict(self._kv_leases)

    def free_cores(self) -> List[int]:
        """Unleased AND healthy: failed cores are never placeable."""
        return [i for i, o in enumerate(self._owner)
                if o is None and i not in self._failed]

    def owner_of(self, core: int) -> Optional[str]:
        return self._owner[core]

    @property
    def n_healthy(self) -> int:
        """Cores the pool can actually place (total minus failed)."""
        return self.n_cores - len(self._failed)

    def failed_cores(self) -> List[int]:
        return sorted(self._failed)

    def fault_domain(self, core: int) -> int:
        """The core's fault domain id — its DDR group (shared bank, shared
        blast radius)."""
        return core // self.cores_per_ddr

    def domain_cores(self, domain: int) -> List[int]:
        lo = domain * self.cores_per_ddr
        return list(range(lo, min(lo + self.cores_per_ddr, self.n_cores)))

    def free_kv_pages(self) -> int:
        return self.n_kv_pages - sum(self._kv_leases.values())

    def lease_of(self, tenant: str) -> Optional[Lease]:
        return self._leases.get(tenant)

    def kv_lease_of(self, tenant: str) -> int:
        return self._kv_leases.get(tenant, 0)

    @property
    def shared_kv(self) -> Dict[str, int]:
        return dict(self._shared_kv)

    def shared_kv_of(self, tenant: str) -> int:
        return self._shared_kv.get(tenant, 0)

    def note_shared_kv(self, tenant: str, pages: int) -> None:
        """Record how many of ``tenant``'s leased kv pages currently back its
        **shared prefix cache** (billed once to the tenant's namespace,
        reused by every request that hits).  Pure bookkeeping fed by the
        serving layer; policies read it from ``PolicyContext.shared_kv_pages``
        so a rebalance knows a tenant's lease cannot usefully drop below its
        pinned shared set without an eviction pass first (the batcher's
        ``set_page_limit`` evicts cache entries before live requests fault).
        ``0`` clears the entry."""
        if pages < 0:
            raise HRPError(f"negative shared kv for {tenant}: {pages}")
        if pages and tenant not in self._leases:
            raise HRPError(
                f"tenant {tenant} holds no core lease for shared kv pages")
        if pages > self.n_kv_pages:
            # fail at the write site, not at some later unrelated event's
            # invariant sweep: a pool with no kv budget can't bill pages
            raise HRPError(
                f"shared kv for {tenant} exceeds the pool: {pages} > "
                f"{self.n_kv_pages}")
        if pages:
            self._shared_kv[tenant] = int(pages)
        else:
            self._shared_kv.pop(tenant, None)

    # -- kv-page leases (memory dimension; counts, not placements) -----------
    def set_kv_lease(self, tenant: str, pages: int) -> None:
        """Set ``tenant``'s kv-page lease to ``pages`` (0 releases it).  The
        tenant must hold a core lease, and the pool total must fit — the
        §4.2.2-style budget rule applied to cache memory."""
        if pages < 0:
            raise HRPError(f"negative kv lease for {tenant}: {pages}")
        if pages and tenant not in self._leases:
            raise HRPError(f"tenant {tenant} holds no core lease for kv pages")
        others = sum(p for t, p in self._kv_leases.items() if t != tenant)
        if others + pages > self.n_kv_pages:
            raise HRPError(
                f"kv pool oversubscribed: {others} held + {pages} for "
                f"{tenant} > {self.n_kv_pages}"
            )
        if pages:
            self._kv_leases[tenant] = pages
        else:
            self._kv_leases.pop(tenant, None)

    # -- invariants ----------------------------------------------------------
    def check_isolation(self) -> None:
        """Leases must be pairwise disjoint and owner table consistent."""
        seen: Dict[int, str] = {}
        for t, lease in self._leases.items():
            for c in lease.cores:
                if c in seen:
                    raise HRPError(f"core {c} leased to both {seen[c]} and {t}")
                if self._owner[c] != t:
                    raise HRPError(f"owner table drift at core {c}")
                seen[c] = t
        for c, o in enumerate(self._owner):
            if o is not None and c not in seen:
                raise HRPError(f"owner table claims {c} -> {o} without a lease")

    def check_bandwidth(self) -> None:
        """Per-DDR-group port-bit budget (§4.2.2 hardware restriction)."""
        n_groups = (self.n_cores + self.cores_per_ddr - 1) // self.cores_per_ddr
        for g in range(n_groups):
            lo, hi = g * self.cores_per_ddr, min((g + 1) * self.cores_per_ddr, self.n_cores)
            bits = sum(
                self.core_port_bits for c in range(lo, hi) if self._owner[c] is not None
            )
            if bits > self.ddr_port_bits:
                raise HRPError(f"DDR group {g} oversubscribed: {bits}b")

    def check_kv_quota(self) -> None:
        """KV-page leases must fit the pool, be non-negative, and only be
        held by tenants that also hold cores (the memory-dimension analogue
        of the per-DDR-group port budget).  Shared (prefix-cache) pages are
        part of the owning tenant's lease, billed once: they must belong to
        a leased tenant and fit the pool in total.  A tenant's shared set
        *may* transiently exceed a freshly-shrunk lease — that is exactly
        the drain window in which the serving layer must evict cache
        entries before live requests fault (``set_page_limit``) — so the
        check bounds shared pages by the pool, not the per-tenant lease."""
        total = 0
        for t, p in self._kv_leases.items():
            if p < 0:
                raise HRPError(f"negative kv lease: {t} -> {p}")
            if t not in self._leases:
                raise HRPError(f"kv lease without a core lease: {t}")
            total += p
        if total > self.n_kv_pages:
            raise HRPError(
                f"kv pool oversubscribed: {total} > {self.n_kv_pages}")
        shared_total = 0
        for t, p in self._shared_kv.items():
            if p < 0:
                raise HRPError(f"negative shared kv: {t} -> {p}")
            if t not in self._leases:
                raise HRPError(f"shared kv without a core lease: {t}")
            shared_total += p
        if shared_total > self.n_kv_pages:
            raise HRPError(
                f"shared kv exceeds the pool: {shared_total} > "
                f"{self.n_kv_pages}")

    # -- failure isolation ----------------------------------------------------
    def mark_failed(self, core: int) -> Optional[str]:
        """Mark ``core`` unplaceable and return its current owner (the
        tenant the hypervisor must displace), or ``None`` if it was free.
        Idempotent; does NOT touch the lease — releasing/re-placing the
        owner is the hypervisor's job, in the same event."""
        if not 0 <= core < self.n_cores:
            raise HRPError(f"core {core} out of range [0, {self.n_cores})")
        self._failed.add(core)
        return self._owner[core]

    def mark_recovered(self, core: int) -> None:
        """Return a repaired core to the placeable set (idempotent)."""
        if not 0 <= core < self.n_cores:
            raise HRPError(f"core {core} out of range [0, {self.n_cores})")
        self._failed.discard(core)

    def check_health(self) -> None:
        """No live lease may contain a failed core — a tenant scheduled onto
        dead hardware is a silent outage.  The hypervisor displaces the
        owner inside the FAILURE event, so this holds at event boundaries."""
        for t, lease in self._leases.items():
            bad = sorted(set(lease.cores) & self._failed)
            if bad:
                raise HRPError(
                    f"tenant {t} leases failed core(s) {bad} "
                    f"(fault domain(s) {sorted({self.fault_domain(c) for c in bad})})")

    # -- placement ------------------------------------------------------------
    def _groups(self) -> List[range]:
        g = self.cores_per_ddr
        return [range(lo, min(lo + g, self.n_cores)) for lo in range(0, self.n_cores, g)]

    def _select_cores(self, n: int, *, tenant: Optional[str] = None) -> List[int]:
        """Pick ``n`` free cores, DDR-group-aware: whole free groups first
        (dedicated banks for the tenant), then groups the tenant already
        partially holds, then best-fit partial groups (fewest free cores —
        keeps remaining whole groups intact), and only then break a fresh
        group.  Caller has verified ``n`` cores are free."""
        groups = self._groups()
        free = {gi: [c for c in grp
                     if self._owner[c] is None and c not in self._failed]
                for gi, grp in enumerate(groups)}
        chosen: List[int] = []
        need = n

        def take(gi: int, k: int) -> None:
            nonlocal need
            grabbed, free[gi] = free[gi][:k], free[gi][k:]
            chosen.extend(grabbed)
            need -= len(grabbed)

        # 1) whole free DDR groups while a full group's worth is still needed
        for gi, grp in enumerate(groups):
            if need >= len(grp) and len(free[gi]) == len(grp):
                take(gi, len(grp))
            if need == 0:
                return chosen
        # 2) extend groups the tenant already partially holds
        if tenant is not None:
            for gi, grp in enumerate(groups):
                if free[gi] and any(self._owner[c] == tenant for c in grp):
                    take(gi, need)
                if need == 0:
                    return chosen
        # 3) best-fit partial groups: fewest free cores first
        partial = sorted(
            (gi for gi, grp in enumerate(groups) if 0 < len(free[gi]) < len(grp)),
            key=lambda gi: (len(free[gi]), gi),
        )
        for gi in partial:
            take(gi, need)
            if need == 0:
                return chosen
        # 4) break a whole free group (lowest index)
        for gi in range(len(groups)):
            if free[gi]:
                take(gi, need)
            if need == 0:
                return chosen
        raise HRPError(f"internal: could not place {n} cores")  # pragma: no cover

    def _shrink_keep(self, cur: Sequence[int], n: int) -> List[int]:
        """Choose which ``n`` of ``cur`` to retain on a shrink: drop cores
        from the groups where the tenant holds the fewest first (consolidates
        the lease onto whole dedicated banks), highest index first within a
        group."""
        g = self.cores_per_ddr
        held: Dict[int, int] = {}
        for c in cur:
            held[c // g] = held.get(c // g, 0) + 1
        drop_order = sorted(cur, key=lambda c: (held[c // g], -c))
        dropped = set(drop_order[: len(cur) - n])
        return sorted(c for c in cur if c not in dropped)

    # -- lifecycle ------------------------------------------------------------
    def alloc(self, tenant: str, n: int) -> Lease:
        if tenant in self._leases:
            raise HRPError(f"tenant {tenant} already holds a lease; use resize()")
        free = self.free_cores()
        if n > len(free):
            raise HRPError(f"want {n} cores, only {len(free)} free")
        # prefer whole DDR groups: keeps tenants' traffic on dedicated banks
        cores = tuple(sorted(self._select_cores(n, tenant=tenant)))
        for c in cores:
            self._owner[c] = tenant
        lease = Lease(tenant, cores)
        self._leases[tenant] = lease
        self.check_isolation()
        self.check_bandwidth()
        return lease

    def release(self, tenant: str) -> None:
        lease = self._leases.pop(tenant, None)
        if lease is None:
            raise HRPError(f"tenant {tenant} holds no lease")
        for c in lease.cores:
            self._owner[c] = None
        self._kv_leases.pop(tenant, None)
        self._shared_kv.pop(tenant, None)

    def resize(self, tenant: str, n: int) -> Lease:
        """Grow/shrink a lease in place — the private-cloud reconfiguration
        primitive.  Retains as many of the tenant's current cores as possible
        (minimizes instruction/context migration)."""
        lease = self._leases.get(tenant)
        if lease is None:
            return self.alloc(tenant, n)
        cur = list(lease.cores)
        if n < len(cur):
            keep = self._shrink_keep(cur, n)
            for c in set(cur) - set(keep):
                self._owner[c] = None
            new = Lease(tenant, tuple(keep))
        elif n > len(cur):
            free = self.free_cores()
            need = n - len(cur)
            if need > len(free):
                raise HRPError(f"resize wants {need} extra cores, only {len(free)} free")
            extra = self._select_cores(need, tenant=tenant)
            for c in extra:
                self._owner[c] = tenant
            new = Lease(tenant, tuple(sorted(cur + extra)))
        else:
            new = lease
        self._leases[tenant] = new
        self.check_isolation()
        self.check_bandwidth()
        return new
