"""Seeded fault injection for the fault-domain hypervisor.

Copy of ``repro.core.faults`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_tenancy.py`` holds the two against each other).

The paper's isolation story (§4.2.2) is about *performance*: disjoint
leases, per-DDR-group port budgets.  A production pool also needs *failure*
isolation — a dead core, a wedged DMA engine, or a flipped bit in cache
memory must stay contained to the fault domain (one DDR group / one
tenant's lease), never ripple into neighbours.  This module provides the
chaos half of that contract: a deterministic, seeded :class:`FaultInjector`
that turns fault models into ``FAILURE``/``RECOVERY`` events on the
hypervisor's global timeline.

Determinism contract (mirrors :class:`repro_torch.core.events.PoissonTraffic`):
``FaultInjector(seed=s).schedule(h)`` returns the byte-identical fault list
on every call and every platform — the stream is drawn from a private
``random.Random(seed)`` re-seeded per call, and fault kinds are iterated in
a fixed order.  Same seed ⇒ same fault schedule ⇒ replayable chaos runs
(``benchmarks/bench_chaos.py`` leans on this for its two-run determinism
acceptance bit).

Fault models:

* ``CORE_DEATH``   — a core becomes unplaceable (``ResourcePool.mark_failed``);
  the owning tenant is displaced and re-placed by the hypervisor.  Repairs
  after ``duration`` via a ``RECOVERY`` event when ``repair=True``.
* ``CORE_SLOW``    — a core degrades by ``factor`` (e.g. thermal throttling);
  visible to the engine's straggler probes (``VirtualEngine.core_slowdown``),
  which is exactly the detection path the paper's §6.4 crosstalk experiment
  exercises.  Always repairs after ``duration``.
* ``KV_CORRUPT``   — a cache page's content is suspect (the serving-side
  analogue: the batcher's page-table audit quarantines the page and the
  NaN sentinel catches poisoned logits).  Delivered to the executor as an
  event; no pool-level state change.
"""

from __future__ import annotations

import dataclasses
import enum
import random
from typing import List, Optional

from .events import EventKind, EventQueue


class FaultKind(enum.Enum):
    """What breaks.  Iteration order is part of the determinism contract —
    :meth:`FaultInjector.schedule` draws streams per kind in this order."""

    CORE_DEATH = "core_death"
    CORE_SLOW = "core_slow"
    KV_CORRUPT = "kv_corrupt"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: what, where, when, and for how long.

    ``core`` is the victim core index (``CORE_DEATH``/``CORE_SLOW``);
    ``page`` the victim kv page (``KV_CORRUPT``); ``factor`` the slowdown
    multiplier (``CORE_SLOW``).  ``duration`` is seconds until the matching
    ``RECOVERY`` event (``None`` = permanent).  ``fid`` is the injector's
    stable per-schedule id, usable as a correlation key in logs."""

    time: float
    kind: FaultKind
    fid: int
    core: Optional[int] = None
    page: Optional[int] = None
    factor: float = 1.0
    duration: Optional[float] = None


class FaultInjector:
    """Seeded Poisson fault process over a pool of ``n_cores`` cores.

    Per-kind rates are events/second across the whole pool (a fault then
    picks its victim core/page uniformly).  ``schedule(horizon)`` is pure:
    the same injector produces the identical schedule every call.
    """

    def __init__(
        self,
        n_cores: int,
        *,
        seed: int = 0,
        death_rate: float = 0.0,
        slow_rate: float = 0.0,
        corrupt_rate: float = 0.0,
        n_kv_pages: int = 0,
        repair_after: Optional[float] = 2.0,
        slow_factor: float = 3.0,
        start: float = 0.0,
    ) -> None:
        if n_cores <= 0:
            raise ValueError(f"n_cores must be positive, got {n_cores}")
        for name, rate in (("death_rate", death_rate),
                           ("slow_rate", slow_rate),
                           ("corrupt_rate", corrupt_rate)):
            if rate < 0:
                raise ValueError(f"{name} must be >= 0, got {rate}")
        if corrupt_rate > 0 and n_kv_pages <= 0:
            raise ValueError("corrupt_rate > 0 needs n_kv_pages > 0")
        self.n_cores = n_cores
        self.n_kv_pages = n_kv_pages
        self.seed = seed
        self.rates = {
            FaultKind.CORE_DEATH: death_rate,
            FaultKind.CORE_SLOW: slow_rate,
            FaultKind.KV_CORRUPT: corrupt_rate,
        }
        self.repair_after = repair_after
        self.slow_factor = slow_factor
        self.start = start

    def schedule(self, horizon: float) -> List[FaultSpec]:
        """The deterministic fault schedule up to ``horizon``, time-ordered.

        Each kind draws an independent Poisson stream from one private
        ``random.Random(seed)`` in fixed ``FaultKind`` order, so adding a
        rate for one kind never perturbs another kind's stream timing
        *within* the same kind (streams are drawn sequentially — the
        contract is per-(seed, rates) determinism, not per-kind isolation).
        """
        rng = random.Random(self.seed)
        faults: List[FaultSpec] = []
        for kind in FaultKind:           # fixed iteration order
            rate = self.rates[kind]
            if rate <= 0:
                continue
            t = self.start
            while True:
                t += rng.expovariate(rate)
                if t > horizon:
                    break
                if kind is FaultKind.KV_CORRUPT:
                    victim_core, page = None, rng.randrange(self.n_kv_pages)
                else:
                    victim_core, page = rng.randrange(self.n_cores), None
                if kind is FaultKind.CORE_DEATH:
                    duration = self.repair_after
                elif kind is FaultKind.CORE_SLOW:
                    duration = self.repair_after if self.repair_after is not None else 2.0
                else:
                    duration = None      # corruption repairs by quarantine
                faults.append(FaultSpec(
                    time=t, kind=kind, fid=0, core=victim_core, page=page,
                    factor=self.slow_factor if kind is FaultKind.CORE_SLOW else 1.0,
                    duration=duration,
                ))
        faults.sort(key=lambda f: f.time)
        return [dataclasses.replace(f, fid=i) for i, f in enumerate(faults)]

    def inject(self, queue: EventQueue, horizon: float) -> List[FaultSpec]:
        """Push the schedule onto ``queue`` as ``FAILURE`` events (plus a
        ``RECOVERY`` per repairable fault at ``time + duration``) and return
        it.  The hypervisor resolves the victim *tenant* at handling time —
        whoever owns the core when the fault fires."""
        faults = self.schedule(horizon)
        for f in faults:
            queue.schedule(EventKind.FAILURE, f.time, fault=f)
            if f.duration is not None and f.time + f.duration <= horizon:
                queue.schedule(EventKind.RECOVERY, f.time + f.duration, fault=f)
        return faults
