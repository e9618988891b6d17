"""Hypervisor — the paper's §4.1 scheduling layer as a global event loop.

Copy of ``repro.core.hypervisor`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_tenancy.py`` holds the two against each other).

The seed reproduction simulated each tenant's clock separately inside
:class:`~repro.core.vengine.VirtualEngine.run`; dynamic arrivals, departures
and pool-wide rebalancing had to be faked outside the engine.  This module
owns that logic: a :class:`Hypervisor` holds the
:class:`~repro_torch.core.hrp.ResourcePool`, consumes a single time-ordered
:class:`~repro_torch.core.events.EventQueue`, and on every event asks a pluggable
**reallocation policy** how the pool should be divided among the tenants that
exist *now*.  Decisions are carried out by an **executor** — the
discrete-event :class:`VirtualEngine` for simulation, a bookkeeping-only
:class:`PoolExecutor` for analytic sweeps, or the serving adapter
(:class:`repro_torch.serving.tenancy.ServingExecutor`) where a resize decision
becomes a ``TwoStageCompiler.reconfigure`` call.

Policies (registered in :data:`POLICIES`):

* ``even_split``           — the paper's Figure-7 elastic scheme: divide the
                             pool evenly among tenants, capped at each
                             tenant's request, leftovers redistributed;
* ``weighted_by_workload`` — cores proportional to per-tenant workload
                             weight (defaults to total FLOPs of the tenant's
                             static artifact);
* ``priority``             — reserve every tenant's floor, then satisfy
                             requests in priority order;
* ``latency_slo``          — admit/resize against per-tenant latency targets:
                             each tenant's **demand** is the fewest cores
                             whose *queue-adjusted* latency — estimated
                             single-inference service time plus the M/D/1
                             mean wait its open-loop arrival rate induces —
                             fits under its SLO with headroom.  Demands are
                             granted in priority order: a higher-priority
                             arrival shrinks lower-priority residents toward
                             their floor, while an equal-or-lower-priority
                             newcomer is admitted all-or-nothing from the
                             capacity residents' SLOs don't need, else it
                             queues (or preempts, see below);
* ``no_realloc``           — baseline: residents keep their leases; newcomers
                             are admitted all-or-nothing from the free pool.
                             This is the seed engine's behaviour — the
                             degenerate one-policy case.

Tenants whose policy share would fall below ``min_cores`` are not admitted;
they park in a **wait queue** and are retried after every departure or
reconfiguration.  ``admission="fifo"`` (default) drains it head-of-line —
deterministic, but a big blocked head stalls everyone behind it;
``admission="backfill"`` walks the whole queue in order each drain, so small
tenants slip past a blocked head (EASY-style backfilling without
reservations — churn can starve the head); ``admission="easy"`` adds the
**reservation**: anyone admitted past a blocked head must leave the head's
floor in free cores, so departures accumulate toward the head's start time
instead of being re-consumed forever.  With ``preemptive=True`` an arrival
that cannot be admitted may **evict** strictly-lower-priority residents —
lowest priority tier first, largest **SLO slack** first within a tier (the
resident with the most latency headroom pays; no-SLO tenants are infinitely
slack), deterministic youngest-arrival/name tie-break — until it fits;
victims are charged a context switch by the executor (``exec_evict``) and
re-queued at the head of the wait queue.

**Second lease dimension — kv pages.**  When the pool is built with
``n_kv_pages > 0``, every admission/rebalance also splits the cache-page
budget (the serving layer's paged-KV pool): the core policy decides compute,
then ``kv_policy`` (default :func:`kv_pages_proportional` — memory follows
compute) maps that decision to per-tenant page leases, honouring
``TenantSpec.min_kv_pages`` floors all-or-nothing exactly like ``min_cores``.
Leases are recorded in the pool (``set_kv_lease``) with shrink-before-grow
ordering, surfaced to executors through the optional
``exec_kv_resize(name, pages, at)`` hook (the serving adapter turns it into
``ContinuousBatcher.set_page_limit``), and re-checked after every event by
``check_kv_quota`` alongside the isolation/bandwidth invariants.

**Open-loop traffic** rides on the same queue: ``REQUEST`` events (from
:class:`~repro_torch.core.events.PoissonTraffic` / ``TraceTraffic`` via
:meth:`Hypervisor.open_traffic`) are routed to the executor's
``exec_request`` for resident tenants and held in a per-tenant backlog for
waiting ones (delivered on admission — offered load is never dropped).  When
the executor finishes a request it reports through ``completion_sink``; the
hypervisor turns that into a ``COMPLETION`` event, so request lifecycles are
visible on the global timeline (``completion_log``).

Executor protocol (duck-typed; every hook is optional except the ``exec_*``
trio when the corresponding event is used):

    begin(horizon)                    -> None   # run() starts
    advance(until)                    -> None   # simulate up to global time
    exec_admit(spec, n_cores, at)     -> None
    exec_resize(name, n_cores, at, mode) -> None
    exec_remove(name, at)             -> None
    exec_evict(name, at)              -> None   # preemption (falls back to
                                                # exec_remove when absent)
    exec_request(name, record, at)    -> None   # open-loop request delivery
    exec_fault(fault, at)             -> None   # a FaultSpec fires
    exec_recover(fault, at)           -> None   # its repair lands
    estimate_latency(spec, n_cores)   -> float  # latency_slo demand model
    completion_sink                   -> attr   # set by the hypervisor to
                                                # receive finished records
    probe(at)                         -> int    # straggler sweep, #rebalances
    metrics()                         -> dict   # returned by run()

**Fault domain handling.**  ``FAILURE`` events (from
:class:`repro_torch.core.faults.FaultInjector`, or :meth:`fail_core` in tests)
deliver :class:`~repro_torch.core.faults.FaultSpec` payloads.  ``CORE_DEATH``
marks the core unplaceable (``ResourcePool.mark_failed``) and **displaces**
the owning tenant in the same event: its lease is released through
``exec_evict`` (generated work survives — the engine parks in-flight
requests, the serving adapter keeps live state) and re-placement on the
healthy remainder is attempted immediately.  When that fails the tenant
parks at the *head* of the wait queue and retries on an
exponential-backoff ``RECOVERY`` timer (``fault_retry_backoff`` seconds,
doubling) until capacity returns.  ``CORE_SLOW``/``KV_CORRUPT`` are
forwarded to the executor (``exec_fault``) — detection is the straggler
probe / serving-guard path, not a placement change.  Repair ``RECOVERY``
events undo the fault (``mark_recovered`` + ``exec_recover``) and re-drain
the wait queue.  ``recovery_log`` records each displaced tenant's
failure→re-placement latency; blast radius is bounded by construction —
only tenants leasing the failed core are ever displaced.

The HRP isolation invariants (`check_isolation`, `check_bandwidth`,
`check_kv_quota`, `check_health`) are re-verified after *every* handled
event — a violated invariant raises immediately at the event that caused
it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Union

from ..obs import Telemetry

from .dispatch import SwitchMode
from .events import Event, EventKind, EventQueue, RequestRecord, emit_requests
from .faults import FaultKind, FaultSpec
from .hrp import HRPError, ResourcePool


@dataclasses.dataclass
class TenantSpec:
    """What a tenant asks of the hypervisor (the admission contract).

    ``artifact`` is executor-specific payload: a
    :class:`~repro.core.static_compiler.StaticArtifact` for the simulation
    engine, a program-key string for the serving stack, or ``None`` for
    bookkeeping-only pools.

    ``latency_slo`` and ``arrival_rate`` feed the ``latency_slo`` policy:
    the target single-request latency (seconds; the SLO) and the tenant's
    open-loop offered load (requests/s; 0 = unknown, skips the stability
    check).  ``open_loop=True`` declares the tenant request-driven from
    admission — it idles until its first REQUEST instead of re-issuing
    closed-loop inferences (a tenant also flips open-loop implicitly on its
    first delivered request).

    ``requested_kv_pages`` / ``min_kv_pages`` are the **memory dimension**
    of the lease (the paged-KV pool of ``repro_torch.serving``): how many cache
    pages the tenant wants, and the floor below which it cannot run.
    Admission is all-or-nothing on the floor, exactly like ``min_cores``.
    """

    name: str
    requested_cores: int
    min_cores: int = 1
    priority: float = 1.0
    weight: Optional[float] = None     # None -> derived from artifact workload
    artifact: Any = None
    arrived_at: float = 0.0            # stamped by the hypervisor on admission
    latency_slo: Optional[float] = None
    arrival_rate: float = 0.0
    open_loop: bool = False
    requested_kv_pages: int = 0
    min_kv_pages: int = 0


@dataclasses.dataclass
class PolicyContext:
    """Snapshot a policy decides over: the pool size, the tenants that should
    hold cores after the decision (arrival order preserved; may include a
    not-yet-admitted candidate), the current lease sizes of residents, and —
    when the executor provides one — a latency estimator
    ``latency(spec, n_cores) -> seconds`` for SLO-aware decisions."""

    n_cores: int
    tenants: List[TenantSpec]
    current: Dict[str, int]
    time: float
    latency: Optional[Callable[[TenantSpec, int], float]] = None
    # memory dimension: pool-wide kv-page budget and current kv leases
    n_kv_pages: int = 0
    current_kv: Dict[str, int] = dataclasses.field(default_factory=dict)
    # pages of each tenant's lease that back its shared prefix cache,
    # billed once to the owning namespace (``ResourcePool.note_shared_kv``):
    # a kv split that drops a tenant below this set forces a cache-eviction
    # drain before its live requests can even use the lease, so policies
    # treat it as a soft floor
    shared_kv_pages: Dict[str, int] = dataclasses.field(default_factory=dict)


Policy = Callable[[PolicyContext], Dict[str, int]]


# ---------------------------------------------------------------------------
# reallocation policies
# ---------------------------------------------------------------------------

def _arrival_order(specs: List[TenantSpec]) -> List[TenantSpec]:
    return sorted(specs, key=lambda s: (s.arrived_at, s.name))


def _cap_and_redistribute(order: List[TenantSpec], shares: Dict[str, int],
                          n_cores: int) -> Dict[str, int]:
    """Clamp each share to the tenant's request; hand leftover cores one at a
    time to tenants still below their request (arrival order)."""
    alloc = {s.name: min(shares[s.name], s.requested_cores) for s in order}
    leftover = n_cores - sum(alloc.values())
    progress = True
    while leftover > 0 and progress:
        progress = False
        for s in order:
            if leftover == 0:
                break
            if alloc[s.name] < s.requested_cores:
                alloc[s.name] += 1
                leftover -= 1
                progress = True
    return alloc


def even_split(ctx: PolicyContext) -> Dict[str, int]:
    """Figure-7 elastic scheme: pool // T each, remainder to the earliest
    arrivals, capped at each tenant's request."""
    order = _arrival_order(ctx.tenants)
    if not order:
        return {}
    base, rem = divmod(ctx.n_cores, len(order))
    shares = {s.name: base + (1 if i < rem else 0) for i, s in enumerate(order)}
    return _cap_and_redistribute(order, shares, ctx.n_cores)


def _spec_weight(spec: TenantSpec) -> float:
    if spec.weight is not None:
        return max(spec.weight, 0.0)
    workload = getattr(spec.artifact, "workload", None)
    if workload:
        try:
            return max(sum(layer.flops for layer in workload), 1.0)
        except (AttributeError, TypeError):
            pass
    return 1.0


def weighted_by_workload(ctx: PolicyContext) -> Dict[str, int]:
    """Cores proportional to tenant weight (largest-remainder rounding) on
    top of a one-core floor, capped at each tenant's request."""
    order = _arrival_order(ctx.tenants)
    if not order:
        return {}
    # floors clamped to remaining capacity (arrival order) so shares can
    # never oversubscribe the pool; a tenant clamped below its min_cores is
    # simply not admitted (the hypervisor's floor check parks it)
    floors: Dict[str, int] = {}
    free = ctx.n_cores
    for s in order:
        floors[s.name] = min(max(s.min_cores, 1), s.requested_cores, free)
        free -= floors[s.name]
    spare = ctx.n_cores - sum(floors.values())
    shares = dict(floors)
    if spare > 0:
        weights = {s.name: _spec_weight(s) for s in order}
        total_w = sum(weights.values()) or 1.0
        raw = {s.name: spare * weights[s.name] / total_w for s in order}
        for s in order:
            shares[s.name] += int(raw[s.name])
        left = spare - sum(int(raw[s.name]) for s in order)
        by_remainder = sorted(
            order, key=lambda s: (-(raw[s.name] - int(raw[s.name])),
                                  s.arrived_at, s.name),
        )
        for s in by_remainder[:left]:
            shares[s.name] += 1
    return _cap_and_redistribute(order, shares, ctx.n_cores)


def priority(ctx: PolicyContext) -> Dict[str, int]:
    """Reserve every tenant's floor (arrival order), then satisfy requests in
    descending priority order with what remains."""
    order = _arrival_order(ctx.tenants)
    alloc: Dict[str, int] = {s.name: 0 for s in order}
    free = ctx.n_cores
    for s in order:
        floor = min(max(s.min_cores, 1), s.requested_cores, free)
        alloc[s.name] = floor
        free -= floor
    for s in sorted(order, key=lambda s: (-s.priority, s.arrived_at, s.name)):
        give = min(s.requested_cores - alloc[s.name], free)
        if give > 0:
            alloc[s.name] += give
            free -= give
    return alloc


#: utilisation ceiling for the latency_slo stability check — an open-loop
#: tenant whose offered load would keep its cores busier than this is given
#: more cores (queueing delay explodes as utilisation -> 1).
SLO_RHO_MAX = 0.85
#: service latency must fit under this fraction of the SLO: the slack left
#: over absorbs queueing delay, standing in for a p99 (not mean) target.
SLO_HEADROOM = 0.9


def queueing_latency(service: float, rate: float,
                     rho_max: float = SLO_RHO_MAX) -> float:
    """Expected request latency under open-loop Poisson offered load:
    service time plus the M/D/1 mean wait ``rho/(2(1-rho)) x L`` at
    utilisation ``rho = rate x L``.  Infinite at/beyond ``rho_max`` — an
    unstable (or near-saturated) queue can never meet a latency SLO, no
    matter the service time."""
    if rate <= 0:
        return service
    rho = service * rate
    if rho >= rho_max:
        return float("inf")
    return service * (1.0 + rho / (2.0 * (1.0 - rho)))


def slo_demand(ctx: PolicyContext, spec: TenantSpec, *,
               rho_max: float = SLO_RHO_MAX,
               headroom: float = SLO_HEADROOM) -> int:
    """Fewest cores meeting ``spec``'s latency SLO: the *queue-adjusted*
    latency — single-inference service time ``L(k)`` plus the M/D/1 mean
    wait its open-loop ``arrival_rate`` induces — must fit under
    ``headroom x latency_slo``.  Tenants without an SLO (or without a
    latency model) demand only their floor; when no admissible core count
    satisfies the target, the demand is the full request (best effort)."""
    floor = min(max(spec.min_cores, 1), spec.requested_cores)
    if spec.latency_slo is None or ctx.latency is None:
        return floor
    for k in range(floor, spec.requested_cores + 1):
        est = ctx.latency(spec, k)
        if est is None:
            return floor
        if queueing_latency(est, spec.arrival_rate, rho_max) \
                <= headroom * spec.latency_slo:
            return k
    return spec.requested_cores


def _priority_order(specs: List[TenantSpec]) -> List[TenantSpec]:
    return sorted(specs, key=lambda s: (-s.priority, s.arrived_at, s.name))


def latency_slo(ctx: PolicyContext) -> Dict[str, int]:
    """SLO-aware admission/reallocation.

    1. every resident keeps at least its floor (always feasible — they all
       held their floor before this decision);
    2. one priority-ordered pass (arrival breaks ties, so residents outrank
       same-priority newcomers) tops residents up toward their SLO demand
       and admits newcomers **all-or-nothing at their demand**.  A higher-
       priority arrival therefore *shrinks* lower-priority residents toward
       their floor — graceful degradation — rather than being locked out,
       while an equal-or-lower-priority newcomer can never dig into what a
       resident's SLO needs: if its demand doesn't fit in what's left, it
       gets 0 and parks (the preemptive hypervisor may instead evict a
       lower-priority resident whose *floor* is in the way);
    3. leftover cores go to tenants below their request, priority order —
       the policy is work-conserving.
    """
    order = _arrival_order(ctx.tenants)
    residents = [s for s in order if s.name in ctx.current]
    demands = {s.name: slo_demand(ctx, s) for s in order}
    alloc = {s.name: 0 for s in order}
    free = ctx.n_cores
    for s in _priority_order(residents):
        give = min(max(s.min_cores, 1), s.requested_cores, free)
        alloc[s.name] = give
        free -= give
    for s in _priority_order(order):
        if s.name in ctx.current:
            give = min(demands[s.name] - alloc[s.name], free)
            if give > 0:
                alloc[s.name] += give
                free -= give
        else:
            need = max(demands[s.name], max(s.min_cores, 1))
            if need <= min(free, s.requested_cores):
                alloc[s.name] = need
                free -= need
    for s in _priority_order(order):
        if free == 0:
            break
        if alloc[s.name] > 0 or s.name in ctx.current:
            give = min(s.requested_cores - alloc[s.name], free)
            if give > 0:
                alloc[s.name] += give
                free -= give
    return alloc


def no_realloc(ctx: PolicyContext) -> Dict[str, int]:
    """Baseline (the seed engine's semantics): residents keep their leases —
    except honouring their *own* explicit resize requests — and newcomers are
    admitted all-or-nothing from the free pool."""
    free = ctx.n_cores - sum(ctx.current.values())
    alloc: Dict[str, int] = {}
    for s in _arrival_order(ctx.tenants):
        cur = ctx.current.get(s.name)
        want = s.requested_cores
        if cur is None:                      # newcomer: all-or-nothing
            grant = want if want <= free else 0
        elif want < cur:                     # voluntary shrink
            grant = want
        elif want > cur:                     # voluntary grow, best-effort
            grant = cur + min(want - cur, free)
        else:
            grant = cur
        free -= grant - (cur or 0)
        alloc[s.name] = grant
    return alloc


def kv_pages_proportional(ctx: PolicyContext,
                          core_alloc: Dict[str, int]) -> Dict[str, int]:
    """Default kv-page split: among tenants granted cores, reserve every
    floor (``min_kv_pages``, arrival order), then share the remainder
    proportionally to the *core* grant (largest remainder), capped at each
    tenant's request — memory follows compute unless a policy says
    otherwise.  Tenants asking for no pages get none.

    A tenant's **shared prefix-cache pages** (``ctx.shared_kv_pages``,
    billed once to the owning namespace) raise its floor: granting below
    the pinned shared set would force the serving layer to tear the cache
    down just to re-fault the same contents privately per request — the
    split avoids that unless the pool genuinely cannot cover every floor,
    in which case the shrink lands and the batcher's eviction-before-fault
    discipline (``set_page_limit``) drains the cache first."""
    order = [s for s in _arrival_order(ctx.tenants)
             if core_alloc.get(s.name, 0) > 0 and s.requested_kv_pages > 0]
    if not order or ctx.n_kv_pages <= 0:
        return {s.name: 0 for s in ctx.tenants}
    alloc: Dict[str, int] = {s.name: 0 for s in ctx.tenants}
    free = ctx.n_kv_pages
    for s in order:
        shared = ctx.shared_kv_pages.get(s.name, 0)
        floor = min(max(s.min_kv_pages, shared), s.requested_kv_pages, free)
        alloc[s.name] = floor
        free -= floor
    if free > 0:
        weights = {s.name: core_alloc.get(s.name, 0) for s in order}
        total_w = sum(weights.values()) or 1.0
        raw = {s.name: free * weights[s.name] / total_w for s in order}
        grants = {}
        for s in order:
            grants[s.name] = min(int(raw[s.name]),
                                 s.requested_kv_pages - alloc[s.name])
            alloc[s.name] += grants[s.name]
        left = free - sum(grants.values())
        by_remainder = sorted(
            order, key=lambda s: (-(raw[s.name] - int(raw[s.name])),
                                  s.arrived_at, s.name),
        )
        while left > 0:
            progress = False
            for s in by_remainder:
                if left == 0:
                    break
                if alloc[s.name] < s.requested_kv_pages:
                    alloc[s.name] += 1
                    left -= 1
                    progress = True
            if not progress:
                break
    return alloc


POLICIES: Dict[str, Policy] = {
    "even_split": even_split,
    "weighted_by_workload": weighted_by_workload,
    "priority": priority,
    "latency_slo": latency_slo,
    "no_realloc": no_realloc,
}


def resolve_policy(policy: Union[str, Policy]) -> Policy:
    if callable(policy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown reallocation policy {policy!r}; "
            f"choose from {sorted(POLICIES)} or pass a callable"
        ) from None


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class PoolExecutor:
    """Bookkeeping-only executor: policy decisions act on the
    :class:`ResourcePool` directly, with no timeline behind them.  Used when
    the hypervisor only *places* tenants and an external runtime executes
    them (e.g. the Figure-7 analytic throughput sweep)."""

    def __init__(self, pool: ResourcePool) -> None:
        self.pool = pool

    def begin(self, horizon: float) -> None:
        pass

    def advance(self, until: float) -> None:
        pass

    def exec_admit(self, spec: TenantSpec, n_cores: int, at: float) -> None:
        self.pool.alloc(spec.name, n_cores)

    def exec_resize(self, name: str, n_cores: int, at: float, mode: SwitchMode) -> None:
        self.pool.resize(name, n_cores)

    def exec_remove(self, name: str, at: float) -> None:
        self.pool.release(name)

    def probe(self, at: float) -> int:
        return 0

    def metrics(self) -> Dict[str, Any]:
        return {}


# ---------------------------------------------------------------------------
# the hypervisor
# ---------------------------------------------------------------------------

class Hypervisor:
    """Global event-driven scheduler over one :class:`ResourcePool`.

    Two usage styles share one code path:

    * **simulated time** — schedule arrivals/departures/reconfigs on the
      queue, then ``run(horizon)``; the executor's ``advance`` is called to
      bring the simulation to each event's timestamp before it is handled;
    * **immediate mode** — call :meth:`admit` / :meth:`depart` /
      :meth:`resize_request` directly (the serving stack, where time is real
      and the loop is an ordered decision log).

    ``on_event(hypervisor, event)`` is invoked after every handled event —
    a hook for traces and invariant assertions in tests.
    """

    def __init__(
        self,
        pool: Optional[ResourcePool] = None,
        *,
        policy: Union[str, Policy] = "even_split",
        executor: Any = None,
        probe_interval: Optional[float] = None,
        switch_mode: SwitchMode = SwitchMode.LAYER_LEVEL,
        admission: str = "fifo",
        preemptive: bool = False,
        kv_policy: Optional[Callable[[PolicyContext, Dict[str, int]],
                                     Dict[str, int]]] = None,
        fault_retry_backoff: float = 0.05,
        on_event: Optional[Callable[["Hypervisor", Event], None]] = None,
        telemetry: Optional[Telemetry] = None,
    ) -> None:
        if pool is None:
            if executor is None or not hasattr(executor, "pool"):
                raise ValueError("pass a ResourcePool or an executor exposing .pool")
            pool = executor.pool
        if admission not in ("fifo", "backfill", "easy"):
            raise ValueError(
                f"unknown admission order {admission!r}; "
                "use 'fifo', 'backfill' or 'easy'"
            )
        self.pool = pool
        self.policy = resolve_policy(policy)
        self.executor = executor if executor is not None else PoolExecutor(pool)
        self.queue = EventQueue()
        self.specs: Dict[str, TenantSpec] = {}
        self.waiting: List[TenantSpec] = []
        self.probe_interval = probe_interval
        self.switch_mode = switch_mode
        self.admission = admission
        self.preemptive = preemptive
        self.kv_policy = kv_policy if kv_policy is not None \
            else kv_pages_proportional
        self.on_event = on_event
        # telemetry: every handled event becomes a trace instant on the
        # "hypervisor" track (stamped with *event* time, so a sim run and a
        # real-time run both render), a per-kind counter in the registry,
        # and — for completions — a per-tenant latency histogram
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._tracer = self.telemetry.tracer
        self._reg = self.telemetry.registry
        self.clock = 0.0
        self.trace: List[Event] = []
        # open-loop request plumbing: finished records (COMPLETION events),
        # requests that arrived while their tenant waited for admission, and
        # preemption accounting
        self.completion_log: List[RequestRecord] = []
        self.preemptions: List[str] = []
        self._request_backlog: Dict[str, List[RequestRecord]] = {}
        self._rid = itertools.count()
        # fault-domain bookkeeping: delivered faults, per-displaced-tenant
        # failure timestamps, recovery records, and retry backoff state
        self.fault_log: List[FaultSpec] = []
        self.recovery_log: List[Dict[str, Any]] = []
        self.fault_retry_backoff = fault_retry_backoff
        self._displaced_at: Dict[str, float] = {}
        self._retry_backoff: Dict[str, float] = {}
        if hasattr(self.executor, "completion_sink"):
            self.executor.completion_sink = self._request_completed

    @staticmethod
    def _validate(spec: TenantSpec) -> None:
        if spec.requested_cores < 1:
            raise ValueError(
                f"tenant {spec.name!r} requests {spec.requested_cores} cores; "
                "a tenant needs at least 1"
            )

    # -- scheduling ---------------------------------------------------------
    def schedule_arrival(self, spec: TenantSpec, *, at: float = 0.0) -> Event:
        self._validate(spec)
        return self.queue.schedule(EventKind.ARRIVAL, at, tenant=spec.name, spec=spec)

    def schedule_departure(self, name: str, *, at: float) -> Event:
        return self.queue.schedule(EventKind.DEPARTURE, at, tenant=name)

    def schedule_reconfig(self, name: str, n_cores: int, *, at: float,
                          mode: Optional[SwitchMode] = None) -> Event:
        return self.queue.schedule(
            EventKind.RECONFIG, at, tenant=name, n_cores=n_cores, mode=mode,
        )

    def schedule_completion(self, name: str, *, at: float, **payload: Any) -> Event:
        return self.queue.schedule(EventKind.COMPLETION, at, tenant=name, **payload)

    def schedule_probe(self, *, at: float) -> Event:
        return self.queue.schedule(EventKind.PROBE, at)

    def schedule_fault(self, fault: FaultSpec, *,
                       recovery: bool = True) -> Event:
        """Schedule one fault on the timeline (plus its repair ``RECOVERY``
        when the fault carries a ``duration``).  Bulk injection goes through
        :meth:`repro_torch.core.faults.FaultInjector.inject` on ``self.queue``."""
        ev = self.queue.schedule(EventKind.FAILURE, fault.time, fault=fault)
        if recovery and fault.duration is not None:
            self.queue.schedule(EventKind.RECOVERY,
                                fault.time + fault.duration, fault=fault)
        return ev

    def schedule_request(self, name: str, *, at: float,
                         record: Optional[RequestRecord] = None,
                         slo: Optional[float] = None) -> RequestRecord:
        """Schedule one open-loop request for ``name``; returns the (shared)
        record that will be stamped as the request moves through the system."""
        if record is None:
            record = RequestRecord(tenant=name, rid=next(self._rid),
                                   t_arrival=at, slo=slo)
        self.queue.schedule(EventKind.REQUEST, at, tenant=name, record=record)
        return record

    def open_traffic(self, name: str, traffic: Any, horizon: float, *,
                     slo: Optional[float] = None,
                     deadline_after: Optional[float] = None,
                     ) -> List[RequestRecord]:
        """Attach a seeded open-loop arrival stream
        (:class:`~repro_torch.core.events.PoissonTraffic`, ``TraceTraffic``, or a
        plain iterable of times) to tenant ``name`` and return its records
        for SLO accounting after :meth:`run`.  ``deadline_after`` stamps
        each request with a drop deadline (arrival + seconds): the executor
        sheds requests it would only start past their deadline."""
        return emit_requests(self.queue, name, traffic, horizon, slo=slo,
                             deadline_after=deadline_after)

    def _request_completed(self, record: RequestRecord) -> None:
        # executor callback -> COMPLETION event, so request lifecycles are
        # ordered on (and visible in) the global timeline
        self.queue.schedule(EventKind.COMPLETION, record.t_complete,
                            tenant=record.tenant, record=record)

    # -- immediate mode -----------------------------------------------------
    def admit(self, spec: TenantSpec, *, at: Optional[float] = None) -> bool:
        """Try to admit ``spec`` now; on failure it parks in the wait queue.
        Returns True when the tenant holds a lease on return."""
        self._validate(spec)
        t = self.clock if at is None else at
        ev = Event(time=t, kind=EventKind.ARRIVAL, tenant=spec.name,
                   payload={"spec": spec})
        self._handle(ev, t)
        self._post_event(ev)
        return spec.name in self.specs

    def depart(self, name: str, *, at: Optional[float] = None) -> None:
        t = self.clock if at is None else at
        ev = Event(time=t, kind=EventKind.DEPARTURE, tenant=name)
        self._handle(ev, t)
        self._post_event(ev)

    def resize_request(self, name: str, n_cores: int, *,
                       at: Optional[float] = None) -> None:
        t = self.clock if at is None else at
        ev = Event(time=t, kind=EventKind.RECONFIG, tenant=name,
                   payload={"n_cores": n_cores, "mode": None})
        self._handle(ev, t)
        self._post_event(ev)

    def fail_core(self, core: int, *, at: Optional[float] = None,
                  duration: Optional[float] = None) -> FaultSpec:
        """Immediate-mode core death (tests / live serving): handle the
        FAILURE now; schedule the repair only if ``duration`` is given."""
        t = self.clock if at is None else at
        fault = FaultSpec(time=t, kind=FaultKind.CORE_DEATH, fid=-1,
                          core=core, duration=duration)
        ev = Event(time=t, kind=EventKind.FAILURE, payload={"fault": fault})
        self._handle(ev, t)
        self._post_event(ev)
        if duration is not None:
            self.queue.schedule(EventKind.RECOVERY, t + duration, fault=fault)
        return fault

    def recover_core(self, core: int, *, at: Optional[float] = None) -> None:
        """Immediate-mode repair of a core failed via :meth:`fail_core`."""
        t = self.clock if at is None else at
        fault = FaultSpec(time=t, kind=FaultKind.CORE_DEATH, fid=-1, core=core)
        ev = Event(time=t, kind=EventKind.RECOVERY, payload={"fault": fault})
        self._handle(ev, t)
        self._post_event(ev)

    # -- queries ------------------------------------------------------------
    def allocation(self) -> Dict[str, int]:
        return {t: lease.n_cores for t, lease in self.pool.leases.items()}

    def kv_allocation(self) -> Dict[str, int]:
        return dict(self.pool.kv_leases)

    def waiting_tenants(self) -> List[str]:
        return [s.name for s in self.waiting]

    # -- the loop -----------------------------------------------------------
    def run(self, horizon: float) -> Dict[str, Any]:
        """Handle every queued event with ``time <= horizon`` in order,
        advancing the executor's simulation between events, then advance to
        ``horizon``.  Returns ``executor.metrics()`` when available.

        The outer loop repeats because advancing can *generate* events: an
        executor finishing open-loop requests reports them through
        ``completion_sink``, and those COMPLETION events (stamped at their
        completion times, possibly before the clock) must still be handled
        within the horizon."""
        if hasattr(self.executor, "begin"):
            self.executor.begin(horizon)
        if self.probe_interval:
            t = self.clock + self.probe_interval
            while t <= horizon + 1e-12:
                self.schedule_probe(at=t)
                t += self.probe_interval
        while True:
            while self.queue and self.queue.next_time() <= horizon:
                ev = self.queue.pop()
                t = max(ev.time, self.clock)
                self.executor.advance(t)
                self.clock = t
                self._handle(ev, t)
                self._post_event(ev)
            self.executor.advance(horizon)
            self.clock = max(self.clock, horizon)
            if not (self.queue and self.queue.next_time() <= horizon):
                break
        if hasattr(self.executor, "metrics"):
            return self.executor.metrics()
        return {}

    # -- event handling -----------------------------------------------------
    def _post_event(self, ev: Event) -> None:
        self.pool.check_isolation()
        self.pool.check_bandwidth()
        self.pool.check_kv_quota()
        self.pool.check_health()
        self.trace.append(ev)
        if self._tracer.enabled:
            track = ev.tenant if ev.tenant is not None else "hypervisor"
            self._tracer.instant(ev.kind.value, track, ts=ev.time,
                                 args={"tenant": ev.tenant})
        self._reg.counter(f"hypervisor.events.{ev.kind.value}").inc()
        if self.on_event is not None:
            self.on_event(self, ev)

    def _handle(self, ev: Event, t: float) -> None:
        if ev.kind is EventKind.ARRIVAL:
            spec: TenantSpec = ev.payload["spec"]
            if spec.name in self.specs:
                # re-submission of a resident: an updated contract, not a
                # second lease (pool.alloc would reject the duplicate name)
                resident = self.specs[spec.name]
                resident.requested_cores = spec.requested_cores
                resident.min_cores = spec.min_cores
                resident.priority = spec.priority
                resident.weight = spec.weight
                resident.requested_kv_pages = spec.requested_kv_pages
                resident.min_kv_pages = spec.min_kv_pages
                if not self._drain_waiting(t):
                    self._rebalance(t)
                return
            # a re-submitted waiter replaces its stale queue entry
            self.waiting = [w for w in self.waiting if w.name != spec.name]
            spec.arrived_at = t
            # FIFO fairness: an arrival never jumps a non-empty wait queue
            # (backfill allows it — that is the point; EASY allows it only
            # around the head's reservation); preemption is the one
            # exception, since it outranks the queue by priority
            jumped = self.admission == "fifo" and bool(self.waiting)
            if not (not jumped and self._try_admit(
                spec, t, reserve=self._head_reservation())
            ) and not (
                self.preemptive and self._try_preempt(spec, t, try_free=jumped)
            ):
                self.waiting.append(spec)
        elif ev.kind is EventKind.DEPARTURE:
            name = ev.tenant
            if name in self.specs:
                del self.specs[name]
                self.executor.exec_remove(name, t)
                # admitting a waiter re-applies the policy over the full new
                # tenant set, so residents are resized exactly once; only
                # rebalance separately when nobody could be admitted
                if not self._drain_waiting(t):
                    self._rebalance(t)
            else:
                self.waiting = [w for w in self.waiting if w.name != name]
                self._displaced_at.pop(name, None)
                self._retry_backoff.pop(name, None)
        elif ev.kind is EventKind.RECONFIG:
            name = ev.tenant
            if name in self.specs:
                n = ev.payload.get("n_cores")
                if n is not None:
                    self.specs[name].requested_cores = n
                mode = ev.payload.get("mode")
                if not self._drain_waiting(t, mode=mode):
                    self._rebalance(t, mode=mode)
        elif ev.kind is EventKind.PROBE:
            self.executor.probe(t)
        elif ev.kind is EventKind.REQUEST:
            record: RequestRecord = ev.payload["record"]
            if ev.tenant in self.specs and hasattr(self.executor, "exec_request"):
                self.executor.exec_request(ev.tenant, record, t)
            else:
                # tenant still waiting for admission (or untracked): hold the
                # request; it is delivered the moment the tenant is admitted
                self._request_backlog.setdefault(ev.tenant, []).append(record)
        elif ev.kind is EventKind.COMPLETION:
            rec = ev.payload.get("record")
            if rec is not None:
                self.completion_log.append(rec)
                lat = getattr(rec, "latency", None)
                if lat is not None:
                    self._reg.histogram(
                        "hypervisor.request_latency_s",
                        rec.tenant).record(lat)
        elif ev.kind is EventKind.FAILURE:
            self._handle_failure(ev.payload["fault"], t)
        elif ev.kind is EventKind.RECOVERY:
            self._handle_recovery(ev, t)

    # -- fault handling -----------------------------------------------------
    def _handle_failure(self, fault: FaultSpec, t: float) -> None:
        """Deliver one fault.  ``CORE_DEATH`` shrinks the placeable pool and
        displaces the owning tenant inside this very event, so the
        ``check_health`` invariant holds at the event boundary; the blast
        radius is exactly the tenants leasing the failed core — nobody else
        is resized or touched here."""
        self.fault_log.append(fault)
        if fault.kind is FaultKind.CORE_DEATH:
            owner = self.pool.mark_failed(fault.core)
            if hasattr(self.executor, "exec_fault"):
                self.executor.exec_fault(fault, t)
            if owner is not None and owner in self.specs:
                self._displace(owner, t)
        else:
            # CORE_SLOW / KV_CORRUPT: no placement change — detection is the
            # straggler-probe / serving-guard path inside the executor
            if hasattr(self.executor, "exec_fault"):
                self.executor.exec_fault(fault, t)

    def _displace(self, name: str, t: float) -> None:
        """Pull a tenant off failed hardware: release its lease through the
        eviction path (generated work survives — parked requests / kept
        live state) and re-place it on the healthy remainder.  Unlike a
        preemption this is not charged to ``preemptions`` — the tenant did
        nothing wrong.  On failure it parks at the *head* of the wait queue
        with an exponential-backoff retry timer."""
        spec = self.specs.pop(name)
        if hasattr(self.executor, "exec_evict"):
            self.executor.exec_evict(name, t)
        else:
            self.executor.exec_remove(name, t)
        self._displaced_at.setdefault(name, t)
        if not self._try_admit(spec, t):
            self.waiting.insert(0, spec)
            self._schedule_retry(name, t)

    def _schedule_retry(self, name: str, t: float) -> None:
        backoff = self._retry_backoff.get(name, self.fault_retry_backoff)
        self.queue.schedule(EventKind.RECOVERY, t + backoff,
                            tenant=name, retry=True)
        self._retry_backoff[name] = backoff * 2.0

    def _handle_recovery(self, ev: Event, t: float) -> None:
        if ev.payload.get("retry"):
            # backoff retry for a displaced tenant still waiting
            name = ev.tenant
            if name in self.specs or name not in self._displaced_at:
                return                      # already re-placed (or departed)
            self._drain_waiting(t)
            if name not in self.specs and \
                    any(w.name == name for w in self.waiting):
                self._schedule_retry(name, t)
            return
        fault: FaultSpec = ev.payload["fault"]
        if hasattr(self.executor, "exec_recover"):
            self.executor.exec_recover(fault, t)
        if fault.kind is FaultKind.CORE_DEATH and fault.core is not None:
            self.pool.mark_recovered(fault.core)
            # repaired capacity goes straight back to work
            if not self._drain_waiting(t):
                self._rebalance(t)

    def _current(self) -> Dict[str, int]:
        return {
            name: lease.n_cores
            for name, lease in self.pool.leases.items()
            if name in self.specs
        }

    def _policy_ctx(self, tenants: List[TenantSpec], t: float) -> PolicyContext:
        # policies plan over the HEALTHY pool: a decision that targets a
        # failed core would bounce off placement anyway — better to degrade
        # the split than to fail the apply
        return PolicyContext(
            self.pool.n_healthy, tenants, self._current(), t,
            latency=getattr(self.executor, "estimate_latency", None),
            n_kv_pages=self.pool.n_kv_pages,
            current_kv={n: p for n, p in self.pool.kv_leases.items()
                        if n in self.specs},
            shared_kv_pages={n: p for n, p in self.pool.shared_kv.items()
                             if n in self.specs},
        )

    def _flush_backlog(self, name: str, t: float) -> None:
        backlog = self._request_backlog.pop(name, None)
        if backlog and hasattr(self.executor, "exec_request"):
            for record in backlog:
                self.executor.exec_request(name, record, t)

    def _try_admit(self, spec: TenantSpec, t: float,
                   mode: Optional[SwitchMode] = None,
                   reserve: tuple = (0, 0)) -> bool:
        reserve_cores, reserve_kv = reserve
        candidates = list(self.specs.values()) + [spec]
        ctx = self._policy_ctx(candidates, t)
        targets = self.policy(ctx)
        floor = max(spec.min_cores, 1)
        if targets.get(spec.name, 0) < floor:
            return False
        for s in self.specs.values():
            if targets.get(s.name, 0) < max(s.min_cores, 1):
                return False  # admitting would starve a resident below floor
        if reserve_cores > 0 and \
                self.pool.n_cores - sum(targets.values()) < reserve_cores:
            return False  # EASY reservation: the wait-queue head's cores
        # memory dimension: both the newcomer and every resident must keep
        # their kv-page floor under the proposed split
        kv_targets = self.kv_policy(ctx, targets)
        if kv_targets.get(spec.name, 0) < spec.min_kv_pages:
            return False
        for s in self.specs.values():
            if kv_targets.get(s.name, 0) < s.min_kv_pages:
                return False
        if reserve_kv > 0 and \
                self.pool.n_kv_pages - sum(kv_targets.values()) < reserve_kv:
            return False  # EASY reservation: the head's kv-page floor
        self._apply(targets, t, admit={spec.name: spec}, mode=mode,
                    kv_targets=kv_targets)
        self.specs[spec.name] = spec
        self._flush_backlog(spec.name, t)
        if spec.name in self._displaced_at:
            # a fault-displaced tenant is back on cores: stamp its recovery
            t0 = self._displaced_at.pop(spec.name)
            self._retry_backoff.pop(spec.name, None)
            self.recovery_log.append({
                "tenant": spec.name, "failed_at": t0, "recovered_at": t,
                "recovery_latency": t - t0,
            })
            # the displaced→re-admitted window as one span on the tenant's
            # track, in event time (matches the instants _post_event emits)
            self._tracer.complete("recovery", spec.name, t0, t - t0)
            self._reg.histogram("hypervisor.recovery_latency_s",
                                spec.name).record(t - t0)
        return True

    def _evict(self, victim: TenantSpec, t: float) -> None:
        """Revoke a resident's lease for a higher-priority arrival.  The
        executor charges the context-switch cost (``exec_evict``) and parks
        the victim's queued requests; its spec is NOT re-queued here — the
        caller decides where it lands."""
        del self.specs[victim.name]
        if hasattr(self.executor, "exec_evict"):
            self.executor.exec_evict(victim.name, t)
        else:
            self.executor.exec_remove(victim.name, t)
        self.preemptions.append(victim.name)

    def _slo_slack(self, spec: TenantSpec) -> float:
        """Headroom between a resident's SLO and its estimated queue-adjusted
        latency at its *current* lease.  Tenants without an SLO (or without a
        latency model) report infinite slack — evicting them costs no
        attainment.  A tenant already blowing its SLO reports -inf."""
        est_fn = getattr(self.executor, "estimate_latency", None)
        if est_fn is None or spec.latency_slo is None:
            return float("inf")
        lease = self.pool.lease_of(spec.name)
        k = lease.n_cores if lease is not None else max(spec.min_cores, 1)
        est = est_fn(spec, k)
        if est is None:
            return float("inf")
        return spec.latency_slo - queueing_latency(est, spec.arrival_rate)

    def _try_preempt(self, spec: TenantSpec, t: float, *,
                     try_free: bool = False) -> bool:
        """Evict strictly-lower-priority residents until ``spec`` fits —
        lowest priority tier first, and *within* a tier the resident with
        the largest SLO slack first (it has the most latency headroom to
        give up; no-SLO tenants count as infinitely slack).  Ties break
        deterministically on youngest arrival, then name.  Victims re-queue
        at the head of the wait queue (earliest arrival first).  If even
        evicting every lower-priority resident cannot seat ``spec``, the
        evictions are rolled back: each victim is restored at exactly its
        pre-eviction core and kv-page lease (the resources it held are
        still free, so the restore cannot fail) — though it has paid the
        context switch."""
        if max(spec.min_cores, 1) > self.pool.n_healthy:
            return False    # could never fit even on an empty (healthy)
                            # pool: don't charge residents for a doomed try
        victims = sorted(
            (s for s in self.specs.values() if s.priority < spec.priority),
            key=lambda s: (s.priority, -self._slo_slack(s),
                           -s.arrived_at, s.name),
        )
        if not victims:
            return False
        # priority outranks queue fairness: when FIFO queue-jumping skipped
        # the regular admission attempt (try_free), seat the arrival from
        # free capacity first — never evict when admission alone works.  In
        # the non-jumped path _handle already tried (and failed) exactly
        # this admission, so re-evaluating the policy would be pure waste.
        if try_free and self._try_admit(spec, t):
            return True
        sizes: Dict[str, int] = {}
        kv_sizes: Dict[str, int] = {}
        evicted: List[TenantSpec] = []
        admitted = False
        for v in victims:
            sizes[v.name] = self.pool.lease_of(v.name).n_cores
            kv_sizes[v.name] = self.pool.kv_lease_of(v.name)
            self._evict(v, t)
            evicted.append(v)
            if self._try_admit(spec, t):
                admitted = True
                break
        by_arrival = sorted(evicted, key=lambda s: (s.arrived_at, s.name))
        if not admitted:
            for i, v in enumerate(by_arrival):      # exact rollback
                try:
                    self.executor.exec_admit(v, sizes[v.name], t)
                except HRPError as e:
                    # the pool shrank under us mid-rollback (e.g. a core
                    # failed between eviction and restore): exact
                    # restoration is impossible.  Abort LOUDLY but leave the
                    # invariants clean — every not-yet-restored victim parks
                    # at the head of the wait queue (its requests stay in
                    # the backlog / parked by the executor), nothing holds a
                    # partial lease.
                    for w in reversed(by_arrival[i:]):
                        self.waiting.insert(0, w)
                        self._displaced_at.setdefault(w.name, t)
                    raise HRPError(
                        f"preemption rollback could not restore "
                        f"{v.name} at {sizes[v.name]} cores (pool shrank "
                        f"mid-rollback); {len(by_arrival) - i} victim(s) "
                        f"parked at the wait-queue head") from e
                self.specs[v.name] = v
                if kv_sizes[v.name]:
                    self.pool.set_kv_lease(v.name, kv_sizes[v.name])
                self._flush_backlog(v.name, t)
            return False
        for v in reversed(by_arrival):
            self.waiting.insert(0, v)
        return True

    def _rebalance(self, t: float, mode: Optional[SwitchMode] = None) -> None:
        if not self.specs:
            return
        ctx = self._policy_ctx(list(self.specs.values()), t)
        targets = self.policy(ctx)
        self._apply(targets, t, mode=mode,
                    kv_targets=self.kv_policy(ctx, targets))

    def _apply_kv(self, kv_targets: Dict[str, int], t: float) -> None:
        """Carry the memory-dimension decision out: shrinks first (they free
        the pages the grows need — the same discipline as core resizes), and
        notify the executor through the optional ``exec_kv_resize`` hook."""
        current = dict(self.pool.kv_leases)
        changes = [
            (name, pages) for name, pages in sorted(kv_targets.items())
            if name in self.specs and self.pool.lease_of(name) is not None
            and pages != current.get(name, 0)
        ]
        notify = getattr(self.executor, "exec_kv_resize", None)
        for shrink_pass in (True, False):
            for name, pages in changes:
                if (pages < current.get(name, 0)) is not shrink_pass:
                    continue
                self.pool.set_kv_lease(name, pages)
                if notify is not None:
                    notify(name, pages, t)

    def _apply(self, targets: Dict[str, int], t: float, *,
               admit: Optional[Dict[str, TenantSpec]] = None,
               mode: Optional[SwitchMode] = None,
               kv_targets: Optional[Dict[str, int]] = None) -> None:
        """Carry a policy decision out through the executor: shrinks first
        (they free the cores the grows need), then grows, then admissions,
        then kv-page lease changes (which need the admitted core leases)."""
        admit = admit or {}
        mode = mode or self.switch_mode
        current = {
            name: lease.n_cores for name, lease in self.pool.leases.items()
        }
        resident = [n for n in sorted(targets) if n in current and n not in admit]
        for name in resident:
            if 0 < targets[name] < current[name]:
                self.executor.exec_resize(name, targets[name], t, mode)
        for name in resident:
            # >= not >: an equal target must still reach the executor so a
            # stale deferred (task-level) decision gets dropped
            if targets[name] >= current[name]:
                self.executor.exec_resize(name, targets[name], t, mode)
        for name, spec in admit.items():
            self.executor.exec_admit(spec, targets[name], t)
        if kv_targets is not None:
            # admissions just landed: record them before the kv pass so the
            # admitted tenant's pages pass the holds-a-core-lease check
            for name, spec in admit.items():
                self.specs.setdefault(name, spec)
            self._apply_kv(kv_targets, t)

    def _head_reservation(self) -> tuple:
        """EASY start-time guarantee: while the wait-queue head is blocked,
        anyone admitted past it must leave the head's floor in free cores
        AND free kv pages — capacity released by departures *accumulates*
        for the head instead of being endlessly re-consumed by backfill
        churn, so the head starts as soon as enough has drained (in
        whichever dimension is binding).  Plain ``backfill`` reserves
        nothing (that is exactly its starvation mode).  Returns
        ``(cores, kv_pages)``."""
        if self.admission != "easy" or not self.waiting:
            return (0, 0)
        head = self.waiting[0]
        return (max(head.min_cores, 1), max(head.min_kv_pages, 0))

    def _drain_waiting(self, t: float, mode: Optional[SwitchMode] = None) -> int:
        """Admit from the wait queue.  ``fifo``: head-of-line — stop at the
        first waiter that doesn't fit.  ``backfill``: one deterministic pass
        over the whole queue in order, so a small tenant may be admitted past
        a blocked head (EASY-style backfilling without reservations — the
        head keeps its queue position and is always offered capacity first,
        but churn can starve it).  ``easy``: the same walk, except everyone
        admitted past a blocked head must respect the head's reservation
        (:meth:`_head_reservation`) — the regression the plain backfill
        test suite pins down.  Returns how many were admitted — each
        admission already re-applied the policy over the full tenant set,
        so the caller skips its own rebalance when this is non-zero."""
        admitted = 0
        i = 0
        while i < len(self.waiting):
            reserve = self._head_reservation() if i > 0 else (0, 0)
            if self._try_admit(self.waiting[i], t, mode=mode,
                               reserve=reserve):
                self.waiting.pop(i)
                admitted += 1
            elif self.admission in ("backfill", "easy"):
                i += 1
            else:
                break
        return admitted
