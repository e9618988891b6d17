"""Virtualized multi-tenant execution engine (discrete-event).

Copy of ``repro.core.vengine`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

Ties the whole paper together: the HRP leases cores to tenants, the two-stage
compiler produces per-core schedules, the two-level IDM controllers manage
context switches and layer barriers, and the latency simulator supplies
per-layer core times.  Because leases are disjoint and every core owns its
off-chip port, tenants' timelines are independent — each tenant's clock
advances separately, which *is* the isolation property (a small optional
DDR-group crosstalk factor models the arbiter of §4.2.2 when tenants share a
bank, bounded well under the paper's 1% deviation).

Since the Hypervisor refactor the engine is an **executor** for the global
event loop (:class:`repro_torch.core.hypervisor.Hypervisor`): the hypervisor pops
time-ordered arrival/departure/reconfig/probe events, calls :meth:`advance`
to bring every tenant's clock to the event's timestamp, and carries policy
decisions out through :meth:`exec_admit` / :meth:`exec_resize` /
:meth:`exec_remove`.  :meth:`run` is the degenerate case — a ``no_realloc``
hypervisor with an empty event queue — and reproduces the seed engine's
per-tenant independent clocks exactly.

Supports:
  * closed-loop inference (each tenant re-issues back-to-back requests),
  * **open-loop inference** (requests arrive on their own seeded clock via
    :class:`~repro_torch.core.events.PoissonTraffic` / ``TraceTraffic``; a tenant
    with an empty inbox idles instead of re-issuing, and every served
    request's arrival→start→completion times are stamped on its shared
    :class:`~repro_torch.core.events.RequestRecord` — the latency-SLO substrate),
  * hypervisor reconfiguration at a global time (task- or layer-level switch,
    with measured dynamic-recompile + transfer cost added to the timeline),
  * dynamic tenant arrival/departure with policy-driven pool rebalancing,
  * **preemptive eviction** (``exec_evict``: the displaced tenant pays one
    context switch, its queued requests park and follow it back in on
    re-admission, and its metrics survive in ``history``),
  * straggler injection (per-core slowdown) and mitigation (weighted
    re-allocation of the remaining layers via the dynamic compiler), either
    inline per layer or via hypervisor-scheduled straggler probes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from .dispatch import ContextSwitchController, MultiCoreSyncController, SwitchMode
from .dynamic_compiler import DynamicCompiler, Schedule
from .events import RequestRecord
from .hwmodel import HardwareModel
from .hrp import ResourcePool
from .hypervisor import Hypervisor, TenantSpec
from .latency_sim import simulate
from .static_compiler import StaticArtifact


@dataclasses.dataclass
class ReconfigRequest:
    t_request: float
    n_cores: int
    mode: SwitchMode = SwitchMode.LAYER_LEVEL


@dataclasses.dataclass
class TenantMetrics:
    completions: List[float] = dataclasses.field(default_factory=list)
    ctx_switches: int = 0
    ctx_overhead: float = 0.0
    rebalances: int = 0
    # open-loop request accounting
    arrivals: int = 0
    requests: List[RequestRecord] = dataclasses.field(default_factory=list)
    evictions: int = 0
    dropped: int = 0          # shed before start: deadline already passed

    def throughput(self, horizon: float) -> float:
        return len(self.completions) / horizon if horizon > 0 else 0.0

    @property
    def latencies(self) -> List[float]:
        return [r.latency for r in self.requests if r.latency is not None]

    def slo_attainment(self) -> Optional[float]:
        """Fraction of *offered* requests served within their SLO.  Unserved
        arrivals count against attainment; None when no requests arrived."""
        if self.arrivals == 0:
            return None
        return sum(1 for r in self.requests if r.slo_met) / self.arrivals


@dataclasses.dataclass
class _Tenant:
    name: str
    artifact: StaticArtifact
    dyn: DynamicCompiler
    schedule: Schedule
    clock: float = 0.0
    layer_idx: int = 0
    inference_id: int = 0
    pending: List[ReconfigRequest] = dataclasses.field(default_factory=list)
    metrics: TenantMetrics = dataclasses.field(default_factory=TenantMetrics)
    # open-loop request state: once any request is submitted the tenant stops
    # re-issuing back-to-back inferences and only serves its inbox
    open_loop: bool = False
    inbox: List[RequestRecord] = dataclasses.field(default_factory=list)
    current_req: Optional[RequestRecord] = None
    # speeds the last probe-driven rebalance compiled for (avoids recompiling
    # the same weighted schedule on every probe tick)
    probe_speeds: Optional[List[float]] = None
    # simulate() results per (hw name, layer) for the *current* schedule —
    # schedules and their chains are immutable, so per-layer times are too;
    # the cache is cleared whenever the schedule is replaced (id()-based keys
    # would risk stale hits after CPython address reuse and grow unboundedly
    # under policy-driven recompile churn).
    _layer_cache: Dict[Tuple[str, int], Dict[int, float]] = dataclasses.field(
        default_factory=dict
    )


class VirtualEngine:
    def __init__(
        self,
        pool: ResourcePool,
        hw_unit: HardwareModel,
        *,
        ddr_crosstalk: float = 0.004,
        straggler_threshold: float = 1.5,
        mitigate_stragglers: bool = False,
    ) -> None:
        self.pool = pool
        self.hw = hw_unit
        self.ddr_crosstalk = ddr_crosstalk
        self.straggler_threshold = straggler_threshold
        self.mitigate_stragglers = mitigate_stragglers
        self.sync = MultiCoreSyncController()
        self.ctx = ContextSwitchController()
        self.tenants: Dict[str, _Tenant] = {}
        self.core_slowdown: Dict[int, float] = {}
        # metrics of departed tenants survive removal (event-driven runs);
        # a re-admitted (previously evicted) tenant resumes its old record
        self.history: Dict[str, TenantMetrics] = {}
        # queued open-loop requests of evicted tenants, re-attached on
        # re-admission (preemption must not drop offered load)
        self._parked_requests: Dict[str, List[RequestRecord]] = {}
        # invoked with each finished RequestRecord (the hypervisor wires this
        # to COMPLETION-event scheduling)
        self.completion_sink: Optional[Callable[[RequestRecord], None]] = None
        # latency_slo demand model caches: per-artifact DynamicCompiler (also
        # keeps the artifact alive so the id() key cannot be reused) and the
        # estimated single-inference latency per (artifact, core count)
        self._est_dyn: Dict[int, DynamicCompiler] = {}
        self._lat_cache: Dict[Tuple[int, int], float] = {}
        # latest deferred (task-level) hypervisor decision per tenant, so a
        # newer policy decision supersedes a not-yet-applied one
        self._deferred_hv: Dict[str, ReconfigRequest] = {}
        self._horizon = float("inf")
        self._max_inferences: Optional[int] = None

    # -- admission ------------------------------------------------------------
    def admit(self, name: str, artifact: StaticArtifact, n_cores: int,
              *, at: float = 0.0) -> None:
        lease = self.pool.alloc(name, n_cores)
        dyn = DynamicCompiler(artifact)
        schedule = dyn.compile(lease.cores)
        self.sync.configure(name, set(lease.cores))
        metrics = self.history.pop(name, None) or TenantMetrics()
        tenant = _Tenant(name, artifact, dyn, schedule, clock=at, metrics=metrics)
        parked = self._parked_requests.pop(name, None)
        if parked:
            tenant.inbox = parked
            tenant.open_loop = True
        self.tenants[name] = tenant

    def remove(self, name: str) -> None:
        tenant = self.tenants.pop(name)
        self.history[name] = tenant.metrics
        self._deferred_hv.pop(name, None)
        self.pool.release(name)
        self.sync.deconfigure(name)

    def request_resize(
        self, name: str, n_cores: int, *, at: float = 0.0,
        mode: SwitchMode = SwitchMode.LAYER_LEVEL,
    ) -> None:
        self.tenants[name].pending.append(ReconfigRequest(at, n_cores, mode))
        self.tenants[name].pending.sort(key=lambda r: r.t_request)
        self.ctx.request_switch(name, mode)

    def submit_request(self, name: str, record: RequestRecord) -> None:
        """Queue one open-loop request; the tenant stops closed-loop
        re-issuing the moment its first request arrives."""
        tenant = self.tenants[name]
        tenant.open_loop = True
        tenant.metrics.arrivals += 1
        tenant.inbox.append(record)

    def metrics(self) -> Dict[str, TenantMetrics]:
        out = dict(self.history)
        out.update({n: t.metrics for n, t in self.tenants.items()})
        return out

    @staticmethod
    def _set_schedule(tenant: _Tenant, schedule: Schedule) -> None:
        tenant.schedule = schedule
        tenant._layer_cache.clear()

    # -- hypervisor executor protocol ------------------------------------------
    def begin(self, horizon: float) -> None:
        self._horizon = horizon

    def exec_admit(self, spec: TenantSpec, n_cores: int, at: float) -> None:
        self.admit(spec.name, spec.artifact, n_cores, at=at)
        if spec.open_loop:
            self.tenants[spec.name].open_loop = True

    def _drop_deferred(self, tenant: _Tenant) -> None:
        stale = self._deferred_hv.pop(tenant.name, None)
        if stale is not None and stale in tenant.pending:
            tenant.pending.remove(stale)

    def exec_resize(self, name: str, n_cores: int, at: float,
                    mode: SwitchMode = SwitchMode.LAYER_LEVEL) -> None:
        """Apply a hypervisor reallocation decision.  ``advance`` has already
        brought the tenant to a layer boundary at clock >= ``at``, so a
        layer-level switch applies synchronously (context = layer index,
        §4.2.1).  Under task-level mode only *grows* wait for the task
        boundary (parked as a pending request, superseding any earlier
        deferred decision); **shrinks always preempt at the layer boundary**
        — a deferred shrink would leave the pool over-committed against the
        admissions and grows the same policy decision granted, which is the
        bounded-latency argument for the layer-level switch in §4.2.1."""
        tenant = self.tenants[name]
        lease = self.pool.lease_of(name)
        if lease is not None and lease.n_cores == n_cores:
            self._drop_deferred(tenant)  # target already met: decision stale
            return
        if lease is not None and n_cores < lease.n_cores:
            mode = SwitchMode.LAYER_LEVEL
        self.ctx.request_switch(name, mode)
        n_layers = len(tenant.artifact.workload)
        ctx = self.ctx.boundary(name, tenant.layer_idx, n_layers, tenant.inference_id)
        if ctx is None and mode is SwitchMode.TASK_LEVEL:
            self._drop_deferred(tenant)
            req = ReconfigRequest(at, n_cores, mode)
            self._deferred_hv[name] = req
            tenant.pending.append(req)
            tenant.pending.sort(key=lambda r: r.t_request)
            return
        self._drop_deferred(tenant)
        lease = self.pool.resize(name, n_cores)
        self.sync.configure(name, set(lease.cores))
        schedule = tenant.dyn.compile(lease.cores)
        cost = tenant.dyn.context_switch_cost(schedule, self.hw)
        tenant.clock = max(tenant.clock, at) + cost["t_context"]
        self._set_schedule(tenant, schedule)
        tenant.probe_speeds = None
        tenant.metrics.ctx_switches += 1
        tenant.metrics.ctx_overhead += cost["t_context"]
        if ctx is not None:
            tenant.layer_idx = ctx.layer_idx  # resume from recorded context

    def exec_remove(self, name: str, at: float) -> None:
        self.remove(name)

    def exec_request(self, name: str, record: RequestRecord, at: float) -> None:
        self.submit_request(name, record)

    def exec_evict(self, name: str, at: float) -> None:
        """Preemptive eviction: unlike a voluntary departure the tenant pays
        one context switch (its state must be drained off the cores, Eq. 7)
        before the lease is revoked; the charge lands in its metrics — which
        survive in ``history`` — and its queued/in-flight requests park until
        re-admission (an aborted in-flight request restarts from layer 0)."""
        tenant = self.tenants[name]
        cost = tenant.dyn.context_switch_cost(tenant.schedule, self.hw)
        tenant.clock = max(tenant.clock, at) + cost["t_context"]
        tenant.metrics.ctx_switches += 1
        tenant.metrics.ctx_overhead += cost["t_context"]
        tenant.metrics.evictions += 1
        if tenant.current_req is not None:
            tenant.current_req.t_start = None
            tenant.inbox.insert(0, tenant.current_req)
            tenant.current_req = None
        tenant.layer_idx = 0
        if tenant.inbox:
            self._parked_requests[name] = tenant.inbox
        self.remove(name)

    def exec_fault(self, fault, at: float) -> None:
        """A :class:`~repro_torch.core.faults.FaultSpec` fires.  ``CORE_SLOW``
        degrades the core by its factor — *visible to straggler probes*
        (the detection path: a probed tenant rebalances its remaining
        layers off the sick core).  ``CORE_DEATH`` needs no engine-side
        state: the hypervisor displaces the owner through ``exec_evict`` in
        the same event, and a failed free core is simply unplaceable."""
        from .faults import FaultKind
        if fault.kind is FaultKind.CORE_SLOW and fault.core is not None:
            self.core_slowdown[fault.core] = max(
                self.core_slowdown.get(fault.core, 1.0), fault.factor)

    def exec_recover(self, fault, at: float) -> None:
        """The fault's repair lands: clear the slowdown so the next probe
        sees a healthy core again (probe_speeds memo invalidates naturally
        — speeds change, so the weighted schedule recompiles)."""
        from .faults import FaultKind
        if fault.kind is FaultKind.CORE_SLOW and fault.core is not None:
            self.core_slowdown.pop(fault.core, None)

    def estimate_latency(self, spec: TenantSpec, n_cores: int) -> float:
        """Estimated single-inference latency of ``spec`` on ``n_cores``
        cores — the ``latency_slo`` policy's demand model.  Crosstalk-free
        and placement-independent (schedule latency depends only on the core
        count), memoized per (artifact, count); repeated policy decisions
        are dictionary lookups."""
        if n_cores < 1:
            return float("inf")
        artifact = spec.artifact
        key = (id(artifact), n_cores)
        cached = self._lat_cache.get(key)
        if cached is None:
            dyn = self._est_dyn.get(id(artifact))
            if dyn is None:
                resident = self.tenants.get(spec.name)
                dyn = (resident.dyn if resident is not None
                       and resident.artifact is artifact
                       else DynamicCompiler(artifact))
                self._est_dyn[id(artifact)] = dyn
            cached = dyn.compile(list(range(n_cores))).estimated_latency(self.hw)
            self._lat_cache[key] = cached
        return cached

    def probe(self, at: float) -> int:
        """Pool-wide straggler probe (hypervisor-scheduled): re-balance any
        tenant whose lease contains a core slower than ``straggler_threshold``
        x the median, via the weighted dynamic compiler."""
        rebalanced = 0
        for tenant in self.tenants.values():
            metric = {c: self.core_slowdown.get(c, 1.0)
                      for c in tenant.schedule.core_ids}
            if self._rebalance_if_straggling(tenant, metric):
                rebalanced += 1
        return rebalanced

    # -- straggler detection / weighted rebalance (shared by the inline
    # per-layer path and the hypervisor probe path) ---------------------------
    def _rebalance_if_straggling(self, tenant: _Tenant,
                                 metric: Dict[int, float]) -> bool:
        """``metric`` is any per-core load signal (per-layer times inline,
        slowdown factors for probes); when one core exceeds threshold x
        median, recompile with weights so it receives proportionally less
        work.  Skips when already balanced for the current speeds."""
        if len(metric) < 2:
            return False
        values = sorted(metric.values())
        median = values[len(values) // 2]
        if median <= 0 or max(values) <= self.straggler_threshold * median:
            return False
        speeds = [1.0 / self.core_slowdown.get(c, 1.0)
                  for c in tenant.schedule.core_ids]
        if tenant.probe_speeds == speeds:
            return False
        self._set_schedule(
            tenant, tenant.dyn.compile(tenant.schedule.core_ids, core_speeds=speeds)
        )
        tenant.probe_speeds = speeds
        tenant.metrics.rebalances += 1
        return True

    # -- crosstalk -------------------------------------------------------------
    def _tenant_hw(self, tenant: _Tenant) -> HardwareModel:
        """Effective per-core hardware for this tenant: tiny bandwidth loss on
        DDR groups shared with other (active) tenants — §4.2.2 arbiter model."""
        if self.ddr_crosstalk <= 0:
            return self.hw
        lease = self.pool.lease_of(tenant.name)
        if lease is None:
            return self.hw
        g = self.pool.cores_per_ddr
        shared = 0
        for c in lease.cores:
            group = range((c // g) * g, min((c // g + 1) * g, self.pool.n_cores))
            if any(self.pool._owner[x] not in (None, tenant.name) for x in group):
                shared += 1
        frac = shared / max(len(lease.cores), 1)
        return self.hw.with_bandwidth(1.0 - self.ddr_crosstalk * frac)

    # -- one layer step ----------------------------------------------------------
    def _layer_time(self, tenant: _Tenant) -> Tuple[float, Dict[int, float]]:
        hw = self._tenant_hw(tenant)
        li = tenant.layer_idx
        key = (hw.name, li)
        base = tenant._layer_cache.get(key)
        if base is None:
            base = {}
            for local, phys in enumerate(tenant.schedule.core_ids):
                prog = tenant.schedule.per_core_layers[local][li]
                if len(prog) == 0:
                    continue
                base[phys] = simulate(prog, hw)
            tenant._layer_cache[key] = base
        per_core = {
            phys: dt * self.core_slowdown.get(phys, 1.0) for phys, dt in base.items()
        }
        t_layer = (max(per_core.values()) if per_core else 0.0) + hw.sync_latency
        return t_layer, per_core

    def _maybe_mitigate(self, tenant: _Tenant, per_core: Dict[int, float]) -> None:
        if self.mitigate_stragglers:
            self._rebalance_if_straggling(tenant, per_core)

    def _apply_reconfig(self, tenant: _Tenant, req: ReconfigRequest) -> None:
        n_layers = len(tenant.artifact.workload)
        ctx = self.ctx.boundary(
            tenant.name, tenant.layer_idx, n_layers, tenant.inference_id
        )
        if ctx is None and req.mode is SwitchMode.TASK_LEVEL:
            return  # not at task end yet; retry at the next boundary
        lease = self.pool.resize(tenant.name, req.n_cores)
        self.sync.configure(tenant.name, set(lease.cores))
        schedule = tenant.dyn.compile(lease.cores)
        cost = tenant.dyn.context_switch_cost(schedule, self.hw)
        tenant.clock += cost["t_context"]
        self._set_schedule(tenant, schedule)
        tenant.probe_speeds = None
        tenant.metrics.ctx_switches += 1
        tenant.metrics.ctx_overhead += cost["t_context"]
        tenant.pending.remove(req)
        if self._deferred_hv.get(tenant.name) is req:
            del self._deferred_hv[tenant.name]
        if ctx is not None:
            tenant.layer_idx = ctx.layer_idx  # resume from recorded context

    # -- simulation ----------------------------------------------------------------
    def advance(self, until: float) -> None:
        """Advance every tenant's clock to global time ``until`` (layer by
        layer; completions are recorded against the run horizon set by
        :meth:`begin`).  The hypervisor calls this between events."""
        for tenant in list(self.tenants.values()):
            self._advance_tenant(tenant, until)

    def _start_next_request(self, tenant: _Tenant, until: float) -> bool:
        """Dequeue the open-loop tenant's next request, skipping the idle gap
        (its clock jumps to the arrival — idle cores don't do work).  Returns
        False when the inbox is empty: the tenant idles, but still honours
        any due reconfiguration at this (trivially task-level) boundary."""
        while tenant.inbox:
            req = tenant.inbox.pop(0)
            start = max(tenant.clock, req.t_arrival)
            if req.deadline is not None and start > req.deadline:
                # drop policy: the deadline already passed before the
                # request could even start — serving it would burn core
                # time on an answer nobody is waiting for.  The record
                # keeps t_complete=None (counts against attainment) and is
                # stamped dropped so owners can tell shed from starved.
                req.dropped = True
                tenant.metrics.dropped += 1
                tenant.metrics.requests.append(req)
                continue
            req.t_start = start
            tenant.clock = req.t_start
            tenant.current_req = req
            # a request is a whole inference: discard any half-run
            # closed-loop layers left from before the tenant went open-loop
            tenant.layer_idx = 0
            return True
        for req in list(tenant.pending):
            if req.t_request <= until:
                tenant.clock = max(tenant.clock, req.t_request)
                self._apply_reconfig(tenant, req)
                break
        return False

    def _finish_request(self, tenant: _Tenant) -> None:
        req = tenant.current_req
        if req is None:
            return
        req.t_complete = tenant.clock
        tenant.current_req = None
        # same horizon guard as `completions`: a request whose last layer
        # overshoots the run horizon is stamped (the record is ground
        # truth for its owner) but stays out of this run's metrics and
        # COMPLETION events — throughput and attainment count the same set
        if tenant.clock <= self._horizon:
            tenant.metrics.requests.append(req)
            if self.completion_sink is not None:
                self.completion_sink(req)

    def _advance_tenant(self, tenant: _Tenant, until: float) -> None:
        n_layers = len(tenant.artifact.workload)
        while tenant.clock < until:
            if (
                self._max_inferences is not None
                and len(tenant.metrics.completions) >= self._max_inferences
            ):
                break
            if tenant.open_loop and tenant.current_req is None:
                if not self._start_next_request(tenant, until):
                    break
            t_layer, per_core = self._layer_time(tenant)
            tenant.clock += t_layer
            tenant.layer_idx += 1
            if tenant.layer_idx >= n_layers:
                tenant.inference_id += 1
                if tenant.clock <= self._horizon:
                    tenant.metrics.completions.append(tenant.clock)
                self._finish_request(tenant)
            self._maybe_mitigate(tenant, per_core)
            # layer boundary: honour any due reconfiguration request
            # (while layer_idx may still equal n_layers => task boundary)
            for req in list(tenant.pending):
                if req.t_request <= tenant.clock:
                    self._apply_reconfig(tenant, req)
                    break
            if tenant.layer_idx >= n_layers:
                tenant.layer_idx = 0

    def run(
        self, horizon: float, *, max_inferences: Optional[int] = None,
        hypervisor: Optional[Hypervisor] = None,
    ) -> Dict[str, TenantMetrics]:
        """Advance every tenant's clock to ``horizon`` (seconds).

        Runs as the degenerate case of the hypervisor's global event loop: a
        ``no_realloc`` policy over an empty event queue reproduces the seed
        engine's independent per-tenant clocks.  Pass a ``hypervisor`` (built
        with ``executor=self``) to honour its queued arrival/departure/
        reconfiguration events instead.
        """
        self._max_inferences = max_inferences
        hv = hypervisor if hypervisor is not None else Hypervisor(
            self.pool, policy="no_realloc", executor=self,
        )
        hv.run(horizon)
        return self.metrics()

    # -- convenience -----------------------------------------------------------------
    def single_inference_latency(self, name: str) -> float:
        tenant = self.tenants[name]
        total = 0.0
        n_layers = len(tenant.artifact.workload)
        hw = self._tenant_hw(tenant)
        for li in range(n_layers):
            t_layer = 0.0
            for local, _ in enumerate(tenant.schedule.core_ids):
                prog = tenant.schedule.per_core_layers[local][li]
                if len(prog):
                    t_layer = max(t_layer, simulate(prog, hw))
            total += t_layer + hw.sync_latency
        return total
