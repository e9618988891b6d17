"""Tenancy: the paper's virtualization machinery driving torch devices.

Port of ``repro.serving.tenancy``.  The paper's stack maps onto one card so:

  FPGA small core           → a logical core: a fixed group of torch devices
                              (the same device may be repeated, so one H100
                              gives N logical cores, as the reference
                              repeats ``jax.devices()``)
  multi-core HRP            → :class:`VirtualAcceleratorPool` — the port's
                              copy of ``ResourcePool`` bookkeeping, leases
                              mapped to arrays of devices
  instruction frame package → a warmed program for one (program × shape ×
                              lease size): every kernel it reaches is built,
                              loaded and launched once
  static compilation        → :meth:`TwoStageCompiler.static_compile` —
                              example tensors from :class:`TensorSpec`s, one
                              call, one synchronise, for every lease size
  dynamic compilation       → :meth:`TwoStageCompiler.reconfigure` — cache
                              lookup + context migration
  layer-level ctx switch    → caches and slot state moved to the lease's
                              first device (``Tensor.to``); decode resumes
                              at the same token
  DDR-port budget check     → per-device memory admission via
                              ``kv_cache_bytes``: the lease's distinct
                              devices, co-resident tenants summed

Where the reference builds a ``jax.sharding.Mesh``, the port returns a numpy
object array of ``torch.device`` of the same shape (axes ``("data",
"model")`` for :meth:`VirtualAcceleratorPool.mesh_for`, ``("tp",)`` for
``tp_mesh_for``); nothing here uses ``torch.distributed``.  A lease's
logical cores on one card are one device, so placing state by
``state_specs`` checks each spec against the lease's width, as a
``NamedSharding`` would, and moves no byte; a tensor-parallel batcher
splits its own state over the lease's cores
(``ContinuousBatcher.remesh``, driven by :meth:`ServingExecutor.
register_remesh`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dispatch import SwitchMode
from ..core.events import RequestRecord
from ..core.hrp import HRPError, Lease, ResourcePool
from ..core.hypervisor import Hypervisor, TenantSpec
from ..device import resolve_device, tree_to_device
from ..distributed.sharding import P, spec_map
from ..obs import Telemetry
from .kv_cache import kv_cache_bytes, paged_kv_cache_bytes

HBM_BYTES_PER_DEVICE = 80 * 10**9   # H100 SXM, 80 GB (NVIDIA data sheet)


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


class VirtualAcceleratorPool:
    """Device-backed hardware resource pool (paper §4.2.2 on one card).

    ``devices`` defaults to every CUDA device and raises without one; pass
    ``[torch.device("cpu")] * n`` to run the pool on the CPU.  ``kv_pages``
    adds the memory lease dimension: a pool-wide budget of paged-KV cache
    pages the hypervisor may divide among tenants alongside cores (see
    ``repro_torch.core.hrp.ResourcePool.set_kv_lease``).
    """

    def __init__(self, devices: Optional[Sequence] = None, *,
                 devices_per_core: int = 1, cores_per_group: int = 4,
                 kv_pages: int = 0):
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        assert len(devices) % devices_per_core == 0
        self.devices_per_core = devices_per_core
        self.core_devices: List[List[torch.device]] = [
            devices[i * devices_per_core : (i + 1) * devices_per_core]
            for i in range(len(devices) // devices_per_core)
        ]
        # DDR-group budget reused as a memory locality group
        self.pool = ResourcePool(
            n_cores=len(self.core_devices), cores_per_ddr=cores_per_group,
            ddr_port_bits=cores_per_group * 128, core_port_bits=128,
            n_kv_pages=kv_pages,
        )
        # bytes each admitted tenant holds, spread over its lease's devices
        self._admitted_bytes: Dict[str, int] = {}

    @property
    def n_cores(self) -> int:
        return self.pool.n_cores

    def lease(self, tenant: str, n_cores: int) -> Lease:
        return self.pool.alloc(tenant, n_cores)

    def resize(self, tenant: str, n_cores: int) -> Lease:
        return self.pool.resize(tenant, n_cores)

    def release(self, tenant: str) -> None:
        self.pool.release(tenant)
        self._admitted_bytes.pop(tenant, None)

    def mesh_for(self, lease: Lease) -> np.ndarray:
        """The leased cores' devices, ``(n_cores, devices_per_core)``."""
        devs = [d for c in lease.cores for d in self.core_devices[c]]
        return _device_array(devs, (len(lease.cores), self.devices_per_core))

    def tp_mesh_for(self, lease: Lease) -> np.ndarray:
        """Every device of the lease, flat: the width a tensor-parallel
        batcher would shard over (``n_cores * devices_per_core``)."""
        devs = [d for c in lease.cores for d in self.core_devices[c]]
        return _device_array(devs, (len(devs),))

    def lease_devices(self, lease: Lease) -> List[torch.device]:
        """The distinct devices under ``lease``'s cores, in core order."""
        devs: List[torch.device] = []
        for c in lease.cores:
            devs.extend(d for d in self.core_devices[c] if d not in devs)
        return devs

    def _admit(self, lease: Lease, need: int, what: str) -> None:
        """Charge ``need`` bytes, spread evenly over the lease's distinct
        devices, on top of what every other admitted tenant still holding a
        lease keeps on each of them; raise if a device would exceed its
        memory, else record the tenant's bytes until :meth:`release`.

        Deviation from the reference (ROADMAP.md Queue 3): it divides by
        ``len(lease.cores) * devices_per_core`` and ignores co-resident
        tenants, so on a card whose logical cores all repeat one device an
        n-core lease would be credited n devices' memory."""
        devs = self.lease_devices(lease)
        share = need / len(devs)
        others = [(self.lease_devices(other), self._admitted_bytes[t])
                  for t, other in self.pool.leases.items()
                  if t != lease.tenant and t in self._admitted_bytes]
        for dev in devs:
            held = sum(n / len(odevs) for odevs, n in others if dev in odevs)
            if held + share > HBM_BYTES_PER_DEVICE:
                raise HRPError(
                    f"lease of {len(devs)} device(s) cannot hold "
                    f"{share/2**30:.1f} GiB/device ({what}) beside "
                    f"{held/2**30:.1f} GiB of other tenants on {dev}")
        self._admitted_bytes[lease.tenant] = need

    def check_hbm(self, cfg, lease: Lease, *, batch: int, max_len: int) -> None:
        """Admission control: model + KV bytes must fit the lease's device
        memory beside the tenants already admitted there (the paper's
        DDR-port-budget rule, §4.2.2)."""
        param_bytes = cfg.param_count() * 2            # bf16
        kv = kv_cache_bytes(cfg, batch, max_len)
        self._admit(lease, param_bytes + kv,
                    f"params {param_bytes/2**30:.1f} + kv {kv/2**30:.1f} GiB")

    def check_hbm_paged(self, cfg, lease: Lease, *, n_pages: int,
                        page_size: int) -> None:
        """Paged variant of :meth:`check_hbm`: model + page-pool bytes must
        fit the lease — the pool is sized by *pages*, not slots x max_len,
        which is exactly how paging over-subscribes nominal capacity."""
        param_bytes = cfg.param_count() * 2
        kv = paged_kv_cache_bytes(cfg, n_pages, page_size)
        self._admit(lease, param_bytes + kv,
                    f"params {param_bytes/2**30:.1f} + paged kv "
                    f"{kv/2**30:.1f} GiB")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one program argument (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _example(spec: Any, device: torch.device) -> Any:
    """Zeros for ``spec`` on ``device`` (the first call only needs the
    shapes and dtypes); anything else passes through."""
    if not isinstance(spec, TensorSpec):
        return spec
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


#: the axis names of :meth:`VirtualAcceleratorPool.mesh_for`'s array, as the
#: reference names its ``Mesh``
MESH_AXES = ("data", "model")


def check_state_specs(tree, specs, mesh: np.ndarray) -> None:
    """Raise ValueError where placing ``tree`` by ``specs`` (a tree of
    :class:`~repro_torch.distributed.P` leaves) over ``mesh``'s
    ``("data", "model")`` axes would fail as ``jax.device_put`` with a
    ``NamedSharding`` fails: an unknown or repeated axis, more spec entries
    than the leaf has dimensions, or a dimension its axes do not divide."""
    sizes = dict(zip(MESH_AXES, np.asarray(mesh, dtype=object).shape))

    def check(spec: P, leaf) -> None:
        if not isinstance(leaf, torch.Tensor):
            return
        if len(spec) > leaf.dim():
            raise ValueError(
                f"spec {spec!r} has {len(spec)} entries for a leaf of rank "
                f"{leaf.dim()}")
        seen = set()
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            n = 1
            for name in names:
                if name not in sizes:
                    raise ValueError(
                        f"spec {spec!r} names axis {name!r}; the lease's "
                        f"mesh has axes {MESH_AXES}")
                if name in seen:
                    raise ValueError(f"spec {spec!r} uses axis {name!r} twice")
                seen.add(name)
                n *= sizes[name]
            if leaf.shape[dim] % n:
                raise ValueError(
                    f"spec {spec!r} splits dimension {dim} of a leaf of shape "
                    f"{tuple(leaf.shape)} {n} ways; {n} does not divide "
                    f"{leaf.shape[dim]}")

    spec_map(check, specs, tree)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class CompiledProgram:
    executable: Any
    lowered_seconds: float
    compile_seconds: float
    n_cores: int


class TwoStageCompiler:
    """Two-stage static→dynamic compilation for serving programs.

    ``static_compile`` is the offline stage: for every lease size a tenant
    may be resized to, make the example arguments on the lease's first
    device and run the program once, which builds and loads every kernel it
    reaches.  ``reconfigure`` is the online stage: resize the lease, fetch
    the cached program, and migrate live state (caches, slot state) onto the
    lease's first device — the millisecond path the paper measures.
    """

    def __init__(self, pool: VirtualAcceleratorPool, *,
                 clock: Optional[Callable[[], float]] = None):
        self.pool = pool
        self._cache: Dict[Tuple, CompiledProgram] = {}
        # injectable so compile/migrate timings are deterministic in tests
        self._clock = clock if clock is not None else time.perf_counter

    def _default_mesh(self, n: int) -> np.ndarray:
        devs = [d for c in self.pool.core_devices[:n] for d in c]
        return _device_array(devs, (n, self.pool.devices_per_core))

    # -- offline -------------------------------------------------------
    def static_compile(
        self, key: str, program: Callable, abstract_args: Tuple,
        *, lease_sizes: Sequence[int],
        mesh_builder: Optional[Callable[[int], np.ndarray]] = None,
    ) -> Dict[int, CompiledProgram]:
        """Warm ``program`` for every lease size; cache the callables.
        ``abstract_args`` are :class:`TensorSpec`s (other values pass
        through); ``mesh_builder(n)`` gives the devices of a lease of ``n``
        cores (default: the pool's first ``n`` cores)."""
        build_mesh = mesh_builder if mesh_builder is not None \
            else self._default_mesh
        out = {}
        for n in lease_sizes:
            device = torch.device(np.asarray(build_mesh(n)).flat[0])
            t0 = self._clock()
            args = [_example(a, device) for a in abstract_args]
            _synchronize(device)
            t1 = self._clock()
            program(*args)
            _synchronize(device)
            t2 = self._clock()
            prog = CompiledProgram(
                executable=program, lowered_seconds=t1 - t0,
                compile_seconds=t2 - t1, n_cores=n,
            )
            self._cache[(key, n)] = prog
            out[n] = prog
        return out

    def lookup(self, key: str, n_cores: int) -> Optional[CompiledProgram]:
        return self._cache.get((key, n_cores))

    # -- online ----------------------------------------------------------
    def reconfigure(
        self, tenant: str, key: str, n_cores: int,
        *, live_state: Any = None, state_specs: Any = None,
    ) -> Tuple[CompiledProgram, Any, Dict[str, float]]:
        """Resize ``tenant`` to ``n_cores``; return (program, migrated state,
        timing breakdown).  Raises if the static stage didn't cover
        ``n_cores`` (the paper's design rule: IFPs are pre-generated for
        every allocatable core count).  ``state_specs`` (a tree of
        :class:`~repro_torch.distributed.P`) places the tree by spec over
        the lease's ``("data", "model")`` array: each spec is checked
        against the lease's width (:func:`check_state_specs`), and the tree
        goes to the lease's device.  The copies are enqueued on the stream,
        not waited for; on one card every logical core is the same device
        and no byte moves."""
        t0 = self._clock()
        lease = self.pool.resize(tenant, n_cores)
        prog = self.lookup(key, n_cores)
        if prog is None:
            raise HRPError(
                f"no static artifact for ({key}, {n_cores}); "
                f"static_compile must cover all lease sizes"
            )
        t1 = self._clock()
        migrated = live_state
        if live_state is not None:
            mesh = self.pool.mesh_for(lease)
            if state_specs is not None:
                check_state_specs(live_state, state_specs, mesh)
            migrated = tree_to_device(live_state, mesh.flat[0])
        t2 = self._clock()
        timing = {
            "t_lookup": t1 - t0,
            "t_migrate": t2 - t1,
            "t_context": t2 - t0,
        }
        return prog, migrated, timing


class ServingExecutor:
    """Hypervisor executor for the port's serving stack.

    This gives the serving side the *same* scheduling interface as the
    simulation engine: a :class:`repro_torch.core.hypervisor.Hypervisor`
    makes the placement decisions (which tenant gets how many cores, who
    waits), and this adapter carries them out —

    * **admission**  → ``VirtualAcceleratorPool.lease`` + program cache
      lookup for the granted lease size,
    * **resize**     → :meth:`TwoStageCompiler.reconfigure` (cache lookup +
      live-state migration, the millisecond path) — so ``reconfigure`` is
      invoked by policy decisions rather than ad-hoc calls; tenants without
      a registered program key fall back to a plain lease resize,
    * **departure**  → lease release and per-tenant state cleanup.

    Time is real here, so ``advance`` is a no-op and the event loop serves as
    an ordered, invariant-checked decision log.  ``TenantSpec.artifact`` is
    interpreted as the tenant's program key (the ``key`` passed to
    ``static_compile``), or ``None`` for tenants managed outside the program
    cache (e.g. a ContinuousBatcher driving its own steps).

    **SLO enforcement on the live batcher.**  A ``latency_slo`` hypervisor
    needs ``estimate_latency(spec, n_cores)``: either register an explicit
    per-tenant model (:meth:`register_latency_model`), or feed measured
    per-request latencies in with :meth:`record_latency` /
    :meth:`note_completion` (the batcher owner calls it as requests finish)
    and the executor extrapolates from the EWMA assuming ~linear scaling
    over the current lease size.  Policy decisions then resize the batcher
    through ``reconfigure`` exactly like any other resize.  Preemptive
    eviction (``exec_evict``) releases the lease but keeps the tenant's
    registered state/keys so a later re-admission resumes cleanly.
    """

    #: finished-request callback; a Hypervisor overwrites this at
    #: construction so completions become COMPLETION events on its timeline
    completion_sink: Optional[Callable[[RequestRecord], None]]

    def __init__(self, vpool: VirtualAcceleratorPool,
                 compiler: Optional[TwoStageCompiler] = None,
                 *, latency_ewma_alpha: float = 0.3,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry: Optional[Telemetry] = None) -> None:
        self.vpool = vpool
        # injectable clock: every wall-clock stamp in reconfig_log flows
        # through it, so tracing tests can pin time; the default compiler
        # inherits the same hook
        self._clock = clock if clock is not None else time.perf_counter
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._reg = self.telemetry.registry
        self._tracer = self.telemetry.tracer
        self.compiler = compiler if compiler is not None \
            else TwoStageCompiler(vpool, clock=clock)
        self.pool = vpool.pool                       # Hypervisor reads .pool
        self.programs: Dict[str, Optional[CompiledProgram]] = {}
        self.live_state: Dict[str, Any] = {}
        self.state_specs: Dict[str, Any] = {}
        self.reconfig_log: List[Dict[str, Any]] = []
        self._keys: Dict[str, Optional[str]] = {}
        self._on_migrate: Dict[str, Callable[[Any], None]] = {}
        self._kv_limit_cbs: Dict[str, Callable[[int], None]] = {}
        self._remesh_cbs: Dict[str, Callable[[np.ndarray], None]] = {}
        # fault-domain plumbing
        self._fault_sinks: Dict[str, Callable[[Any], None]] = {}
        self.fault_log: List[Dict[str, Any]] = []
        # SLO plumbing
        self.completion_sink = None
        self.pending_requests: Dict[str, List[RequestRecord]] = {}
        self._request_sinks: Dict[str, Callable[[RequestRecord], None]] = {}
        self._latency_models: Dict[str, Callable[[int], float]] = {}
        self._ewma_alpha = latency_ewma_alpha
        # tenant -> (ewma seconds, lease size the measurements came from)
        self._ewma: Dict[str, Tuple[float, int]] = {}

    def register_state(self, tenant: str, live_state: Any,
                       state_specs: Any = None,
                       on_migrate: Optional[Callable[[Any], None]] = None,
                       ) -> None:
        """Attach the tenant's live state (caches, slot state) so
        policy-driven resizes migrate it onto the new lease.

        ``live_state`` may be the state tree itself, or a zero-arg callable
        returning the *current* state.  The callable form is the one for a
        ``ContinuousBatcher``: its steps replace the state objects, so a
        stored reference would be stale by the time a resize lands between
        chunks, and ``ContinuousBatcher.live_state`` first waits for the
        work already queued on the card.  ``on_migrate`` is invoked with the
        migrated tree after a resize so the owner can adopt it
        (``ContinuousBatcher.adopt_state``).  For a speculative batcher the
        tree also carries the n-gram draft state, so drafter history
        survives a policy-driven resize along with the caches."""
        self.live_state[tenant] = live_state
        if state_specs is not None:
            self.state_specs[tenant] = state_specs
        if on_migrate is not None:
            self._on_migrate[tenant] = on_migrate

    # -- SLO plumbing ---------------------------------------------------
    def register_latency_model(self, tenant: str,
                               fn: Callable[[int], float]) -> None:
        """Explicit latency model ``fn(n_cores) -> seconds`` for the
        ``latency_slo`` policy's demand computation (takes precedence over
        the measured EWMA)."""
        self._latency_models[tenant] = fn

    def register_kv_limit(self, tenant: str,
                          fn: Callable[[int], None]) -> None:
        """Where the tenant's ``kv_pages`` lease changes land — typically
        ``batcher.set_page_limit``, so a hypervisor trading memory between
        tenants throttles the live page pool mid-run."""
        self._kv_limit_cbs[tenant] = fn

    def register_remesh(self, tenant: str,
                        fn: Callable[[np.ndarray], None]) -> None:
        """Where the tenant's lease-driven device changes land: when the
        hypervisor resizes the lease of a tenant managed outside the program
        cache (``artifact=None``), ``exec_resize`` hands the callback the
        flat device array of the new lease (``tp_mesh_for``), typically
        ``lambda mesh: batcher.remesh(mesh=mesh)``: a lease of n cores
        shards the tenant's decode n ways, re-meshed between two chunks."""
        self._remesh_cbs[tenant] = fn

    def register_fault_sink(self, tenant: str,
                            fn: Callable[[Any], None]) -> None:
        """Where the tenant's ``FAILURE`` events land.  Core faults are
        delivered to the failing core's lease owner; pool-level faults (no
        core) go to every sink."""
        self._fault_sinks[tenant] = fn

    def register_request_sink(self, tenant: str,
                              fn: Callable[[RequestRecord], None]) -> None:
        """Where the tenant's open-loop requests go on arrival — typically
        ``lambda rec: batcher.submit(...)``.  Without a sink, requests pile
        up in ``pending_requests`` for the owner to drain."""
        self._request_sinks[tenant] = fn

    def record_latency(self, tenant: str, seconds: float,
                       *, slo: Optional[float] = None) -> None:
        """Feed one measured request latency into the tenant's EWMA (the
        fallback demand model) and its SLO attainment counters.  The lease
        size at measurement time is stored with the EWMA so extrapolation
        stays anchored to the cores that produced the number — even after
        the lease is released (eviction, departure)."""
        lease = self.pool.lease_of(tenant)
        k_now = lease.n_cores if lease is not None else None
        prev = self._ewma.get(tenant)
        a = self._ewma_alpha
        if prev is None:
            self._ewma[tenant] = (seconds, k_now or 1)
        else:
            prev_s, prev_k = prev
            self._ewma[tenant] = (a * seconds + (1 - a) * prev_s,
                                  k_now if k_now is not None else prev_k)
        self._reg.counter("slo.requests", tenant).inc()
        if slo is not None and seconds <= slo:
            self._reg.counter("slo.met", tenant).inc()
        self._reg.histogram("slo.latency_s", tenant).record(seconds)

    def note_completion(self, record: RequestRecord) -> None:
        """Report a finished request: updates the latency EWMA/SLO counters
        and forwards the record to the hypervisor's ``completion_sink``."""
        lat = record.latency
        if lat is not None:
            self.record_latency(record.tenant, lat, slo=record.slo)
        if self.completion_sink is not None:
            self.completion_sink(record)

    def note_drop(self, record: RequestRecord) -> None:
        """Report a request shed by the drop policy (deadline passed before
        start): it counts as offered-but-unserved in :meth:`slo_report` —
        never toward the latency EWMA (it has no service time)."""
        record.dropped = True
        self._reg.counter("slo.requests", record.tenant).inc()
        self._reg.counter("slo.dropped", record.tenant).inc()

    def note_shared_kv(self, tenant: str, pages: int) -> None:
        """Report how many of ``tenant``'s kv pages currently back its
        shared prefix cache (``ContinuousBatcher.stats.shared_pages``):
        recorded on the pool (``ResourcePool.note_shared_kv``) so
        ``kv_pages_proportional`` treats the pinned set as a soft floor and
        ``check_kv_quota`` audits it each event."""
        self.pool.note_shared_kv(tenant, pages)

    def estimate_latency(self, spec: TenantSpec, n_cores: int) -> Optional[float]:
        """Demand model for ``latency_slo``: the registered model when there
        is one, else the measured EWMA extrapolated from the lease size it
        was measured at, assuming ~linear scaling (None when nothing is
        known — the policy then falls back to the tenant's floor)."""
        model = self._latency_models.get(spec.name)
        if model is not None:
            return float(model(n_cores))
        observed = self._ewma.get(spec.name)
        if observed is None:
            return None
        seconds, k0 = observed
        return seconds * k0 / max(n_cores, 1)

    def slo_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant SLO attainment over everything fed through
        :meth:`record_latency` / :meth:`note_completion`.  Percentile
        latencies (p50/p95/p99, seconds) come from the registry's
        log-bucketed latency histogram — ``None`` for a tenant with no
        served requests (e.g. all dropped)."""
        out: Dict[str, Dict[str, Any]] = {}
        for tenant in self._reg.labels("slo.requests"):
            n = self._reg.counter("slo.requests", tenant).value
            met = self._reg.counter("slo.met", tenant).value
            ewma = self._ewma.get(tenant)
            hist = self._reg.histogram("slo.latency_s", tenant)
            out[tenant] = {
                "requests": n,
                "slo_met": met,
                "dropped": self._reg.counter("slo.dropped", tenant).value,
                "attainment": met / n if n else None,
                "ewma_latency": ewma[0] if ewma is not None else None,
                "p50_latency": hist.quantile(0.50) if hist.count else None,
                "p95_latency": hist.quantile(0.95) if hist.count else None,
                "p99_latency": hist.quantile(0.99) if hist.count else None,
            }
        return out

    def program_of(self, tenant: str) -> Optional[CompiledProgram]:
        return self.programs.get(tenant)

    def mesh_of(self, tenant: str) -> np.ndarray:
        lease = self.pool.lease_of(tenant)
        if lease is None:
            raise HRPError(f"tenant {tenant} holds no lease")
        return self.vpool.mesh_for(lease)

    # -- hypervisor executor protocol ----------------------------------
    def begin(self, horizon: float) -> None:
        pass

    def advance(self, until: float) -> None:
        pass  # real time: nothing to simulate between events

    def probe(self, at: float) -> int:
        return 0

    def metrics(self) -> Dict[str, Any]:
        return {"reconfigs": list(self.reconfig_log),
                "allocation": {t: l.n_cores for t, l in self.pool.leases.items()}}

    def exec_admit(self, spec: TenantSpec, n_cores: int, at: float) -> None:
        self.vpool.lease(spec.name, n_cores)
        key = spec.artifact if isinstance(spec.artifact, str) else None
        self._keys[spec.name] = key
        self.programs[spec.name] = (
            self.compiler.lookup(key, n_cores) if key is not None else None
        )

    def exec_resize(self, name: str, n_cores: int, at: float,
                    mode: SwitchMode) -> None:
        lease = self.pool.lease_of(name)
        if lease is not None and lease.n_cores == n_cores:
            return
        key = self._keys.get(name)
        if key is None:
            new_lease = self.vpool.resize(name, n_cores)
            entry = {"tenant": name, "n_cores": n_cores}
            cb = self._remesh_cbs.get(name)
            if cb is not None:
                t0 = self._clock()
                cb(self.vpool.tp_mesh_for(new_lease))
                entry["t_remesh"] = self._clock() - t0
                self._tracer.complete("remesh", name, t0,
                                      entry["t_remesh"],
                                      {"n_cores": n_cores})
            self.reconfig_log.append(entry)
            return
        state = self.live_state.get(name)
        pulled = callable(state)
        if pulled:
            state = state()                  # pull the owner's CURRENT tree
        t0 = self._clock()
        prog, migrated, timing = self.compiler.reconfigure(
            name, key, n_cores,
            live_state=state,
            state_specs=self.state_specs.get(name),
        )
        self._tracer.complete("reconfigure", name, t0,
                              self._clock() - t0, {"n_cores": n_cores})
        self.programs[name] = prog
        if name in self.live_state and not pulled:
            self.live_state[name] = migrated
        cb = self._on_migrate.get(name)
        if cb is not None and migrated is not None:
            cb(migrated)
        self.reconfig_log.append({"tenant": name, "n_cores": n_cores, **timing})

    def exec_kv_resize(self, name: str, kv_pages: int, at: float) -> None:
        """Apply a kv-page lease change: forward the new cap to the tenant's
        registered page-limit callback (``ContinuousBatcher.set_page_limit``)
        and log it next to core reconfigs."""
        cb = self._kv_limit_cbs.get(name)
        if cb is not None:
            cb(kv_pages)
        self._tracer.instant("kv_resize", name, args={"kv_pages": kv_pages})
        self.reconfig_log.append({"tenant": name, "kv_pages": kv_pages})

    def exec_remove(self, name: str, at: float) -> None:
        self.vpool.release(name)
        for table in (self.programs, self.live_state, self.state_specs,
                      self._keys, self._on_migrate, self._request_sinks,
                      self.pending_requests, self._latency_models,
                      self._kv_limit_cbs, self._fault_sinks,
                      self._remesh_cbs):
            table.pop(name, None)

    def exec_request(self, name: str, record: RequestRecord, at: float) -> None:
        # drop policy at the delivery point: a request whose deadline
        # already passed before it could even reach the tenant's batcher is
        # shed here (counted in slo_report), not handed to a sink that
        # would serve it hopelessly late
        if record.deadline is not None and at > record.deadline:
            self.note_drop(record)
            return
        sink = self._request_sinks.get(name)
        if sink is not None:
            sink(record)
        else:
            self.pending_requests.setdefault(name, []).append(record)

    def exec_fault(self, fault: Any, at: float) -> None:
        """A ``FAILURE`` event fired: log it and deliver it to the affected
        tenant's fault sink.  Core death itself needs no serving-side work —
        the hypervisor displaces the owner through the normal
        ``exec_evict`` → re-admit path."""
        self.fault_log.append({"at": at, "fault": fault, "recovered": False})
        if fault.core is not None:
            owner = self.pool.owner_of(fault.core)
            sinks = ([self._fault_sinks[owner]]
                     if owner in self._fault_sinks else [])
        else:
            sinks = list(self._fault_sinks.values())
        for sink in sinks:
            sink(fault)

    def exec_recover(self, fault: Any, at: float) -> None:
        self.fault_log.append({"at": at, "fault": fault, "recovered": True})

    def exec_evict(self, name: str, at: float) -> None:
        """Preemptive eviction: release the lease and current program but —
        unlike :meth:`exec_remove` — keep the tenant's registered state,
        program key, sinks and latency model, so a later re-admission
        resumes where the eviction cut it off."""
        self.vpool.release(name)
        self.programs.pop(name, None)
        self._tracer.instant("evict", name)
        self.reconfig_log.append({"tenant": name, "evicted": True})


def make_serving_hypervisor(
    vpool: VirtualAcceleratorPool,
    *,
    compiler: Optional[TwoStageCompiler] = None,
    policy: Any = "even_split",
    clock: Optional[Callable[[], float]] = None,
    telemetry: Optional[Telemetry] = None,
    **kwargs: Any,
) -> Tuple[Hypervisor, ServingExecutor]:
    """One-call wiring of pool + two-stage compiler + hypervisor: returns the
    (hypervisor, executor) pair the serving stack schedules through.  A
    ``telemetry`` bundle is shared by both halves, so hypervisor events and
    executor reconfigs land in one registry and one trace timeline."""
    executor = ServingExecutor(vpool, compiler, clock=clock,
                               telemetry=telemetry)
    return Hypervisor(vpool.pool, policy=policy, executor=executor,
                      telemetry=executor.telemetry, **kwargs), executor
