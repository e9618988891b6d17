"""The hypervisor's scheduling core, copied from ``repro.core`` for the port.

One time-ordered event queue (:mod:`.events`) of tenant arrivals,
departures, request completions, reconfiguration signals, faults and
straggler probes, consumed by :class:`.hypervisor.Hypervisor`, which owns
the :class:`.hrp.ResourcePool` (cores, DDR-port budget, kv-page leases,
fault domains) and asks a reallocation policy from ``POLICIES`` how to
divide the pool on every event.  Decisions are carried out by a
bookkeeping-only :class:`.hypervisor.PoolExecutor` or by the serving
adapter (:class:`repro_torch.serving.tenancy.ServingExecutor`), where a
resize becomes a ``TwoStageCompiler.reconfigure`` call.

These modules are pure Python, copies of their ``repro.core`` twins: the
port imports nothing of ``repro``.  The reference's simulation engine
(``vengine``, the static and dynamic compilers, ``ifp``, ``isa``,
``latency_sim``, ``allocator``, ``workloads``, ``hwmodel``) runs no device
work and is not copied (ROADMAP.md, Queue 1).
"""

from .dispatch import (
    ContextSwitchController,
    InstructionRouter,
    MultiCoreSyncController,
    SwitchMode,
)
from .events import (
    Event,
    EventKind,
    EventQueue,
    PoissonTraffic,
    RequestRecord,
    TraceTraffic,
    emit_requests,
)
from .faults import FaultInjector, FaultKind, FaultSpec
from .hrp import HRPError, Lease, ResourcePool
from .hypervisor import (
    POLICIES,
    Hypervisor,
    PolicyContext,
    PoolExecutor,
    TenantSpec,
    kv_pages_proportional,
    latency_slo,
    queueing_latency,
    resolve_policy,
    slo_demand,
)

__all__ = [
    "ContextSwitchController", "InstructionRouter", "MultiCoreSyncController",
    "SwitchMode", "Event", "EventKind", "EventQueue", "PoissonTraffic",
    "RequestRecord", "TraceTraffic", "emit_requests", "FaultInjector",
    "FaultKind", "FaultSpec", "HRPError", "Lease", "ResourcePool", "POLICIES",
    "Hypervisor", "PolicyContext", "PoolExecutor", "TenantSpec",
    "kv_pages_proportional", "latency_slo", "queueing_latency",
    "resolve_policy", "slo_demand",
]
