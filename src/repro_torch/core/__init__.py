"""Core library of the port: the paper's FPGA-virtualization technique in
portable form, copied from ``repro.core``.

Pipeline:  workload (layer table)
        -> StaticCompiler   (offline: tiled IFPs + latency LUT)     §5.2.1
        -> DynamicCompiler  (online ~ms: workload-balanced realloc) §5.2.2
        -> VirtualEngine    (HRP leases + two-level IDM + barriers) §4
        -> Hypervisor       (global event loop + realloc policies)  §4.1

One time-ordered event queue (:mod:`.events`) of tenant arrivals,
departures, request completions, reconfiguration signals, faults and
straggler probes is consumed by :class:`.hypervisor.Hypervisor`, which owns
the :class:`.hrp.ResourcePool` (cores, DDR-port budget, kv-page leases,
fault domains) and asks a reallocation policy from ``POLICIES`` how to
divide the pool on every event.  Decisions are carried out by the
discrete-event :class:`.vengine.VirtualEngine` (simulation), a
bookkeeping-only :class:`.hypervisor.PoolExecutor`, or the serving adapter
(:class:`repro_torch.serving.tenancy.ServingExecutor`), where a resize
becomes a ``TwoStageCompiler.reconfigure`` call.  Level 2 of the IDM is the
port's own :func:`.latency_sim.simulate`.

These modules are pure Python, copies of their ``repro.core`` twins: the
port imports nothing of ``repro`` and none of them imports ``torch``.  The
reference's chip model is replaced by :func:`.hwmodel.h100_chip`, the port's
card.
"""

from .allocator import allocate, allocate_contiguous_dp, allocate_lpt, allocate_weighted
from .dispatch import (
    ContextSwitchController,
    InstructionRouter,
    MultiCoreSyncController,
    SwitchMode,
)
from .dynamic_compiler import DynamicCompiler, Schedule
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
from .hwmodel import (
    HardwareModel,
    fpga_core,
    fpga_large_core,
    fpga_small_core,
    h100_chip,
)
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
from .ifp import IFP, Strategy, dedupe_onchip, make_layer_ifps
from .isa import Chain, Instr, Op, Program, SYNC_PROGRAM, Unit, concat
from .latency_sim import roofline_terms, simulate, simulate_layer_barrier
from .static_compiler import StaticArtifact, StaticCompiler, compile_monolithic
from .vengine import ReconfigRequest, TenantMetrics, VirtualEngine
from .workloads import CNN_WORKLOADS, Layer, lm_layer_table, workload_stats

__all__ = [
    "allocate", "allocate_contiguous_dp", "allocate_lpt", "allocate_weighted",
    "ContextSwitchController", "InstructionRouter", "MultiCoreSyncController",
    "SwitchMode", "DynamicCompiler", "Schedule", "Event", "EventKind",
    "EventQueue", "PoissonTraffic", "RequestRecord", "TraceTraffic",
    "emit_requests", "FaultInjector", "FaultKind", "FaultSpec",
    "HRPError", "Lease",
    "ResourcePool", "HardwareModel", "fpga_core", "fpga_large_core",
    "fpga_small_core", "h100_chip", "POLICIES", "Hypervisor",
    "PolicyContext", "PoolExecutor", "TenantSpec", "kv_pages_proportional",
    "latency_slo", "queueing_latency", "resolve_policy", "slo_demand",
    "IFP", "Strategy", "dedupe_onchip",
    "make_layer_ifps", "Chain", "Instr", "Op", "Program", "SYNC_PROGRAM",
    "Unit", "concat",
    "roofline_terms", "simulate", "simulate_layer_barrier", "StaticArtifact",
    "StaticCompiler", "compile_monolithic", "ReconfigRequest", "TenantMetrics",
    "VirtualEngine", "CNN_WORKLOADS", "Layer", "lm_layer_table",
    "workload_stats",
]
