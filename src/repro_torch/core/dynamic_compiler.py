"""Dynamic compiler — paper §5.2.2 (online reconfiguration stage, ~1 ms).

Copy of ``repro.core.dynamic_compiler`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

On every hardware re-allocation (a tenant's core count changes), the dynamic
compiler — *without* touching the expensive static artifacts — per layer:

1. fetches the latency LUTs of both tiling strategies from the cache,
2. runs the workload-balanced allocator (Eq. 4-6) for the allocated core
   count under each strategy,
3. picks the strategy with the smaller estimated makespan,
4. concatenates the chosen IFPs per core (dropping on-chip-reusable loads)
   and appends the synchronization ``System`` instruction,

and repeats until all layers are emitted.  The output is a
:class:`Schedule` — per-core, per-layer instruction programs plus metadata —
and the measured wall-clock of this function is the paper's
``T_recompile`` (Table 2).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

from .allocator import allocate, allocate_weighted
from .hwmodel import HardwareModel
from .ifp import Strategy
from .isa import Chain, SYNC_PROGRAM
from .latency_sim import simulate_layer_barrier
from .static_compiler import StaticArtifact


@dataclasses.dataclass
class LayerPlan:
    strategy: Strategy
    assignment: List[List[int]]     # per-core IFP index lists
    est_makespan: float


@dataclasses.dataclass
class Schedule:
    """Dynamic-compilation output for one tenant.

    ``per_core_layers[c][l]`` is a :class:`~repro_torch.core.isa.Chain` of cached
    IFP programs: the first tile of a contiguous run is the cold artifact
    (pays the shared load), the rest are the on-chip-cached artifacts — the
    zero-copy analogue of concatenating cached instruction files."""

    core_ids: List[int]                       # physical core indices (HRP lease)
    per_core_layers: List[List[Chain]]        # [local core][layer] -> chain
    plans: List[LayerPlan]
    compile_seconds: float                    # T_recompile
    instr_count: int
    from_cache: bool = False                  # schedule reused from the LRU

    @property
    def n_cores(self) -> int:
        return len(self.core_ids)

    @property
    def transfer_bytes(self) -> float:
        """Instruction-file size: the paper ships binary instruction words;
        we charge 16 B per instruction (128-bit words)."""
        return 16.0 * self.instr_count

    def estimated_latency(self, hw: HardwareModel) -> float:
        return simulate_layer_barrier(self.per_core_layers, hw)


class DynamicCompiler:
    """Online stage of the two-stage static-dynamic compilation.

    Schedules are memoized in an LRU keyed on ``(len(core_ids), fastpath,
    rounded core_speeds)``: the plan depends only on the core *count* (and
    relative speeds), not on which physical cores the HRP granted, so a
    Hypervisor reconfiguring a tenant back to a previously seen size reuses
    the schedule at lookup cost — T_recompile collapses to ~µs on hits
    (reported through :meth:`context_switch_cost`).
    """

    def __init__(self, artifact: StaticArtifact, *, cache_size: int = 32) -> None:
        self.artifact = artifact
        self._schedule_cache: "OrderedDict[Tuple, Schedule]" = OrderedDict()
        self._cache_size = cache_size
        self.cache_hits = 0
        self.cache_misses = 0

    def compile(
        self,
        core_ids: Sequence[int],
        *,
        single_core_fastpath: bool = True,
        core_speeds: Sequence[float] | None = None,
    ) -> Schedule:
        """Generate (or reuse) the per-core instruction schedule for
        ``core_ids``.

        ``single_core_fastpath`` implements the §6.3.3 optimization: when a
        tenant holds exactly one core, emit the monolithic untiled per-layer
        programs (no tiling overhead) instead of 16 concatenated tiles.

        ``core_speeds`` (straggler mitigation): relative speed per core; when
        given, allocation uses the heterogeneous-LPT solver so slow cores
        receive proportionally fewer IFPs.
        """
        t0 = time.perf_counter()
        key = (
            len(core_ids), bool(single_core_fastpath),
            None if core_speeds is None
            else tuple(round(float(s), 3) for s in core_speeds),
        )
        hit = self._schedule_cache.get(key)
        if hit is not None:
            self._schedule_cache.move_to_end(key)
            self.cache_hits += 1
            # same plan, new physical cores; T_recompile = the lookup
            return dataclasses.replace(
                hit, core_ids=list(core_ids),
                compile_seconds=time.perf_counter() - t0, from_cache=True,
            )
        sched = self._compile_uncached(
            core_ids, single_core_fastpath=single_core_fastpath,
            core_speeds=core_speeds, t0=t0,
        )
        self.cache_misses += 1
        self._schedule_cache[key] = sched
        if len(self._schedule_cache) > self._cache_size:
            self._schedule_cache.popitem(last=False)
        return sched

    def _compile_uncached(
        self,
        core_ids: Sequence[int],
        *,
        single_core_fastpath: bool,
        core_speeds: Sequence[float] | None,
        t0: float,
    ) -> Schedule:
        k = len(core_ids)
        art = self.artifact
        n_layers = len(art.workload)
        per_core: List[List[Chain]] = [[] for _ in range(k)]
        plans: List[LayerPlan] = []

        if single_core_fastpath and k == 1 and art.mono:
            # §6.3.3 optimization: a tenant holding exactly one core gets the
            # original untiled instruction files — no tiling overhead at all.
            for li in range(n_layers):
                per_core[0].append(Chain([art.mono[li], SYNC_PROGRAM]))
                plans.append(
                    LayerPlan(
                        strategy=Strategy.WIDTH,
                        assignment=[[0]],
                        est_makespan=art.mono_latency[li],
                    )
                )
            dt = time.perf_counter() - t0
            n_instr = sum(len(c) for layers in per_core for c in layers)
            return Schedule(
                core_ids=list(core_ids),
                per_core_layers=per_core,
                plans=plans,
                compile_seconds=dt,
                instr_count=n_instr,
            )

        for li in range(n_layers):
            best_plan: LayerPlan | None = None
            for strategy in (Strategy.WIDTH, Strategy.OC):
                lut = art.lut(li, strategy)
                if core_speeds is not None:
                    runs, makespan = allocate_weighted(lut.cold, core_speeds)
                else:
                    runs, makespan = allocate(
                        lut.cached, k, run_overhead=lut.run_overhead,
                        precomputed=lut.precomputed,
                    )
                plan = LayerPlan(strategy=strategy, assignment=runs, est_makespan=makespan)
                if best_plan is None or makespan < best_plan.est_makespan:
                    best_plan = plan
            assert best_plan is not None
            plans.append(best_plan)

            # chain the cached artifacts: first tile of a contiguous run is
            # the cold program (pays the shared load once per core), the rest
            # run with the shared tensor already on-chip.  Zero instruction
            # rewriting — this is what keeps T_recompile at ~1 ms.
            lut = art.lut(li, best_plan.strategy)
            for c in range(k):
                idxs = best_plan.assignment[c] if c < len(best_plan.assignment) else []
                chain = Chain()
                for j, i in enumerate(idxs):
                    ifp = lut.ifps[i]
                    chain.append(
                        ifp.program if j == 0 else (ifp.program_cached or ifp.program)
                    )
                # layer-wise multi-core synchronization (§5.2.2): every core,
                # busy or not, runs the sync System instruction of this layer.
                chain.append(SYNC_PROGRAM)
                per_core[c].append(chain)

        dt = time.perf_counter() - t0
        n_instr = sum(len(c) for layers in per_core for c in layers)
        return Schedule(
            core_ids=list(core_ids),
            per_core_layers=per_core,
            plans=plans,
            compile_seconds=dt,
            instr_count=n_instr,
        )

    # ------------------------------------------------------------------
    def context_switch_cost(self, schedule: Schedule, hw: HardwareModel) -> Dict[str, float]:
        """Paper Eq. 7: T_context = T_recompile + T_transfer.

        Transfer is priced at PCIe-class bandwidth (the paper measures
        0.03-0.20 ms for instruction files over the host link)."""
        pcie_bw = 8e9  # bytes/s, PCIe3 x8 effective
        t_transfer = schedule.transfer_bytes / pcie_bw
        return {
            "t_recompile": schedule.compile_seconds,
            "t_transfer": t_transfer,
            "t_context": schedule.compile_seconds + t_transfer,
            "cache_hit": 1.0 if schedule.from_cache else 0.0,
            "cache_hits": float(self.cache_hits),
        }
