"""Latency simulator — paper §5.2.1 (Eqs. 2-3) generalized.

Copy of ``repro.core.latency_sim`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

The simulator executes an instruction :class:`~repro_torch.core.isa.Program` on one
core of a :class:`~repro_torch.core.hwmodel.HardwareModel`.  Per the paper:

* *Conv* latency follows Eq. 2 — work divided by the core's parallelism, with
  ceil-quantization of each work dimension to the (PP, ICP, OCP) compute tile
  (that quantization is what makes a 16x512 pool beat a 1x8192 core).
* *Load/Save* latency follows Eq. 3 — bytes over effective bandwidth.
* Instructions are issued **in order per functional unit** (LOAD, SAVE, CONV,
  MISC run concurrently, like the four modules of the accelerator), and an
  instruction starts only when its dependencies have retired.  This is the
  directed-acyclic-graph traversal of §5.2.1, implemented as list scheduling,
  and it is what gives load/compute overlap its effect on the estimate.

The same simulator prices IFPs for the latency LUT (static compilation), whole
per-core schedules (dynamic compilation), and the multi-core layer-barrier
execution used by the virtualized engine.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .hwmodel import HardwareModel
from .isa import Instr, Program, Unit


def instr_duration(ins: Instr, hw: HardwareModel) -> float:
    if ins.unit is Unit.LOAD or ins.unit is Unit.SAVE:
        return hw.memory_time(ins.nbytes)
    if ins.unit is Unit.CONV or ins.unit is Unit.MISC:
        return hw.compute_time(ins.flops, ins.shape)
    # CTRL: CONVINIT register writes / SYSTEM bookkeeping
    return hw.instr_overhead


def simulate(program, hw: HardwareModel, *, start: float = 0.0) -> float:
    """Return the makespan (seconds) of ``program`` on one core.

    List scheduling: each functional unit is a serial queue; instruction start
    time = max(unit available, all deps retired).  Accepts a single
    :class:`~repro_torch.core.isa.Program` or a :class:`~repro_torch.core.isa.Chain`
    (dependency ids are local to each chained program).
    """
    from .isa import Chain

    chain = program.programs if isinstance(program, Chain) else [program]
    unit_free: Dict[Unit, float] = {u: start for u in Unit}
    makespan = start
    for prog in chain:
        end_at: List[float] = [start] * len(prog)
        for ins in prog:
            unit = ins.unit
            t0 = unit_free[unit]
            for d in ins.deps:
                t0 = max(t0, end_at[d])
            t1 = t0 + instr_duration(ins, hw)
            unit_free[unit] = t1
            end_at[ins.iid] = t1
            if t1 > makespan:
                makespan = t1
    return makespan - start


def simulate_with_times(program: Program, hw: HardwareModel) -> List[float]:
    """Like :func:`simulate` but returns per-instruction retire times."""
    unit_free: Dict[Unit, float] = {u: 0.0 for u in Unit}
    end_at: List[float] = [0.0] * len(program)
    for ins in program:
        t0 = unit_free[ins.unit]
        for d in ins.deps:
            t0 = max(t0, end_at[d])
        t1 = t0 + instr_duration(ins, hw)
        unit_free[ins.unit] = t1
        end_at[ins.iid] = t1
    return end_at


def simulate_layer_barrier(
    per_core_layer_programs: Sequence[Sequence[Program]],
    hw: HardwareModel,
    *,
    core_slowdown: Dict[int, float] | None = None,
) -> float:
    """Multi-core, layer-synchronized execution time (paper §5.2.2).

    ``per_core_layer_programs[k][l]`` is core ``k``'s instruction program for
    layer ``l`` (possibly empty).  After each layer every participating core
    raises ``sync_local``; the first-level IDM's sync controller releases
    ``sync_global`` once all have, adding ``hw.sync_latency`` per layer.

    ``core_slowdown`` maps core index -> multiplicative slowdown (straggler
    injection for the mitigation benchmarks).
    """
    if not per_core_layer_programs:
        return 0.0
    n_layers = max(len(c) for c in per_core_layer_programs)
    t = 0.0
    slow = core_slowdown or {}
    for l in range(n_layers):
        t_layer = 0.0
        for k, core_progs in enumerate(per_core_layer_programs):
            if l < len(core_progs) and len(core_progs[l]) > 0:
                dt = simulate(core_progs[l], hw)
                t_layer = max(t_layer, dt * slow.get(k, 1.0))
        t += t_layer + hw.sync_latency
    return t


def roofline_terms(program: Program, hw: HardwareModel) -> dict:
    """Aggregate compute/memory terms of a program on one core (no DAG)."""
    flops = program.total_flops
    nbytes = program.total_bytes
    return {
        "flops": flops,
        "bytes": nbytes,
        "t_compute": flops / hw.flops_per_sec,
        "t_memory": nbytes / (hw.mem_bw * hw.bw_eff),
        "intensity": flops / max(nbytes, 1.0),
    }
