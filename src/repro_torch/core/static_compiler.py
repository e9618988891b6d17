"""Static compiler — paper §5.2.1 (offline deployment stage).

Copy of ``repro.core.static_compiler`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

Given a workload (per-layer shape table) and the hardware configuration of the
*basic shareable unit*, the static compiler:

1. tiles every layer under **both** strategies (WIDTH and OC) into IFPs,
2. prices every IFP on the basic unit with the latency simulator, producing
   the latency LUT (both cold and on-chip-cached variants),
3. caches everything for the dynamic compiler.

This is the expensive stage (paper: 14.7-46.8 s for full instruction
generation).  Our instruction IR is lighter than real binary instruction
files, so absolute times are smaller, but the asymmetry static >> dynamic is
preserved and measured in benchmarks/bench_context_switch.py.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from .allocator import partition_candidates
from .hwmodel import HardwareModel
from .ifp import IFP, Strategy, make_layer_ifps
from .isa import Op, Program
from .latency_sim import simulate
from .workloads import Workload


@dataclasses.dataclass
class LayerLUT:
    """Latency LUT rows of one (layer, strategy): per-IFP cold/cached costs
    plus the per-run reuse overhead the allocator charges once per core.
    ``precomputed`` is the (prefix sums, candidate makespans) pair the
    binary-search allocator consumes — built offline so the dynamic path
    never enumerates the O(N²) candidates."""

    ifps: List[IFP]
    cold: List[float]
    cached: List[float]
    precomputed: Tuple[List[float], List[float]] | None = None

    @property
    def run_overhead(self) -> float:
        if not self.cold:
            return 0.0
        return max(self.cold[0] - self.cached[0], 0.0)


@dataclasses.dataclass
class StaticArtifact:
    """Everything the dynamic compiler needs, cached at deployment time."""

    workload: Workload
    hw_unit: HardwareModel
    n_tiles: int
    luts: Dict[Tuple[int, str], LayerLUT]
    compile_seconds: float
    # untiled per-layer programs: the §6.3.3 single-core fast path, generated
    # by the *original* compiler during offline deployment.
    mono: List[Program] = dataclasses.field(default_factory=list)
    mono_latency: List[float] = dataclasses.field(default_factory=list)

    def lut(self, layer_idx: int, strategy: Strategy) -> LayerLUT:
        return self.luts[(layer_idx, strategy.value)]


def _cached_program(prog: Program, vmem_bytes: int) -> Program:
    """The program as it runs when the *shared* tensor of its (layer,
    strategy) is already on-chip: shared LOADs that fit on-chip memory are
    dropped (weights under WIDTH tiling, the replicated input map under OC —
    per-tile OC weight slices are never reusable and stay)."""
    out = Program()
    # vmem-fit is judged on the whole tensor (grouped chunk loads of one
    # tensor sum), matching dedupe_onchip's residency model.
    totals: Dict[tuple, float] = {}
    for ins in prog.instrs:
        if ins.op is Op.LOAD and ins.tag.get("key") is not None:
            kk = (ins.tag.get("kind"), ins.tag["key"])
            totals[kk] = totals.get(kk, 0.0) + ins.nbytes
    mapping: Dict[int, int | None] = {}
    for ins in prog.instrs:
        if (
            ins.op is Op.LOAD
            and ins.tag.get("shared")
            and ins.tag.get("key") is not None
            and totals[(ins.tag.get("kind"), ins.tag["key"])] <= vmem_bytes
        ):
            mapping[ins.iid] = None
            continue
        new_deps = [mapping[d] for d in ins.deps if mapping.get(d) is not None]
        new_iid = len(out.instrs)
        mapping[ins.iid] = new_iid
        out.instrs.append(dataclasses.replace(ins, iid=new_iid, deps=new_deps, tag=dict(ins.tag)))
    return out


class StaticCompiler:
    """Offline stage of the two-stage static-dynamic compilation."""

    def __init__(
        self,
        hw_unit: HardwareModel,
        *,
        n_tiles: int = 16,
        load_groups: int = 4,
    ) -> None:
        self.hw_unit = hw_unit
        self.n_tiles = n_tiles
        self.load_groups = load_groups

    def compile(self, workload: Workload) -> StaticArtifact:
        t0 = time.perf_counter()
        luts: Dict[Tuple[int, str], LayerLUT] = {}
        for li, layer in enumerate(workload):
            for strategy in (Strategy.WIDTH, Strategy.OC):
                ifps = make_layer_ifps(
                    layer, li, strategy, self.n_tiles, load_groups=self.load_groups
                )
                cold: List[float] = []
                cached: List[float] = []
                for ifp in ifps:
                    ifp.program.validate()
                    ifp.flops = ifp.program.total_flops
                    ifp.program_cached = _cached_program(
                        ifp.program, self.hw_unit.vmem_bytes
                    )
                    ifp.latency = simulate(ifp.program, self.hw_unit)
                    ifp.latency_cached = simulate(ifp.program_cached, self.hw_unit)
                    cold.append(ifp.latency)
                    cached.append(ifp.latency_cached)
                lut = LayerLUT(ifps=ifps, cold=cold, cached=cached)
                lut.precomputed = partition_candidates(
                    cached, run_overhead=lut.run_overhead
                )
                luts[(li, strategy.value)] = lut
        mono = compile_monolithic(workload, self.hw_unit, load_groups=2 * self.load_groups)
        mono_latency = [simulate(p, self.hw_unit) for p in mono]
        dt = time.perf_counter() - t0
        return StaticArtifact(
            workload=workload,
            hw_unit=self.hw_unit,
            n_tiles=self.n_tiles,
            luts=luts,
            compile_seconds=dt,
            mono=mono,
            mono_latency=mono_latency,
        )


def compile_monolithic(workload: Workload, hw: HardwareModel, *, load_groups: int = 8) -> List[Program]:
    """Single-core baseline: each layer as one untiled program (the paper's
    static single-core design, run on the large core)."""
    progs: List[Program] = []
    for li, layer in enumerate(workload):
        ifps = make_layer_ifps(layer, li, Strategy.WIDTH, 1, load_groups=load_groups)
        assert len(ifps) == 1
        progs.append(ifps[0].program)
    return progs
