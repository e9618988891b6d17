"""The port's simulation engine on the CPU, against the JAX package.

``repro_torch.core`` holds pure-Python copies of ``repro.core``'s
simulation engine: the ``Layer`` IR and the paper's four CNNs
(``workloads``), the instruction IR (``isa``), the hardware models
(``hwmodel``), the latency simulator (``latency_sim``), the tiling-based
instruction frame packages (``ifp``), the workload-balanced allocator, the
two-stage static/dynamic compiler and the discrete-event
``VirtualEngine``.  Both packages get the same inputs here and must give
identical results: every ``LayerLUT`` and ``Program`` of the static stage
over each CNN, the schedules for 1-16 cores, simulated times, and whole
engine runs of the reference tests' scenarios
(``tests/test_vengine.py``, ``test_isa_and_sim.py``,
``test_ifp_compilers.py``, ``test_allocator.py``,
``test_dynamic_compiler_cache.py``).

The compilers time themselves with ``time.perf_counter`` and the engine
adds the measured recompile time to a tenant's clock on a reconfigure, so
the parity runs pin the clock: ``time.perf_counter`` becomes a counter that
advances a fixed step per call, and both packages read the same module.

``TestTilingFunctional`` is the torch twin of
``tests/test_tiling_functional.py``: width- and output-channel-tiled conv
and matmul through the port's ``ifp._split`` equal the untiled torch ops.
"""

import dataclasses
import enum
import pathlib
import re
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import allocator as jalloc
from repro.core import ifp as jifp
from repro.core import latency_sim as jsim
from repro.core import workloads as jwl
from repro_torch.core import allocator as talloc
from repro_torch.core import ifp as tifp
from repro_torch.core import latency_sim as tsim
from repro_torch.core import workloads as twl

ROOT = pathlib.Path(__file__).resolve().parents[1]
CNNS = sorted(jcore.CNN_WORKLOADS)
STEP = 1e-5            # seconds the pinned perf_counter advances per call


def _plain(x):
    """A comparable plain-Python form of an engine result: enums by value
    (the two packages' enums are distinct classes), dataclasses, programs
    and chains as nested dicts and lists."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (jcore.Instr, tcore.Instr)):
        return (x.iid, x.op.value, x.flops, x.nbytes, x.shape, x.deps,
                x.core, sorted(x.tag.items()))
    if isinstance(x, (jcore.Program, tcore.Program)):
        return ["program", [_plain(i) for i in x.instrs]]
    if isinstance(x, (jcore.Chain, tcore.Chain)):
        return ["chain", [_plain(p) for p in x.programs]]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return sorted(([_plain(k), _plain(v)] for k, v in x.items()),
                      key=repr)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    return x


class _PinnedClock:
    """``time.perf_counter`` as a counter that advances ``STEP`` per call.
    ``reset()`` restarts it, so two runs that make the same calls read the
    same times."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += STEP
        return self.t

    def reset(self):
        self.t = 0.0


@pytest.fixture
def pinned(monkeypatch):
    clock = _PinnedClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    return clock


def _compile_pinned(core, name, n_tiles=16):
    clock = _PinnedClock()
    real = time.perf_counter
    time.perf_counter = clock
    try:
        return core.StaticCompiler(core.fpga_small_core(),
                                   n_tiles=n_tiles).compile(
            core.CNN_WORKLOADS[name]())
    finally:
        time.perf_counter = real


@pytest.fixture(scope="module")
def artifacts():
    """resnet50's static artifact from each package, compiled under a
    pinned clock: {"jax": ..., "torch": ...}."""
    return {"jax": _compile_pinned(jcore, "resnet50"),
            "torch": _compile_pinned(tcore, "resnet50")}


def _schedule(sch, art):
    """A schedule in plain form.  Its chains hold the artifact's own
    programs (cold, cached or monolithic) and the shared sync program, so
    each is named by where it lies in the artifact, which the static-stage
    test compares in full."""
    core = tcore if isinstance(sch, tcore.Schedule) else jcore
    where = {id(core.SYNC_PROGRAM): "sync"}
    for (li, strat), lut in art.luts.items():
        for ifp in lut.ifps:
            where[id(ifp.program)] = ("cold", li, strat, ifp.tile_idx)
            where[id(ifp.program_cached)] = ("cached", li, strat,
                                             ifp.tile_idx)
    for li, prog in enumerate(art.mono):
        where[id(prog)] = ("mono", li)
    layers = [[[where.get(id(p)) or _plain(p) for p in chain.programs]
               for chain in per_layer] for per_layer in sch.per_core_layers]
    return {"core_ids": sch.core_ids, "layers": layers,
            "plans": _plain(sch.plans), "seconds": sch.compile_seconds,
            "instrs": sch.instr_count, "from_cache": sch.from_cache}


def _both(pinned, fn, artifacts=None):
    """Run ``fn(core, artifact)`` for each package from a fresh pinned
    clock; returns (reference result, port result)."""
    out = []
    for key, core in (("jax", jcore), ("torch", tcore)):
        pinned.reset()
        out.append(fn(core, artifacts[key] if artifacts else None))
    return out


# ---------------------------------------------------------------------------
# the modules themselves
# ---------------------------------------------------------------------------


def test_core_exports_the_reference_names_with_the_port_chip():
    expected = (set(jcore.__all__) - {"tpu_v5e_chip"}) | {"h100_chip"}
    assert set(tcore.__all__) == expected
    for name in ("VirtualEngine", "StaticCompiler", "DynamicCompiler", "IFP",
                 "Program", "simulate", "CNN_WORKLOADS", "fpga_small_core",
                 "h100_chip"):
        assert hasattr(tcore, name)


ENGINE_MODULES = ("workloads", "isa", "hwmodel", "latency_sim", "ifp",
                  "allocator", "static_compiler", "dynamic_compiler",
                  "vengine")


@pytest.mark.parametrize("mod", ENGINE_MODULES)
def test_engine_module_imports_no_array_library(mod):
    """Each engine module is pure Python: no torch, jax or repro import."""
    src = (ROOT / "src" / "repro_torch" / "core" / f"{mod}.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    for name in imports:
        assert name.split(".")[0] not in ("torch", "jax", "repro"), name


def test_no_tpu_chip_model_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for word in ("tpu_v5e_chip", "TPU_V5E", "v5e"):
            assert word not in text, (path, word)


def test_h100_chip_carries_the_data_sheet_values():
    """h100_chip() prices the port's card with the values chip_smoke.py
    bounds its kernels by, and the wgmma matmul's CTA tile."""
    smoke = (ROOT / "chip_smoke.py").read_text()
    hbm = float(re.search(r"^HBM_BYTES_PER_S = ([\d.e]+)", smoke, re.M)[1])
    bf16 = float(re.search(r"^BF16_FLOPS_PER_S = ([\d.e]+)", smoke, re.M)[1])
    mm = (ROOT / "src" / "repro_torch" / "csrc" / "matmul.cu").read_text()
    tile = {k: int(v) for k, v in re.findall(r"TC_(B[MNK]) = (\d+)", mm)}
    hw = tcore.h100_chip()
    assert hw.mem_bw == hbm == 3.35e12
    assert hw.flops_per_sec == bf16 == 989e12
    assert hw.link_bw == 450e9
    assert hw.vmem_bytes == 132 * 228 * 1024
    assert hw.compute_tile == (tile["BM"], tile["BK"], tile["BN"])
    assert hw.instr_overhead == hw.sync_latency == 2.1e-6
    assert hw.bw_eff == tcore.HardwareModel("x", 1.0, 1.0).bw_eff


@pytest.mark.parametrize("name", ["fpga_core", "fpga_small_core",
                                  "fpga_large_core"])
def test_fpga_models_match_reference(name):
    assert _plain(getattr(tcore, name)()) == _plain(getattr(jcore, name)())
    hw_t, hw_j = getattr(tcore, name)(), getattr(jcore, name)()
    assert _plain(hw_t.scaled(2.0)) == _plain(hw_j.scaled(2.0))
    assert _plain(hw_t.with_bandwidth(0.5)) == _plain(hw_j.with_bandwidth(0.5))
    for shape in (None, (7, 3, 64), (1, 1, 1), (56, 0, 256)):
        assert hw_t.compute_time(1e9, shape) == hw_j.compute_time(1e9, shape)
    assert hw_t.memory_time(1e6) == hw_j.memory_time(1e6)
    assert hw_t.link_time(1e6) == hw_j.link_time(1e6)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CNNS)
def test_cnn_layer_tables_match_reference(name):
    j, t = jcore.CNN_WORKLOADS[name](), tcore.CNN_WORKLOADS[name]()
    assert _plain(t) == _plain(j)
    assert [l.flops for l in t] == [l.flops for l in j]
    assert [l.weight_nbytes for l in t] == [l.weight_nbytes for l in j]
    assert [l.input_nbytes() for l in t] == [l.input_nbytes() for l in j]
    assert [l.output_nbytes for l in t] == [l.output_nbytes for l in j]
    assert twl.workload_stats(t) == jwl.workload_stats(j)


@pytest.mark.parametrize("kw", [
    dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
         vocab=1000, seq=64),
    dict(n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
         vocab=151936, seq=256, batch=8, decode=True),
    dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=8, d_ff=1024,
         vocab=32000, seq=128, moe_experts=8, moe_topk=2),
])
def test_lm_layer_table_matches_reference(kw):
    t, j = twl.lm_layer_table(**kw), jwl.lm_layer_table(**kw)
    assert _plain(t) == _plain(j)
    assert twl.workload_stats(t) == jwl.workload_stats(j)


# ---------------------------------------------------------------------------
# instruction IR + latency simulator (mirrors test_isa_and_sim.py)
# ---------------------------------------------------------------------------


def _flat_hw(core, **kw):
    """1 B/s, 1 FLOP/s hardware: durations == raw flops/bytes."""
    args = dict(name="flat", flops_per_sec=1.0, mem_bw=1.0, bw_eff=1.0,
                sync_latency=0.0, instr_overhead=0.0)
    args.update(kw)
    return core.HardwareModel(**args)


def _conv_prog(core, flops):
    p = core.Program()
    p.emit(core.Op.CONV, flops=flops)
    return p


def _sim_units_overlap(core):
    p = core.Program()
    p.load(10.0)
    p.emit(core.Op.CONV, flops=10.0)
    return core.simulate(p, _flat_hw(core)), 10.0


def _sim_dependency(core):
    p = core.Program()
    a = p.load(10.0)
    p.emit(core.Op.CONV, flops=10.0, deps=[a])
    return core.simulate(p, _flat_hw(core)), 20.0


def _sim_same_unit(core):
    p = core.Program()
    p.load(10.0)
    p.load(5.0)
    return core.simulate(p, _flat_hw(core)), 15.0


def _sim_pipeline(core):
    p = core.Program()
    for _ in range(4):
        ld = p.load(10.0)
        p.emit(core.Op.CONV, flops=10.0, deps=[ld])
    return core.simulate(p, _flat_hw(core)), 50.0


def _sim_quantized(core):
    hw = _flat_hw(core, flops_per_sec=8.0, compute_tile=(1, 1, 8))
    p = core.Program()
    p.emit(core.Op.CONV, flops=8.0, shape=(1, 1, 1))
    return core.simulate(p, hw), 8.0


def _sim_barrier(core):
    hw = _flat_hw(core, sync_latency=0.5)

    def mk(f):
        return core.Chain([_conv_prog(core, f)])

    per_core = [[mk(4.0), mk(1.0)], [mk(2.0), mk(3.0)]]
    return core.simulate_layer_barrier(per_core, hw), 8.0


def _sim_chain(core):
    p1 = core.Program(); a = p1.load(4.0)
    p1.emit(core.Op.CONV, flops=3.0, deps=[a])
    p2 = core.Program(); b = p2.load(2.0)
    p2.emit(core.Op.CONV, flops=7.0, deps=[b])
    hw = _flat_hw(core)
    got = core.simulate(core.Chain([p1, p2]), hw)
    assert got == core.simulate(core.concat([p1, p2]), hw)
    return got, 14.0        # conv 7 waits for conv 3 on the one CONV unit


@pytest.mark.parametrize("case", [
    _sim_units_overlap, _sim_dependency, _sim_same_unit, _sim_pipeline,
    _sim_quantized, _sim_barrier, _sim_chain,
], ids=lambda f: f.__name__[5:])
def test_simulator_semantics_match_reference(case):
    got, want = case(tcore)
    assert got == pytest.approx(want)
    assert got == case(jcore)[0]


def test_program_builders_match_reference():
    def build(core):
        p = core.Program()
        a = p.load(10.0, kind="x", key=1)
        b = p.emit(core.Op.CONV, flops=5.0, shape=(4, 8, 16), deps=[a])
        p.save(3.0, deps=[b])
        p.sync()
        p.validate()
        bad = core.Program()
        bad.emit(core.Op.CONV, flops=1.0, deps=[5])
        with pytest.raises(ValueError):
            bad.validate()
        c = core.concat([p, p])
        c.validate()
        return (_plain(p), _plain(c), p.total_flops, p.total_bytes, len(c),
                [i.unit.value for i in c], [i.is_sync for i in c],
                _plain(core.SYNC_PROGRAM))

    t, j = build(tcore), build(jcore)
    assert t == j
    assert t[2:5] == (5.0, 13.0, 8)
    assert len(tcore.SYNC_PROGRAM) == 1 and tcore.SYNC_PROGRAM.instrs[0].is_sync


def _random_program(core, rng, n=40):
    p = core.Program()
    ops = [core.Op.LOAD, core.Op.SAVE, core.Op.CONV, core.Op.MATMUL,
           core.Op.POOL, core.Op.MISC, core.Op.CONVINIT]
    for i in range(n):
        op = ops[int(rng.integers(len(ops)))]
        deps = sorted(set(int(d) for d in rng.integers(0, i, size=2))) \
            if i else []
        shape = tuple(int(s) for s in rng.integers(1, 300, size=3))
        p.emit(op, flops=float(rng.uniform(1e3, 1e8)),
               nbytes=float(rng.uniform(1e2, 1e6)), shape=shape, deps=deps)
    return p


@pytest.mark.parametrize("seed", range(4))
def test_random_programs_simulate_identically(seed):
    progs = {}
    for key, core in (("jax", jcore), ("torch", tcore)):
        rng = np.random.default_rng(seed)
        progs[key] = (core, _random_program(core, rng))
    for hw_name in ("fpga_small_core", "fpga_large_core"):
        (jc, jp), (tc, tp) = progs["jax"], progs["torch"]
        jhw, thw = getattr(jc, hw_name)(), getattr(tc, hw_name)()
        assert tc.simulate(tp, thw) == jc.simulate(jp, jhw)
        assert tsim.simulate_with_times(tp, thw) == \
            jsim.simulate_with_times(jp, jhw)
        assert tc.roofline_terms(tp, thw) == jc.roofline_terms(jp, jhw)
    thw = tcore.h100_chip()
    assert tcore.simulate(progs["torch"][1], thw) > 0


# ---------------------------------------------------------------------------
# IFP tiling (mirrors test_ifp_compilers.py TestTiling)
# ---------------------------------------------------------------------------


def _tiling_cases():
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(12):
        w = int(rng.integers(1, 65))
        c = int(rng.integers(1, 513))
        cases.append(("W", (8, w, 16, c, 3, 3, 1), int(rng.integers(1, 33))))
        cases.append(("OC", (8, 8, 16, c, 3, 3, 1), int(rng.integers(1, 33))))
    cases.append(("OC", (56, 56, 64, 64, 3, 3, 64), 4))      # depthwise
    cases.append(("W", (7, 7, 512, 2048, 1, 1, 1), 16))      # narrow width
    return cases


@pytest.mark.parametrize("strategy,dims,n_tiles", _tiling_cases())
def test_layer_ifps_match_reference(strategy, dims, n_tiles):
    h, w, c_in, c_out, kh, kw, groups = dims
    out = {}
    for key, core, mod in (("jax", jcore, jifp), ("torch", tcore, tifp)):
        layer = core.Layer("t", h, w, c_in, c_out, kh, kw, groups=groups)
        out[key] = (layer, mod.make_layer_ifps(layer, 0,
                                               mod.Strategy(strategy),
                                               n_tiles))
    layer, ifps = out["torch"]
    assert _plain(ifps) == _plain(out["jax"][1])
    total = sum(i.program.total_flops for i in ifps)
    assert total == pytest.approx(layer.flops, rel=1e-6)
    if strategy == "W" and w < n_tiles:
        assert len(ifps) == w
    merged = tifp.dedupe_onchip([i.program for i in ifps], 4 << 20)
    assert merged.instrs
    assert _plain(merged) == _plain(jifp.dedupe_onchip(
        [i.program for i in out["jax"][1]], 4 << 20))


@pytest.mark.parametrize("total,parts", [(7, 16), (14, 3), (64, 64),
                                         (1, 1), (100, 7)])
def test_split_matches_reference(total, parts):
    assert tifp._split(total, parts) == jifp._split(total, parts)
    assert sum(tifp._split(total, parts)) == total


# ---------------------------------------------------------------------------
# the allocator (mirrors test_allocator.py)
# ---------------------------------------------------------------------------


def _alloc_cases():
    rng = np.random.default_rng(11)
    return [(list(map(float, rng.uniform(1e-3, 10.0,
                                         size=int(rng.integers(1, 25))))),
             int(rng.integers(1, 17)), float(rng.uniform(0.0, 1.0)))
            for _ in range(10)]


@pytest.mark.parametrize("times,k,overhead", _alloc_cases())
def test_allocators_match_reference(times, k, overhead):
    for name in ("allocate_contiguous_bs", "allocate_contiguous_dp"):
        got = getattr(talloc, name)(times, k, run_overhead=overhead)
        assert got == getattr(jalloc, name)(times, k, run_overhead=overhead)
    runs, ms = talloc.allocate_contiguous_bs(times, k, run_overhead=overhead)
    flat = [i for r in runs for i in r]
    assert flat == list(range(len(times))) and len(runs) == k
    assert ms == pytest.approx(talloc.allocate_contiguous_dp(
        times, k, run_overhead=overhead)[1], rel=1e-9)
    pre = talloc.partition_candidates(times, run_overhead=overhead)
    assert pre == jalloc.partition_candidates(times, run_overhead=overhead)
    assert talloc.allocate_contiguous_bs(
        times, k, run_overhead=overhead, precomputed=pre) == (runs, ms)
    assert talloc.allocate_lpt(times, k) == jalloc.allocate_lpt(times, k)
    _, ms_lpt = talloc.allocate_lpt(times, k)
    assert ms_lpt <= sum(times) / k + max(times) + 1e-9
    assert talloc.allocate(times, k, run_overhead=overhead) == \
        jalloc.allocate(times, k, run_overhead=overhead)
    speeds = [1.0 + 0.25 * (i % 3) for i in range(max(1, k // 2))]
    assert talloc.allocate_weighted(times, speeds) == \
        jalloc.allocate_weighted(times, speeds)


def test_weighted_slow_core_gets_less():
    runs, _ = talloc.allocate_weighted([1.0] * 16, [1.0, 1.0, 1.0, 0.25])
    loads = [len(r) for r in runs]
    assert loads[3] == min(loads) and loads[3] <= loads[0] / 2
    assert runs == jalloc.allocate_weighted([1.0] * 16,
                                            [1.0, 1.0, 1.0, 0.25])[0]


# ---------------------------------------------------------------------------
# the two-stage compiler (mirrors test_ifp_compilers.py and
# test_dynamic_compiler_cache.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CNNS)
def test_static_stage_matches_reference(name):
    """Every LayerLUT (its IFPs, cold and cached programs, latencies and the
    allocator's precomputed candidates) and every monolithic program of
    StaticCompiler(fpga_small_core()) over the CNN."""
    j, t = _compile_pinned(jcore, name), _compile_pinned(tcore, name)
    assert j.compile_seconds == t.compile_seconds == STEP
    assert _plain(t) == _plain(j)
    assert len(t.luts) == 2 * len(t.workload)
    for lut in t.luts.values():
        assert len(lut.ifps) == len(lut.cold) == len(lut.cached)
        for ifp in lut.ifps:
            assert ifp.latency_cached <= ifp.latency + 1e-12


def test_compile_monolithic_matches_reference():
    for name in CNNS:
        for groups in (2, 8):
            t = tcore.compile_monolithic(tcore.CNN_WORKLOADS[name](),
                                         tcore.fpga_large_core(),
                                         load_groups=groups)
            j = jcore.compile_monolithic(jcore.CNN_WORKLOADS[name](),
                                         jcore.fpga_large_core(),
                                         load_groups=groups)
            assert _plain(t) == _plain(j)


@pytest.mark.parametrize("fastpath", [True, False])
def test_schedules_for_1_to_16_cores_match_reference(pinned, artifacts,
                                                     fastpath):
    def run(core, art):
        dyn = core.DynamicCompiler(art)
        hw = core.fpga_small_core()
        out = []
        for k in range(1, 17):
            sch = dyn.compile(list(range(k)), single_core_fastpath=fastpath)
            out.append((_schedule(sch, art), sch.estimated_latency(hw),
                        sch.transfer_bytes,
                        dyn.context_switch_cost(sch, hw)))
        return out

    j, t = _both(pinned, run, artifacts)
    assert t == j
    art = artifacts["torch"]
    dyn = tcore.DynamicCompiler(art)
    for k in (1, 2, 5, 16):                 # every IFP assigned once
        sch = dyn.compile(list(range(k)), single_core_fastpath=False)
        for li, plan in enumerate(sch.plans):
            lut = art.lut(li, plan.strategy)
            assert sorted(i for r in plan.assignment for i in r) == \
                list(range(len(lut.ifps)))


def test_heterogeneous_schedules_match_reference(pinned, artifacts):
    def run(core, art):
        dyn = core.DynamicCompiler(art)
        out = []
        for speeds in ([1.0, 1.0, 1.0, 0.5], [0.25, 1.0, 2.0, 1.0, 1.0],
                       [1.0 / 3.0] + [1.0] * 7):
            sch = dyn.compile(list(range(len(speeds))), core_speeds=speeds)
            out.append(_schedule(sch, art))
        out.append([dyn.cache_hits, dyn.cache_misses])
        return out

    j, t = _both(pinned, run, artifacts)
    assert t == j


def test_chain_matches_dedupe_reference(artifacts):
    """The zero-copy chain runs in exactly the time of the instruction-file
    concatenation with on-chip reuse dedupe, in the port."""
    art = artifacts["torch"]
    hw = tcore.fpga_small_core()
    sch = tcore.DynamicCompiler(art).compile(list(range(3)),
                                             single_core_fastpath=False)
    for li, plan in enumerate(sch.plans):
        lut = art.lut(li, plan.strategy)
        for c, idxs in enumerate(plan.assignment):
            if not idxs:
                continue
            merged = tifp.dedupe_onchip([lut.ifps[i].program for i in idxs],
                                        hw.vmem_bytes)
            merged.sync()
            assert tcore.simulate(sch.per_core_layers[c][li], hw) == \
                pytest.approx(tcore.simulate(merged, hw), rel=1e-9)
            assert sch.per_core_layers[c][li].programs[-1].instrs[-1].is_sync


def test_fastpath_and_opt_choice(artifacts):
    art = artifacts["torch"]
    hw = tcore.fpga_small_core()
    dyn = tcore.DynamicCompiler(art)
    est = dyn.compile([7]).estimated_latency(hw)
    mono = sum(art.mono_latency) + len(art.mono) * hw.sync_latency
    assert est == pytest.approx(mono, rel=1e-6)
    k = 4
    t_opt = dyn.compile(list(range(k)),
                        single_core_fastpath=False).estimated_latency(hw)
    for strat in (tcore.Strategy.WIDTH, tcore.Strategy.OC):
        t_forced = 0.0
        for li in range(len(art.workload)):
            lut = art.lut(li, strat)
            _, ms = tcore.allocate(lut.cached, k,
                                   run_overhead=lut.run_overhead,
                                   precomputed=lut.precomputed)
            t_forced += ms + hw.sync_latency
        assert t_opt <= t_forced * 1.02 + 1e-9


def test_dynamic_stage_much_faster_than_static():
    """Real clock: the online stage is at least 20x faster than the offline
    one (the paper's O(1 ms) against O(10 s))."""
    art = tcore.StaticCompiler(tcore.fpga_small_core(), n_tiles=16).compile(
        tcore.CNN_WORKLOADS["resnet50"]())
    dyn = tcore.DynamicCompiler(art)
    best = min(dyn.compile(list(range(8))).compile_seconds for _ in range(5))
    assert best < art.compile_seconds / 20
    cost = dyn.context_switch_cost(dyn.compile(list(range(4))),
                                   tcore.fpga_small_core())
    assert cost["t_context"] == pytest.approx(cost["t_recompile"]
                                              + cost["t_transfer"])
    assert cost["t_context"] < 0.05


def test_schedule_lru_matches_reference(pinned, artifacts):
    def run(core, art):
        hw = core.fpga_small_core()
        dyn = core.DynamicCompiler(art)
        a = dyn.compile([0, 1, 2, 3])
        b = dyn.compile([2, 3])
        assert dyn.cache_hits == 0 and dyn.cache_misses == 2
        c = dyn.compile([4, 5, 6, 7])
        assert dyn.cache_hits == 1 and c.from_cache and not a.from_cache
        assert c.core_ids == [4, 5, 6, 7]
        assert c.per_core_layers is a.per_core_layers
        cost_c = dyn.context_switch_cost(c, hw)
        assert cost_c["cache_hit"] == 1.0 and cost_c["cache_hits"] == 1.0
        d = dyn.compile([0, 1, 2, 3], core_speeds=[1.0, 1.0, 1.0, 0.5])
        e = dyn.compile([0, 1, 2, 3], core_speeds=[1.0, 1.0, 1.0, 0.5])
        assert not d.from_cache and e.from_cache
        small = core.DynamicCompiler(art, cache_size=2)
        small.compile([0])
        small.compile([0, 1])
        small.compile([0, 1, 2])
        assert not small.compile([0]).from_cache
        return [_schedule(s, art) for s in (a, b, c, d, e)] + [
            cost_c, dyn.context_switch_cost(b, hw),
            [dyn.cache_hits, dyn.cache_misses,
             small.cache_hits, small.cache_misses]]

    j, t = _both(pinned, run, artifacts)
    assert t == j


# ---------------------------------------------------------------------------
# the virtual engine (mirrors test_vengine.py), under the pinned clock
# ---------------------------------------------------------------------------

HORIZON = 1.0


def _engine_result(eng, horizon=None, **run_kw):
    metrics = eng.run(horizon, **run_kw) if horizon is not None \
        else eng.metrics()
    return {"metrics": _plain(metrics),
            "alloc": {n: sorted(eng.pool.lease_of(n).cores)
                      for n in eng.tenants},
            "free": sorted(eng.pool.free_cores())}


def _isolation(core, art):
    """Paper Fig 5: <1% deviation for a fixed tenant whatever the
    co-tenants' mix; a lease past the free cores is refused."""
    out, fps = [], []
    for others in ([], [8], [4, 4], [2, 3, 3]):
        eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
        eng.admit("fixed", art, 8)
        for i, n in enumerate(others):
            eng.admit(f"bg{i}", art, n)
        fps.append(eng.run(HORIZON)["fixed"].throughput(HORIZON))
        out.append(_engine_result(eng))
    assert (max(fps) - min(fps)) / max(fps) < 0.01
    eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    eng.admit("a", art, 10)
    with pytest.raises(core.HRPError):
        eng.admit("b", art, 10)
    return [fps, out]


def _resize(core, art):
    eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    eng.admit("t", art, 4)
    eng.request_resize("t", 12, at=0.2)
    res = _engine_result(eng, HORIZON)
    m = eng.metrics()["t"]
    assert m.ctx_switches == 1 and 0 < m.ctx_overhead < 0.05
    assert eng.pool.lease_of("t").n_cores == 12
    return res


def _grow(core, art):
    base_eng = core.VirtualEngine(core.ResourcePool(16),
                                  core.fpga_small_core())
    base_eng.admit("t", art, 2)
    base = base_eng.run(HORIZON)["t"].throughput(HORIZON)
    eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    eng.admit("t", art, 2)
    eng.request_resize("t", 16, at=0.05)
    grown = eng.run(HORIZON)["t"].throughput(HORIZON)
    assert grown > base * 1.5
    return [base, grown, _engine_result(eng)]


def _layer_switch(core, art):
    eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    eng.admit("t", art, 4)
    eng.request_resize("t", 8, at=1e-4, mode=core.SwitchMode.LAYER_LEVEL)
    res = _engine_result(eng, 5.0, max_inferences=4)
    m = eng.metrics()["t"]
    assert m.ctx_switches == 1 and len(m.completions) >= 1
    assert eng.pool.lease_of("t").n_cores == 8
    return res


def _shrink_release(core, art):
    eng = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    eng.admit("t", art, 16)
    eng.request_resize("t", 4, at=0.01)
    res = _engine_result(eng, 0.2)
    assert len(eng.pool.free_cores()) == 12
    eng.remove("t")
    assert len(eng.pool.free_cores()) == 16
    return [res, _engine_result(eng)]


def _stragglers(core, art):
    bad = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core())
    bad.admit("t", art, 8)
    bad.core_slowdown[0] = 3.0
    hit = bad.run(HORIZON)["t"].throughput(HORIZON)
    fix = core.VirtualEngine(core.ResourcePool(16), core.fpga_small_core(),
                             mitigate_stragglers=True,
                             straggler_threshold=1.3)
    fix.admit("t", art, 8)
    fix.core_slowdown[0] = 3.0
    m = fix.run(HORIZON)["t"]
    assert m.rebalances >= 1 and m.throughput(HORIZON) > hit * 1.2
    healthy = core.VirtualEngine(core.ResourcePool(16),
                                 core.fpga_small_core(),
                                 mitigate_stragglers=True)
    healthy.admit("t", art, 8)
    assert healthy.run(0.5)["t"].rebalances == 0
    return [hit, _plain(m), _engine_result(healthy)]


def _hypervisor_churn(core, art):
    """Arrivals, a departure and policy-driven resizes through the
    Hypervisor with the engine as its executor, plus open-loop traffic."""
    pool = core.ResourcePool(16)
    eng = core.VirtualEngine(pool, core.fpga_small_core())
    hv = core.Hypervisor(pool, policy="even_split", executor=eng)
    hv.schedule_arrival(core.TenantSpec("a", 8, artifact=art), at=0.0)
    hv.schedule_arrival(core.TenantSpec("b", 8, artifact=art), at=0.1)
    hv.schedule_arrival(core.TenantSpec("c", 4, artifact=art), at=0.2)
    hv.schedule_departure("b", at=0.5)
    records = hv.open_traffic("c", core.PoissonTraffic(rate=20.0, seed=3),
                              0.8, slo=0.05)
    metrics = hv.run(1.0)
    assert any(r.t_complete is not None for r in records)
    return {"run": _plain(metrics), "engine": _engine_result(eng),
            "alloc": hv.allocation(), "records": _plain(records)}


@pytest.mark.parametrize("scenario", [
    _isolation, _resize, _grow, _layer_switch, _shrink_release, _stragglers,
    _hypervisor_churn,
], ids=lambda f: f.__name__[1:])
def test_engine_runs_match_reference(pinned, artifacts, scenario):
    j, t = _both(pinned, scenario, artifacts)
    assert t == j


# ---------------------------------------------------------------------------
# tiling is exact (torch twin of test_tiling_functional.py)
# ---------------------------------------------------------------------------


def _conv2d(x, w):
    """x: (H, W, Cin); w: (kh, kw, Cin, Cout), SAME padding, stride 1."""
    out = F.conv2d(x.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1),
                   padding=(w.shape[0] // 2, w.shape[1] // 2))
    return out[0].permute(1, 2, 0)


def _valid_conv2d(x, w):
    return F.conv2d(x.permute(2, 0, 1)[None],
                    w.permute(3, 2, 0, 1))[0].permute(1, 2, 0)


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((14, 14, 32)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((3, 3, 32, 64)) * 0.1).astype(np.float32))
    return x, w


class TestTilingFunctional:
    @pytest.mark.parametrize("n_tiles", [2, 3, 7, 14])
    def test_width_tiling_exact(self, conv_case, n_tiles):
        """Width tiles with a halo of kw//2 input columns, stitched, equal
        the untiled conv."""
        x, w = conv_case
        ref = _conv2d(x, w)
        H, W, _ = x.shape
        halo_h, halo = w.shape[0] // 2, w.shape[1] // 2
        outs, col = [], 0
        for wc in tifp._split(W, n_tiles):
            lo, hi = max(col - halo, 0), min(col + wc + halo, W)
            pad_l = halo - (col - lo)
            pad_r = halo - (hi - (col + wc))
            xin = F.pad(x[:, lo:hi, :], (0, 0, pad_l, pad_r, halo_h, halo_h))
            outs.append(_valid_conv2d(xin, w))
            col += wc
        got = torch.cat(outs, dim=1)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("n_tiles", [2, 4, 16, 64])
    def test_oc_tiling_exact(self, conv_case, n_tiles):
        x, w = conv_case
        ref = _conv2d(x, w)
        outs, c = [], 0
        for co in tifp._split(w.shape[-1], n_tiles):
            outs.append(_conv2d(x, w[..., c:c + co]))
            c += co
        torch.testing.assert_close(torch.cat(outs, dim=-1), ref,
                                   rtol=1e-5, atol=1e-5)

    @pytest.fixture(scope="class")
    def mm_case(self):
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
        w = torch.from_numpy(
            (rng.standard_normal((128, 256)) * 0.05).astype(np.float32))
        return x, w

    @staticmethod
    def _chunks(t, n, dim):
        sizes = tifp._split(t.shape[dim], n)
        return torch.split(t, sizes, dim=dim)

    @pytest.mark.parametrize("n", [2, 3, 16])
    def test_token_tiling(self, mm_case, n):
        x, w = mm_case
        got = torch.cat([c @ w for c in self._chunks(x, n, 0)], 0)
        torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("n", [2, 3, 16])
    def test_oc_matmul_tiling(self, mm_case, n):
        x, w = mm_case
        got = torch.cat([x @ c for c in self._chunks(w, n, 1)], 1)
        torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)

    def test_mixed_per_layer_choice(self, mm_case):
        """W-tiling on layer 1 and OC-tiling on layer 2: the dynamic
        compiler's per-layer strategy mix is functionally free."""
        x, w = mm_case
        w2 = w.T * 0.1
        ref = torch.relu(x @ w) @ w2
        h = torch.relu(torch.cat([c @ w for c in self._chunks(x, 4, 0)], 0))
        got = torch.cat([h @ c for c in self._chunks(w2, 8, 1)], 1)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
