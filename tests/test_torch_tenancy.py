"""The port's hypervisor and tenancy layer on the CPU, against the JAX package.

Hypervisor: ``repro_torch.core`` is a copy of ``repro.core``'s scheduling
modules; each seeded script below drives both packages' ``Hypervisor`` over
their own recording executor and must give identical ``run()`` results,
decision histories (allocation, kv leases and wait queue after every
event), logs and telemetry counters, for every policy in ``POLICIES``, the
three admission orders, preemption, core faults, kv-page leases and
open-loop traffic.

Tenancy: mirrors of the reference's tenancy tests (``tests/test_serving.py``
``TestTenancy`` and the resize between chunks, ``tests/test_paging.py``'s
paged migration and kv-lease loop, ``tests/test_prefix.py``'s shared-kv
accounting, ``tests/test_slo.py``'s executor SLO plumbing,
``tests/test_speculative.py``'s draft-state migration) on the port's
``VirtualAcceleratorPool`` over repeated CPU devices; tokens across a
resize between chunks equal an uninterrupted run of the port and the
reference's batcher on the same requests (f32, reduced qwen3-0.6b, weights
from ``repro.models.init_params`` through ``weights.params_from_jax``).
"""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch.configs import get_config, get_reduced
from repro_torch.serving import (
    ContinuousBatcher, Request, ServingConfig, TensorSpec, TwoStageCompiler,
    ServingExecutor, VirtualAcceleratorPool, make_serving_hypervisor,
)
from repro_torch.device import tree_to_device
from repro_torch.serving.tenancy import HBM_BYTES_PER_DEVICE, CompiledProgram
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the hypervisor: one script, both packages, identical decisions
# ---------------------------------------------------------------------------


def _norm(x):
    """A comparable plain-Python form of a hypervisor result."""
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_norm(v) for v in x)
    return x


def _recorder(core):
    """A bookkeeping executor over ``core``'s ``PoolExecutor`` that logs
    every decision, sheds a request delivered past its deadline, finishes
    the others after a service time that shrinks with the lease, and prices
    latency for ``latency_slo``."""

    class Recorder(core.PoolExecutor):
        def __init__(self, pool):
            super().__init__(pool)
            self.log = []
            self.completion_sink = None

        def exec_admit(self, spec, n_cores, at):
            super().exec_admit(spec, n_cores, at)
            self.log.append(("admit", spec.name, n_cores, at))

        def exec_resize(self, name, n_cores, at, mode):
            super().exec_resize(name, n_cores, at, mode)
            self.log.append(("resize", name, n_cores, at, mode.value))

        def exec_remove(self, name, at):
            super().exec_remove(name, at)
            self.log.append(("remove", name, at))

        def exec_evict(self, name, at):
            self.pool.release(name)
            self.log.append(("evict", name, at))

        def exec_kv_resize(self, name, pages, at):
            self.log.append(("kv", name, pages, at))

        def exec_fault(self, fault, at):
            self.log.append(("fault", _norm(fault), at))

        def exec_recover(self, fault, at):
            self.log.append(("recover", _norm(fault), at))

        def exec_request(self, name, record, at):
            if record.deadline is not None and at > record.deadline:
                record.dropped = True
                self.log.append(("drop", name, record.rid, at))
                return
            lease = self.pool.lease_of(name)
            record.t_start = at
            record.t_complete = at + 0.4 / max(lease.n_cores, 1)
            self.log.append(("request", name, record.rid, at))
            if self.completion_sink is not None:
                self.completion_sink(record)

        def estimate_latency(self, spec, n_cores):
            return 0.8 / n_cores

        def metrics(self):
            return {"log": list(self.log)}

    return Recorder


def _run_script(core, script, **hv_kwargs):
    history = []

    def on_event(hv, ev):
        history.append((ev.kind.value, ev.time, ev.tenant, hv.allocation(),
                        hv.kv_allocation(), hv.waiting_tenants()))

    n_cores, n_kv = script.get("pool", (16, 0))
    pool = core.ResourcePool(n_cores, n_kv_pages=n_kv)
    ex = _recorder(core)(pool)
    hv = core.Hypervisor(pool, executor=ex, on_event=on_event, **hv_kwargs)
    records = script["drive"](core, hv)
    result = hv.run(script["horizon"])
    return _norm({
        "run": result,
        "history": history,
        "allocation": hv.allocation(),
        "kv": hv.kv_allocation(),
        "waiting": hv.waiting_tenants(),
        "preemptions": hv.preemptions,
        "recovery": hv.recovery_log,
        "faults": hv.fault_log,
        "completions": [(r.tenant, r.rid, r.t_complete)
                        for r in hv.completion_log],
        "records": [(r.tenant, r.rid, r.t_arrival, r.t_start, r.t_complete,
                     r.dropped, r.deadline) for r in records or []],
        "clock": hv.clock,
        "counters": hv.telemetry.registry.snapshot(),
    })


def _drive_policy_mix(core, hv):
    """Four tenants arrive, one resizes, two depart; SLO tenants declare
    targets and arrival rates, one tenant carries a weight."""
    T = core.TenantSpec
    hv.schedule_arrival(T("a", 8, min_cores=2, priority=1.0, weight=3.0,
                          latency_slo=0.3, arrival_rate=2.0), at=0.0)
    hv.schedule_arrival(T("b", 6, min_cores=1, priority=3.0,
                          latency_slo=0.5, arrival_rate=1.0), at=0.1)
    hv.schedule_arrival(T("c", 12, min_cores=4, priority=2.0, weight=1.0),
                        at=0.2)
    hv.schedule_arrival(T("d", 3, priority=0.5, latency_slo=0.9), at=0.3)
    hv.schedule_reconfig("a", 12, at=0.5)
    hv.schedule_departure("b", at=0.7)
    hv.schedule_arrival(T("e", 5, min_cores=3, priority=2.5), at=0.8)
    hv.schedule_departure("c", at=1.1)
    hv.schedule_reconfig("d", 1, at=1.3)
    return None


def _drive_admission(core, hv):
    """A big head blocks a small pool; small tenants queue behind it and
    departures free cores in steps."""
    T = core.TenantSpec
    hv.schedule_arrival(T("r1", 4, min_cores=4), at=0.0)
    hv.schedule_arrival(T("r2", 3, min_cores=3), at=0.1)
    hv.schedule_arrival(T("big", 6, min_cores=6), at=0.2)
    hv.schedule_arrival(T("s1", 1, min_cores=1), at=0.3)
    hv.schedule_arrival(T("s2", 1, min_cores=1), at=0.4)
    hv.schedule_departure("r2", at=0.6)
    hv.schedule_arrival(T("s3", 2, min_cores=2), at=0.7)
    hv.schedule_departure("r1", at=1.0)
    hv.schedule_departure("s1", at=1.2)
    hv.schedule_departure("s2", at=1.4)
    return None


def _drive_preemption(core, hv):
    T = core.TenantSpec
    hv.schedule_arrival(T("lo", 5, min_cores=4, priority=1.0,
                          latency_slo=2.0), at=0.0)
    hv.schedule_arrival(T("mid", 3, min_cores=3, priority=2.0), at=0.1)
    hv.schedule_arrival(T("hi", 6, min_cores=6, priority=5.0), at=0.2)
    hv.schedule_departure("hi", at=0.6)
    hv.schedule_arrival(T("top", 8, min_cores=8, priority=9.0), at=0.9)
    hv.schedule_departure("top", at=1.5)
    return None


def _drive_faults(core, hv):
    """Immediate-mode core deaths and repairs, then a seeded injector's
    deaths, slowdowns and kv corruptions on the timeline."""
    T = core.TenantSpec
    assert hv.admit(T("a", 6, min_cores=2), at=0.0)
    assert hv.admit(T("b", 6, min_cores=2), at=0.0)
    owned = sorted(hv.pool.lease_of("a").cores)
    hv.fail_core(owned[0], at=0.05)
    hv.fail_core(owned[1], at=0.06, duration=0.3)
    hv.recover_core(owned[0], at=0.1)
    inj = core.FaultInjector(n_cores=hv.pool.n_cores, seed=3,
                             death_rate=2.0, slow_rate=1.5,
                             corrupt_rate=1.0, n_kv_pages=32,
                             repair_after=0.25)
    inj.inject(hv.queue, 2.0)
    hv.schedule_arrival(T("c", 4, min_cores=3), at=0.5)
    hv.schedule_departure("b", at=1.2)
    return None


def _drive_kv(core, hv):
    """kv-page leases: floors, a shared prefix set, arrivals that re-split
    the pages, departures that return them."""
    T = core.TenantSpec
    assert hv.admit(T("t", 4, requested_kv_pages=40, min_kv_pages=8), at=0.0)
    hv.pool.note_shared_kv("t", 12)
    assert hv.admit(T("u", 4, requested_kv_pages=40, min_kv_pages=8), at=0.1)
    hv.schedule_arrival(T("v", 4, requested_kv_pages=10, min_kv_pages=30),
                        at=0.2)
    hv.schedule_arrival(T("w", 2, requested_kv_pages=16, min_kv_pages=4),
                        at=0.3)
    hv.schedule_departure("u", at=0.6)
    hv.schedule_reconfig("t", 8, at=0.8)
    hv.schedule_departure("t", at=1.0)
    return None


def _drive_traffic(core, hv):
    """Open-loop Poisson and trace traffic with SLOs and drop deadlines;
    one tenant waits for admission while its requests back up."""
    T = core.TenantSpec
    hv.schedule_arrival(T("p", 10, min_cores=6, arrival_rate=20.0,
                          latency_slo=0.2), at=0.0)
    hv.schedule_arrival(T("q", 10, min_cores=10, open_loop=True), at=0.0)
    recs = hv.open_traffic("p", core.PoissonTraffic(20.0, seed=7), 1.5,
                           slo=0.2, deadline_after=0.5)
    recs += hv.open_traffic("q", core.TraceTraffic([0.05 * i for i in
                                                    range(12)]), 1.5,
                            slo=0.1, deadline_after=0.3)
    hv.schedule_departure("p", at=0.7)
    return recs


SCRIPTS = {
    "policy_mix": dict(drive=_drive_policy_mix, horizon=2.0),
    "admission": dict(pool=(8, 0), drive=_drive_admission, horizon=2.0),
    "preemption": dict(pool=(10, 0), drive=_drive_preemption, horizon=2.0),
    "faults": dict(pool=(12, 32), drive=_drive_faults, horizon=2.0),
    "kv": dict(pool=(16, 64), drive=_drive_kv, horizon=2.0),
    "traffic": dict(pool=(16, 0), drive=_drive_traffic, horizon=2.0),
}

CASES = (
    [pytest.param("policy_mix", dict(policy=p), id=f"policy-{p}")
     for p in sorted(jcore.POLICIES)]
    + [pytest.param("admission", dict(policy="even_split", admission=a),
                    id=f"admission-{a}") for a in ("fifo", "backfill", "easy")]
    + [pytest.param("preemption", dict(policy=p, preemptive=True),
                    id=f"preemption-{p}") for p in ("priority", "latency_slo")]
    + [pytest.param("faults", dict(policy="even_split",
                                   fault_retry_backoff=0.03), id="faults"),
       pytest.param("kv", dict(policy="even_split"), id="kv-even_split"),
       pytest.param("kv", dict(policy="priority"), id="kv-priority"),
       pytest.param("traffic", dict(policy="latency_slo"),
                    id="traffic-latency_slo"),
       pytest.param("traffic", dict(policy="even_split",
                                    probe_interval=0.25),
                    id="traffic-probes")]
)


def test_port_has_every_policy():
    assert sorted(tcore.POLICIES) == sorted(jcore.POLICIES)
    assert [k.value for k in tcore.EventKind] == \
        [k.value for k in jcore.EventKind]
    assert [k.value for k in tcore.FaultKind] == \
        [k.value for k in jcore.FaultKind]


@pytest.mark.parametrize("name,kwargs", CASES)
def test_hypervisor_decisions_match_reference(name, kwargs):
    script = SCRIPTS[name]
    want = _run_script(jcore, script, **kwargs)
    got = _run_script(tcore, script, **kwargs)
    assert len(want["history"]) > 5
    for key in want:
        assert got[key] == want[key], key


def test_scripts_exercise_what_they_name():
    """Each script reaches the mechanism it stands for in the reference."""
    def events(res):
        return {h[0] for h in res["history"]}

    pre = _run_script(jcore, SCRIPTS["preemption"], policy="priority",
                      preemptive=True)
    assert pre["preemptions"]
    faults = _run_script(jcore, SCRIPTS["faults"], policy="even_split",
                         fault_retry_backoff=0.03)
    assert faults["recovery"] and {"failure", "recovery"} <= events(faults)
    kv = _run_script(jcore, SCRIPTS["kv"], policy="even_split")
    assert any(e[0] == "kv" for e in kv["run"]["log"])
    traffic = _run_script(jcore, SCRIPTS["traffic"], policy="latency_slo")
    assert traffic["completions"] and any(r[5] for r in traffic["records"])
    fifo, backfill = (_run_script(jcore, SCRIPTS["admission"],
                                  policy="even_split", admission=a)
                      for a in ("fifo", "backfill"))
    assert fifo["history"] != backfill["history"]


def test_hrp_errors_match_reference():
    for core in (jcore, tcore):
        pool = core.ResourcePool(4, n_kv_pages=8)
        pool.alloc("t", 2)
        with pytest.raises(core.HRPError):
            pool.alloc("u", 3)
        with pytest.raises(core.HRPError):
            pool.note_shared_kv("ghost", 1)
        with pytest.raises(ValueError):
            core.Hypervisor(pool, admission="lifo")


# ---------------------------------------------------------------------------
# the serving adapter: pool, two-stage compiler, executor
# ---------------------------------------------------------------------------


def _vpool(n=4, **kw):
    return VirtualAcceleratorPool(devices=[CPU] * n, devices_per_core=1, **kw)


def test_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VirtualAcceleratorPool()


def test_hbm_budget_is_the_h100_data_sheet():
    assert HBM_BYTES_PER_DEVICE == 80 * 10**9


class TestTenancy:
    """Mirror of ``tests/test_serving.py::TestTenancy``."""

    def test_pool_leases_disjoint_meshes(self):
        pool = VirtualAcceleratorPool(devices=[CPU] * 8, devices_per_core=1,
                                      cores_per_group=4)
        la = pool.lease("a", 2)
        lb = pool.lease("b", 2)
        assert not set(la.cores) & set(lb.cores)
        ma = pool.mesh_for(la)
        assert ma.shape == (2, 1) and ma.dtype == object
        assert all(d == CPU for d in ma.flat)
        tp = pool.tp_mesh_for(la)
        assert tp.shape == (2,)

    def test_devices_per_core_groups_devices(self):
        devs = [torch.device("cpu", 0)] * 6
        pool = VirtualAcceleratorPool(devices=devs, devices_per_core=2)
        assert pool.n_cores == 3
        lease = pool.lease("t", 2)
        assert pool.mesh_for(lease).shape == (2, 2)
        assert pool.tp_mesh_for(lease).shape == (4,)

    def test_hbm_admission_control(self):
        from repro_torch.core.hrp import HRPError

        pool = _vpool(4)
        lease = pool.lease("t", 1)
        big = get_config("command-r-plus-104b")      # 104B params never fit 1 dev
        with pytest.raises(HRPError):
            pool.check_hbm(big, lease, batch=1, max_len=1024)
        with pytest.raises(HRPError):
            pool.check_hbm_paged(big, lease, n_pages=64, page_size=16)
        small = get_reduced("qwen3-0.6b")
        pool.check_hbm(small, lease, batch=2, max_len=64)   # fits fine
        pool.check_hbm_paged(small, lease, n_pages=64, page_size=16)
        # qwen3-0.6b at full width: 1.2 GB of bf16 params fit one H100
        pool.check_hbm(get_config("qwen3-0.6b"), lease, batch=8, max_len=322)

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_hbm_counts_distinct_devices(self, paged):
        """A 16-core lease over one repeated device holds one device's
        memory: ~208 GB of command-r-plus-104b bf16 params are refused,
        where the reference credits 16 devices (its logged deviation,
        ROADMAP.md Queue 3) and admits them."""
        from repro.serving.tenancy import VirtualAcceleratorPool as JaxPool
        from repro_torch.core.hrp import HRPError

        big = get_config("command-r-plus-104b")
        jpool = JaxPool(devices=[jax.devices("cpu")[0]] * 16)
        jlease = jpool.lease("t", 16)
        pool = _vpool(16)
        lease = pool.lease("t", 16)
        assert pool.lease_devices(lease) == [CPU]
        if paged:
            jpool.check_hbm_paged(big, jlease, n_pages=512,
                                  page_size=16)
            with pytest.raises(HRPError, match="1 device"):
                pool.check_hbm_paged(big, lease, n_pages=512, page_size=16)
        else:
            jpool.check_hbm(big, jlease, batch=8, max_len=1024)
            with pytest.raises(HRPError, match="1 device"):
                pool.check_hbm(big, lease, batch=8, max_len=1024)

    def test_hbm_sums_co_resident_tenants(self):
        """Two 8-core tenants of qwen3-32b (~66 GB of params and KV each)
        on one device: each fits alone, the second is refused beside the
        first (the reference admits both), and admitted after the first's
        release."""
        from repro.serving.tenancy import VirtualAcceleratorPool as JaxPool
        from repro_torch.core.hrp import HRPError

        mid = get_config("qwen3-32b")
        jpool = JaxPool(devices=[jax.devices("cpu")[0]] * 16)
        for name in ("a", "b"):
            jpool.check_hbm(mid, jpool.lease(name, 8), batch=8, max_len=1024)
        pool = _vpool(16)
        la, lb = pool.lease("a", 8), pool.lease("b", 8)
        pool.check_hbm(mid, lb, batch=8, max_len=1024)      # b fits alone
        pool.release("b")
        lb = pool.lease("b", 8)
        pool.check_hbm(mid, la, batch=8, max_len=1024)
        pool.check_hbm(mid, la, batch=8, max_len=1024)      # a re-checks: no double count
        with pytest.raises(HRPError, match="beside"):
            pool.check_hbm(mid, lb, batch=8, max_len=1024)
        with pytest.raises(HRPError, match="beside"):
            pool.check_hbm_paged(mid, lb, n_pages=64, page_size=16)
        pool.release("a")
        pool.check_hbm(mid, lb, batch=8, max_len=1024)

    def test_two_stage_reconfigure_uses_cache(self):
        """Online reconfigure must never re-run the static stage: it resizes
        the lease and swaps in the warmed program (~ms)."""
        pool = _vpool(4)
        comp = TwoStageCompiler(pool)
        calls = []

        def program(x):
            calls.append((tuple(x.shape), x.dtype, x.device))
            return x * 2.0

        progs = comp.static_compile("toy", program,
                                    (TensorSpec((8,), torch.float32),),
                                    lease_sizes=[1, 2, 4])
        assert set(progs) == {1, 2, 4}
        assert calls == [((8,), torch.float32, CPU)] * 3
        static_cost = sum(p.compile_seconds + p.lowered_seconds
                          for p in progs.values())

        pool.lease("t", 1)
        prog, _, timing = comp.reconfigure("t", "toy", 4)
        assert prog.n_cores == 4 and len(calls) == 3
        assert set(timing) == {"t_lookup", "t_migrate", "t_context"}
        assert timing["t_context"] < max(0.05, static_cost / 10)
        out = prog.executable(torch.ones(8))
        assert torch.equal(out, torch.full((8,), 2.0))

    def test_reconfigure_uncovered_size_raises(self):
        from repro_torch.core.hrp import HRPError

        pool = _vpool(4)
        comp = TwoStageCompiler(pool)
        pool.lease("t", 1)
        with pytest.raises(HRPError):
            comp.reconfigure("t", "missing", 2)


def test_static_stage_times_with_the_injected_clock():
    """``lowered_seconds`` spans making the example tensors and
    ``compile_seconds`` the first call, each read from the clock."""
    ticks = iter(range(100))
    comp = TwoStageCompiler(_vpool(4), clock=lambda: float(next(ticks)))
    seen = []

    def program(x, s, n):
        seen.append((x.dtype, x.shape, s.dtype, n))
        return x

    progs = comp.static_compile(
        "p", program, (TensorSpec((3, 5), torch.bfloat16),
                       TensorSpec((5,), torch.int32), 7),
        lease_sizes=[2, 3], mesh_builder=lambda n: np.array([CPU] * n,
                                                            dtype=object))
    assert seen == [(torch.bfloat16, (3, 5), torch.int32, 7)] * 2
    for p in progs.values():
        assert (p.lowered_seconds, p.compile_seconds) == (1.0, 1.0)
        assert isinstance(p, CompiledProgram) and p.executable is program


def test_tree_to_device_keeps_structure():
    from repro_torch.serving.engine import SlotState

    @dataclasses.dataclass(frozen=True)
    class Box:
        t: torch.Tensor
        n: int

    st = SlotState(*(torch.arange(3) for _ in range(5)))
    tree = {"slots": st, "list": [torch.ones(2), (torch.zeros(1), None)],
            "box": Box(torch.ones(4), 3), "k": 5}
    out = tree_to_device(tree, CPU)
    assert isinstance(out["slots"], SlotState)
    assert out["slots"].active is st.active       # already there: no copy
    assert isinstance(out["list"][1], tuple) and out["list"][1][1] is None
    assert isinstance(out["box"], Box) and out["box"].n == 3
    assert out["k"] == 5
    meta = tree_to_device(tree, torch.device("meta"))
    assert meta["slots"].tokens.device.type == "meta"
    assert meta["box"].t.device.type == "meta"


def test_state_specs_place_by_the_lease_width():
    """``state_specs`` place the live tree by spec over the lease's
    ("data", "model") array: a spec its width divides moves the tree to the
    lease's device, one it does not divide is refused as the reference's
    NamedSharding refuses it."""
    from repro_torch.distributed import P

    pool = _vpool(4)
    comp = TwoStageCompiler(pool)
    comp.static_compile("k", lambda x: x, (TensorSpec((2,), torch.float32),),
                        lease_sizes=[2, 4])
    pool.lease("t", 1)
    state = {"a": torch.ones(2, 3)}
    _, moved, _ = comp.reconfigure("t", "k", 2, live_state=state,
                                   state_specs={"a": P("data")})
    assert torch.equal(moved["a"], state["a"]) and moved["a"].device == CPU
    with pytest.raises(ValueError, match="does not divide"):
        comp.reconfigure("t", "k", 4, live_state=state,
                         state_specs={"a": P("data")})


def _serving_script(pkg):
    """examples/serve_multitenant.py's decisions, without the batchers:
    alice (priority 2) and bob share 16 cores; bob departs and alice
    regrows through the program cache."""
    if pkg == "jax":
        import jax.numpy as jnp
        import jax.sharding as jsh
        from repro.core import TenantSpec
        from repro.serving.tenancy import (
            VirtualAcceleratorPool as Pool, make_serving_hypervisor as make,
        )
        pool = Pool(devices=list(jax.devices()) * 16, devices_per_core=1,
                    kv_pages=64)
        spec = (jax.ShapeDtypeStruct((4,), jnp.float32),)

        def mesh_builder(n):
            devs = np.array(list(jax.devices()) * n, dtype=object)[:n]
            return jsh.Mesh(devs.reshape(n, 1), ("data", "model"))
    else:
        from repro_torch.core import TenantSpec
        Pool, make = VirtualAcceleratorPool, make_serving_hypervisor
        pool = Pool(devices=[CPU] * 16, devices_per_core=1, kv_pages=64)
        spec = (TensorSpec((4,), torch.float32),)
        mesh_builder = None
    hv, ex = make(pool, policy="priority")
    ex.compiler.static_compile("decode", lambda x: x, spec,
                               lease_sizes=[12, 16], mesh_builder=mesh_builder)
    kv_seen = {"alice": [], "bob": []}
    for name, cores, prio, art in (("alice", 12, 2.0, "decode"),
                                   ("bob", 4, 1.0, None)):
        assert hv.admit(TenantSpec(name, cores, priority=prio, artifact=art,
                                   requested_kv_pages=48, min_kv_pages=8))
        ex.register_kv_limit(name, kv_seen[name].append)
    state = {"x": 0}
    ex.register_state("alice", lambda: state, on_migrate=state.update)
    ex.record_latency("alice", 0.2, slo=0.5)
    hv.depart("bob")
    hv.resize_request("alice", 16)
    log = [{k: v for k, v in e.items() if not k.startswith("t_")}
           for e in ex.reconfig_log]
    return dict(alloc=hv.allocation(), kv=hv.kv_allocation(), log=log,
                kv_seen=kv_seen, program=ex.program_of("alice").n_cores,
                slo=ex.slo_report(), isolation=pool.pool.check_isolation(),
                timing=sorted(ex.reconfig_log[-1]))


def test_serving_hypervisor_matches_reference():
    want, got = _serving_script("jax"), _serving_script("torch")
    assert got == want
    assert got["alloc"] == {"alice": 16} and got["program"] == 16
    assert got["timing"] == ["n_cores", "t_context", "t_lookup",
                             "t_migrate", "tenant"]


def test_remesh_and_fault_sinks_route_by_lease():
    hv, ex = make_serving_hypervisor(_vpool(8), policy="even_split")
    from repro_torch.core import TenantSpec

    meshes, faults = [], []
    assert hv.admit(TenantSpec("a", 8))
    assert hv.admit(TenantSpec("b", 4))
    assert hv.allocation() == {"a": 4, "b": 4}
    ex.register_remesh("a", meshes.append)
    ex.register_fault_sink("a", faults.append)
    hv.depart("b")
    assert hv.allocation() == {"a": 8}
    assert meshes[-1].shape == (8,) and "t_remesh" in ex.reconfig_log[-1]
    core = sorted(ex.pool.lease_of("a").cores)[0]
    hv.fail_core(core)
    assert faults and faults[-1].core == core
    assert ex.fault_log[-1]["recovered"] is False


# ---------------------------------------------------------------------------
# the executor's SLO plumbing (tests/test_slo.py, tests/test_prefix.py)
# ---------------------------------------------------------------------------


class TestServingSlo:
    def test_registered_model_drives_demand(self):
        from repro_torch.core import TenantSpec

        hv, ex = make_serving_hypervisor(_vpool(8), policy="latency_slo")
        ex.register_latency_model("a", lambda k: 1.0 / k)
        spec = TenantSpec("a", 8, latency_slo=0.3)
        assert hv.admit(spec)
        assert hv.allocation()["a"] == 8          # demand 4 + leftovers
        assert ex.estimate_latency(spec, 4) == 0.25

    def test_ewma_fallback_scales_with_lease(self):
        from repro_torch.core import TenantSpec

        vpool = _vpool(8)
        ex = ServingExecutor(vpool)
        spec = TenantSpec("a", 8)
        assert ex.estimate_latency(spec, 4) is None
        vpool.lease("a", 2)
        ex.record_latency("a", 0.4)
        ex.record_latency("a", 0.4)
        assert ex.estimate_latency(spec, 2) == pytest.approx(0.4)
        assert ex.estimate_latency(spec, 4) == pytest.approx(0.2)
        vpool.release("a")
        assert ex.estimate_latency(spec, 2) == pytest.approx(0.4)
        assert ex.estimate_latency(spec, 1) == pytest.approx(0.8)

    def test_note_completion_feeds_report_and_sink(self):
        from repro_torch.core import RequestRecord

        ex = ServingExecutor(_vpool(8))
        seen = []
        ex.completion_sink = seen.append
        rec = RequestRecord("a", 0, t_arrival=0.0, slo=1.0,
                            t_start=0.0, t_complete=0.5)
        ex.note_completion(rec)
        miss = RequestRecord("a", 1, t_arrival=0.0, slo=0.1,
                             t_start=0.0, t_complete=0.5)
        ex.note_completion(miss)
        report = ex.slo_report()["a"]
        assert report["requests"] == 2 and report["slo_met"] == 1
        assert report["attainment"] == 0.5
        assert seen == [rec, miss]

    def test_eviction_keeps_state_for_readmission(self):
        from repro_torch.core import TenantSpec

        hv, ex = make_serving_hypervisor(_vpool(8), policy="priority",
                                         preemptive=True)
        ex.register_request_sink("lo", lambda rec: None)
        ex.register_latency_model("lo", lambda k: 0.1)
        assert hv.admit(TenantSpec("lo", 8, min_cores=8, priority=1.0))
        assert hv.admit(TenantSpec("hi", 8, min_cores=8, priority=5.0))
        assert hv.allocation() == {"hi": 8}
        assert hv.waiting_tenants() == ["lo"]
        assert "lo" in ex._latency_models
        hv.depart("hi")
        assert hv.allocation() == {"lo": 8}

    def test_slo_report_counts_drops(self):
        from repro_torch.core import RequestRecord

        ex = ServingExecutor(_vpool(4))
        ex.record_latency("t", 0.2, slo=0.5)
        ex.note_drop(RequestRecord(tenant="t", rid=1, t_arrival=0.0,
                                   deadline=0.1))
        rep = ex.slo_report()["t"]
        assert rep["requests"] == 2
        assert rep["slo_met"] == 1
        assert rep["dropped"] == 1

    def test_executor_sheds_expired_requests_before_the_sink(self):
        from repro_torch.core import RequestRecord

        ex = ServingExecutor(_vpool(4))
        delivered = []
        ex.register_request_sink("t", delivered.append)
        live = RequestRecord(tenant="t", rid=0, t_arrival=0.0, deadline=9.0)
        dead = RequestRecord(tenant="t", rid=1, t_arrival=0.0, deadline=1.0)
        ex.exec_request("t", live, at=5.0)
        ex.exec_request("t", dead, at=5.0)
        assert delivered == [live]
        assert dead.dropped
        assert ex.slo_report()["t"]["dropped"] == 1

    def test_slo_report_matches_reference(self):
        """The same latency feed gives the reference's report, histogram
        percentiles included."""
        from repro.serving.tenancy import ServingExecutor as JaxExecutor
        from repro.serving.tenancy import VirtualAcceleratorPool as JaxPool

        rng = np.random.default_rng(11)
        feed = [(f"t{int(rng.integers(3))}", float(rng.uniform(0.01, 0.9)),
                 float(rng.choice([0.2, 0.5]))) for _ in range(60)]
        reports = []
        for ex in (JaxExecutor(JaxPool(devices=list(jax.devices()) * 8)),
                   ServingExecutor(_vpool(8))):
            ex.vpool.lease("t0", 3)
            for tenant, sec, slo in feed:
                ex.record_latency(tenant, sec, slo=slo)
            reports.append(ex.slo_report())
        assert reports[0] == reports[1]


class TestSharedKvAccounting:
    """Mirror of ``tests/test_prefix.py::TestSharedKvAccounting`` on the
    port's pool, policy and hypervisor."""

    def test_note_shared_kv_requires_core_lease(self):
        pool = tcore.ResourcePool(4, n_kv_pages=8)
        with pytest.raises(tcore.HRPError):
            pool.note_shared_kv("ghost", 2)
        pool.alloc("t", 2)
        pool.note_shared_kv("t", 3)
        assert pool.shared_kv == {"t": 3}
        pool.check_kv_quota()
        pool.note_shared_kv("t", 0)
        assert pool.shared_kv == {}
        pool.release("t")

    def test_release_clears_shared_kv(self):
        pool = tcore.ResourcePool(4, n_kv_pages=8)
        pool.alloc("t", 2)
        pool.note_shared_kv("t", 3)
        pool.release("t")
        assert pool.shared_kv == {}
        pool.check_kv_quota()

    def test_shared_exceeding_pool_rejected(self):
        pool = tcore.ResourcePool(4, n_kv_pages=4)
        pool.alloc("t", 2)
        with pytest.raises(tcore.HRPError):
            pool.note_shared_kv("t", 5)
        pool.alloc("u", 2)
        pool.note_shared_kv("t", 3)
        pool.note_shared_kv("u", 3)
        with pytest.raises(tcore.HRPError):
            pool.check_kv_quota()

    def test_proportional_split_floors_at_shared_set(self):
        a = tcore.TenantSpec("a", 2, requested_kv_pages=12, min_kv_pages=2,
                             arrived_at=0.0)
        b = tcore.TenantSpec("b", 2, requested_kv_pages=12, min_kv_pages=2,
                             arrived_at=1.0)
        ctx = tcore.PolicyContext(4, [a, b], {"a": 2, "b": 2}, 0.0,
                                  n_kv_pages=16, current_kv={"a": 8, "b": 8},
                                  shared_kv_pages={"a": 7})
        alloc = tcore.kv_pages_proportional(ctx, {"a": 2, "b": 2})
        assert alloc["a"] >= 7
        assert alloc["a"] + alloc["b"] <= 16
        ctx0 = dataclasses.replace(ctx, shared_kv_pages={})
        alloc0 = tcore.kv_pages_proportional(ctx0, {"a": 2, "b": 2})
        assert alloc0["a"] == alloc0["b"]

    def test_shared_kv_flows_into_policy_context(self):
        pool = tcore.ResourcePool(4, n_kv_pages=16)
        seen = {}

        def spy(ctx):
            seen.update(ctx.shared_kv_pages)
            from repro_torch.core.hypervisor import even_split
            return even_split(ctx)

        hv = tcore.Hypervisor(pool, policy=spy)
        assert hv.admit(tcore.TenantSpec("t", 2, requested_kv_pages=8,
                                         min_kv_pages=1))
        pool.note_shared_kv("t", 5)
        assert hv.admit(tcore.TenantSpec("u", 2, requested_kv_pages=8,
                                         min_kv_pages=1))
        assert seen.get("t") == 5

    def test_executor_note_shared_kv_reaches_the_pool(self):
        hv, ex = make_serving_hypervisor(_vpool(4, kv_pages=16))
        assert hv.admit(tcore.TenantSpec("t", 2, requested_kv_pages=8,
                                         min_kv_pages=1))
        ex.note_shared_kv("t", 6)
        assert ex.pool.shared_kv == {"t": 6}
        hv.depart("t")
        assert ex.pool.shared_kv == {}


# ---------------------------------------------------------------------------
# live-state migration on the batcher (tests/test_serving.py,
# tests/test_paging.py, tests/test_speculative.py)
# ---------------------------------------------------------------------------


def _configs():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


BASE = dict(slots=4, prompt_len=8, max_len=64, chunk=4)
MIGRATION_CASES = {
    "dense": {},
    "paged": dict(paged=True, page_size=8),
    "paged prefix cache": dict(paged=True, page_size=4, prefix_cache=True),
    "spec dense": dict(speculative=True, draft_window=4),
    "spec paged": dict(paged=True, page_size=4, n_pages=96,
                       speculative=True, draft_window=4),
    "overlap dense": dict(overlap=True),
    "overlap spec paged": dict(paged=True, page_size=8, n_pages=64,
                               speculative=True, draft_window=4,
                               overlap=True),
}


def _requests(Req, cfg, n=3, *, seed=23, max_new=9, namespace=None):
    """``n`` prompts of 4 + i tokens sharing a 4-token head; ``max_new`` is
    one budget or a list of them."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab, size=4).astype(np.int32)
    budgets = max_new if isinstance(max_new, list) else [max_new] * n
    return [Req(rid=i, prompt=np.concatenate(
                [head, rng.integers(1, cfg.vocab, size=i % 4)
                 .astype(np.int32)]),
                max_new=budgets[i], namespace=namespace)
            for i in range(n)]


def _jax_tokens(jp, jcfg, extra, n=3, max_new=9):
    from repro.serving import ServingConfig as JaxServingConfig

    b = JaxBatcher(jp, jcfg, JaxServingConfig(**BASE, **extra,
                                              attn_impl="xla"))
    reqs = _requests(JaxRequest, jcfg, n, max_new=max_new, namespace="s")
    for r in reqs:
        b.submit(r)
    b.run(max_steps=2000)
    return [list(r.out) for r in reqs]


def _port_batcher(params, cfg, extra):
    return ContinuousBatcher(params, cfg,
                             ServingConfig(**BASE, **extra, attn_impl="torch"),
                             device="cpu")


def _resized_run(params, cfg, extra, *, n=3, max_new=9, steps_before=1,
                 policy="no_realloc"):
    """Serve through a hypervisor lease of 1 core; after ``steps_before``
    rounds a resize to 2 cores lands between chunks and migrates the live
    state.  Returns (batcher, requests, executor)."""
    hv, ex = make_serving_hypervisor(_vpool(4), policy=policy)
    ex.compiler.static_compile("decode", lambda x: x,
                               (TensorSpec((4,), torch.float32),),
                               lease_sizes=[1, 2])
    assert hv.admit(tcore.TenantSpec("t", 1, artifact="decode"))
    b = _port_batcher(params, cfg, extra)
    ex.register_state("t", b.live_state, on_migrate=b.adopt_state)
    reqs = _requests(Request, cfg, n, max_new=max_new, namespace="s")
    for r in reqs:
        b.submit(r)
    for _ in range(steps_before):
        b.step()                                  # tokens in flight
    hv.resize_request("t", 2)                     # migration between chunks
    assert ex.reconfig_log and "t_migrate" in ex.reconfig_log[-1]
    assert ex.program_of("t").n_cores == 2
    b.run(max_steps=2000)
    return b, reqs, ex


@pytest.mark.parametrize("case", list(MIGRATION_CASES))
def test_resize_between_chunks_migrates_live_state(models, case):
    """A ``TwoStageCompiler.reconfigure`` landing between chunks migrates
    the batcher's caches, slot state, pages and draft state (pull-model
    ``register_state`` + ``adopt_state``); decode resumes token-identically
    to an uninterrupted run, which equals the reference's."""
    jp, params = models
    jcfg, cfg = _configs()
    extra = MIGRATION_CASES[case]
    ref = _port_batcher(params, cfg, extra)
    ref_reqs = _requests(Request, cfg, namespace="s")
    for r in ref_reqs:
        ref.submit(r)
    ref.run(max_steps=2000)
    b, reqs, _ = _resized_run(params, cfg, extra)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == _jax_tokens(jp, jcfg, extra)
    assert b.stats.as_dict() == ref.stats.as_dict()
    if b.paged:
        b.kv_pool.check()
        assert int(b.pages.free_top) + b.kv_pool.shared == b.n_pages


def test_resize_under_overlap_lands_between_chunks(models):
    """With ``overlap=True`` the resize lands after rounds that ran an
    admission behind the in-flight chunk; ``live_state`` returns the state
    the next chunk reads, and tokens stay identical."""
    jp, params = models
    jcfg, cfg = _configs()
    kw = dict(BASE, overlap=True, slots=2)
    budgets = [3, 9, 5, 7, 4]
    ref = ContinuousBatcher(params, cfg, ServingConfig(**kw, attn_impl="torch"),
                            device="cpu")
    ref_reqs = _requests(Request, cfg, 5, max_new=budgets)
    for r in ref_reqs:
        ref.submit(r)
    ref.run(max_steps=2000)
    hv, ex = make_serving_hypervisor(_vpool(4), policy="no_realloc")
    ex.compiler.static_compile("decode", lambda x: x,
                               (TensorSpec((4,), torch.float32),),
                               lease_sizes=[1, 2, 3])
    assert hv.admit(tcore.TenantSpec("t", 1, artifact="decode"))
    b = ContinuousBatcher(params, cfg, ServingConfig(**kw, attn_impl="torch"),
                          device="cpu")
    ex.register_state("t", b.live_state, on_migrate=b.adopt_state)
    reqs = _requests(Request, cfg, 5, max_new=budgets)
    for r in reqs:
        b.submit(r)
    for n_cores in (2, 3, 1):
        b.step()
        hv.resize_request("t", n_cores)
    b.run(max_steps=2000)
    assert b.stats.overlap_rounds > 0
    assert len([e for e in ex.reconfig_log if "t_migrate" in e]) == 3
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    from repro.serving import ServingConfig as JaxServingConfig
    jb = JaxBatcher(jp, jcfg, JaxServingConfig(**kw, attn_impl="xla"))
    jreqs = _requests(JaxRequest, jcfg, 5, max_new=budgets)
    for r in jreqs:
        jb.submit(r)
    jb.run(max_steps=2000)
    assert [r.out for r in reqs] == [list(r.out) for r in jreqs]


def test_live_state_carries_pages_and_draft(models):
    _, params = models
    _, cfg = _configs()
    b = _port_batcher(params, cfg, dict(paged=True, page_size=4,
                                        speculative=True, draft_window=4))
    state = b.live_state()
    assert set(state) == {"caches", "slots", "pages", "draft"}
    b.adopt_state(tree_to_device(state, CPU))
    dense = _port_batcher(params, cfg, {})
    assert set(dense.live_state()) == {"caches", "slots"}


def test_adopt_state_refuses_another_device(models):
    """The params stay on the batcher's device: a tree migrated elsewhere
    is refused instead of decoding across devices."""
    _, params = models
    _, cfg = _configs()
    b = _port_batcher(params, cfg, {})
    moved = tree_to_device(b.live_state(), torch.device("meta"))
    with pytest.raises(ValueError, match="remesh"):
        b.adopt_state(moved)


def test_kv_lease_drives_batcher_page_limit(models):
    """Mirror of ``tests/test_paging.py``: hypervisor kv_pages grant ->
    ServingExecutor.exec_kv_resize -> ContinuousBatcher.set_page_limit; a
    second tenant's admission halves the lease, the shrink lands on the
    device quota, and the batcher stays within it."""
    _, params = models
    _, cfg = _configs()
    hv, ex = make_serving_hypervisor(_vpool(4, kv_pages=16),
                                     policy="even_split")
    b = ContinuousBatcher(params, cfg, ServingConfig(
        slots=4, prompt_len=8, max_len=64, chunk=4, paged=True, page_size=8,
        n_pages=16, attn_impl="torch"), device="cpu")
    assert hv.admit(tcore.TenantSpec("t", 2, requested_kv_pages=16,
                                     min_kv_pages=2))
    ex.register_kv_limit("t", b.set_page_limit)
    assert hv.kv_allocation() == {"t": 16}
    assert hv.admit(tcore.TenantSpec("u", 2, requested_kv_pages=16,
                                     min_kv_pages=2))
    assert sum(hv.kv_allocation().values()) <= 16
    assert b._page_limit == hv.kv_allocation()["t"]
    assert int(b.pages.quota) == b._page_limit
    reqs = _requests(Request, cfg, 6, seed=29, max_new=8)
    for r in reqs:
        b.submit(r)
    b.run(max_steps=2000)
    assert all(r.done for r in reqs)
    assert b.stats.peak_pages_in_use <= hv.kv_allocation()["t"]
    b.kv_pool.check()
    assert int(b.pages.free_top) == b.n_pages


def test_launcher_leases_cores(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--tenants", "2", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--prompt-len", "6"]) == 0
    out = capsys.readouterr().out
    assert "pool=16 cores" in out
    assert "tenant0: lease=[0, 1, 2, 3]..." in out
    assert "tenant1: lease=[8, 9, 10, 11]..." in out
    assert out.count("completed=3/3") == 2


def test_adopt_state_compares_tensor_devices(models):
    """A batcher built on ``cpu:0`` holds tensors that report ``cpu``; a
    tree migrated to the lease's device (``cpu``) is the same device."""
    _, params = models
    _, cfg = _configs()
    b = ContinuousBatcher(params, cfg, ServingConfig(**BASE, attn_impl="torch"),
                          device=torch.device("cpu", 0))
    state = b.live_state()
    b.adopt_state(tree_to_device(state, CPU))
    assert b.state.active is state["slots"].active      # no copy
