"""The paged, prefix and speculative programs and the ``ContinuousBatcher``
under the SPMD policy (``repro_torch.distributed.spmd``), against the
reference's batcher, on the CPU.

The batcher runs under ``make_policy`` on a process mesh of gloo ranks
(``launch.spmd.run_ranks``; the rank programs are in
``test_torch_spmd_paged_ranks.py``), its params placed by
``param_shardings``, with reduced configs at f32 and the reference's
weights (``weights.params_from_jax``): 4 slots, prompts of 16 tokens (a
shared 8-token head and 8-token tails), 6 requests of 10 new tokens in
one prefix namespace, chunks of 4, pages of 4.  The cases: reduced qwen3
on (data 2, model 2) in the dense, paged, paged + prefix cache,
speculative dense, speculative paged with overlap and paged + audit (with
a watchdog and deadlines that never trip, so their agreement collectives
run) modes; reduced deepseek paged + prefix with its experts over "model"
and expert-TP; reduced jamba paged; reduced qwen3 on (1, 4), whose 2 kv
heads do not divide 4: the dense batcher on the length-sharded ring, and
the paged and speculative batchers' refusals.

Each case is held against the reference's batcher single-device and
under its own ``make_policy`` on 8 forced host devices (params placed by
``param_specs``), in two reference subprocesses that run beside the
ranks, and against the port's single process: tokens and every
``BatcherStats`` counter exactly equal to both reference runs; the page
table, free stack, ``free_top``, ``pinned`` and slot state bit-equal to
the single process's after every round on every rank, and the host
ledgers (the page ledger, the prefix cache's nodes) equal; the pool after
the first round, gathered over "model", within 1e-5 of the single
process's.  The engine's programs (``make_paged_admit_step``,
``make_cached_admit_step`` across data groups, ``make_paged_decode_chunk``,
``make_paged_spec_decode_chunk``) are held step by step against the
single process (tokens and page state exactly, the pool within 1e-5), and
the logits of a paged ``decode_step``, a paged ``verify_step`` and a
``prefix_prefill`` under the policy within 1e-5; with the data-axis K/V
gather switched off, the cross-data-group prefix hit must differ.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)
import test_torch_spmd_paged_ranks as ranks

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.launch.spmd import run_ranks
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax

QWEN, DEEPSEEK, JAMBA = ("qwen3-0.6b", "deepseek-moe-16b",
                         "jamba-1.5-large-398b")
CASES_2X2 = ([(QWEN, m, True) for m in ranks.MODES]
             + [(DEEPSEEK, "prefix", True), (DEEPSEEK, "prefix", False),
                (JAMBA, "paged", True)])
CASES_1X4 = [(QWEN, "dense", True)]
REFUSED_1X4 = ("paged", "spec")
TOL = 1e-5
SPAWN_TIMEOUT_S = 300
REF_TIMEOUT_S = 600

# The reference's batcher on 8 forced host devices, one share of the jobs
# a subprocess: an (arch, mode) single-device, a case under its
# make_policy, or a (1, 4) mode it refuses (its message).
REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, time
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.distributed.sharding import make_policy, param_specs
    from repro.launch.mesh import make_mesh_compat
    from repro.models import init_params
    from repro.serving import ServingConfig
    from repro.serving.batcher import ContinuousBatcher, Request

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(sys.argv[2]))
    out = {}

    def put(tree, specs, mesh):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))

    def run(arch, mode, params, policy=None):
        b = ContinuousBatcher(params, cfgs[arch], ServingConfig(
            **spec["base"], **spec["modes"][mode]), policy=policy)
        deadline = spec["deadline"] if mode == "audit" else None
        reqs = [Request(rid=i, prompt=p, max_new=spec["max_new"],
                        namespace="a", deadline=deadline)
                for i, p in enumerate(inp[arch])]
        for r in reqs:
            b.submit(r)
        b.run(max_steps=500)
        return {"tokens": [list(map(int, r.out)) for r in reqs],
                "stats": {k: int(v) for k, v in b.stats.as_dict().items()}}

    def sharded(arch, mode, ep, shape):
        mesh = make_mesh_compat(tuple(shape), ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        cfg = cfgs[arch]
        policy = make_policy(cfg, mesh, batch=spec["base"]["slots"],
                             moe_ep=ep)
        with mesh:
            return run(arch, mode, put(params[arch], param_specs(
                cfg, mesh, moe_ep=ep), mesh), policy)

    archs = sorted({job[1] for job in spec["jobs"] if job[0] != "refused"}
                   | ({"qwen3-0.6b"} if any(job[0] == "refused"
                                            for job in spec["jobs"])
                      else set()))
    cfgs = {a: dataclasses.replace(get_reduced(a), dtype="float32")
            for a in archs}
    params = {a: init_params(cfgs[a], jax.random.PRNGKey(0)) for a in archs}
    for job in spec["jobs"]:
        t0 = time.time()
        if job[0] == "single":
            out["/".join(job[1:])] = run(job[1], job[2], params[job[1]])
        elif job[0] == "sharded":
            _, arch, mode, ep, shape = job
            out[f"{arch}/{mode}/{int(ep)}/{shape[0]}x{shape[1]}"] = sharded(
                arch, mode, ep, shape)
        else:
            try:
                sharded("qwen3-0.6b", job[1], True, [1, 4])
                out["refused/" + job[1]] = None
            except NotImplementedError as e:
                out["refused/" + job[1]] = str(e)
        print(f"{job} {time.time() - t0:.1f} s", file=sys.stderr)
    print("REF-OUT " + json.dumps(out))
""")


def _ref_jobs():
    """The reference's jobs in two shares of about equal time: the
    single-device runs, the refusals and the other archs' runs under its
    policy; qwen3's runs under its policy."""
    single = [["single", a, m] for a, m in sorted(
        {(c[0], c[1]) for c in CASES_2X2 + CASES_1X4})]
    refused = [["refused", m] for m in REFUSED_1X4]
    sharded = ([["sharded", a, m, ep, [2, 2]] for a, m, ep in CASES_2X2]
               + [["sharded", a, m, ep, [1, 4]] for a, m, ep in CASES_1X4])
    return [single + refused + [j for j in sharded if j[1] != QWEN],
            [j for j in sharded if j[1] == QWEN]]


@pytest.fixture(scope="module")
def runs():
    """The reference's two subprocesses (started first, running beside
    the ranks), 4 ranks on (2, 2), 4 ranks on (1, 4) and the port's single
    process."""
    archs = sorted({c[0] for c in CASES_2X2 + CASES_1X4})
    tmp = tempfile.mkdtemp(prefix="spmd-paged-ref-")
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, **{a: ranks.prompts(a) for a in archs})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    root = os.path.join(os.path.dirname(__file__), "..")
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps({
            "base": ranks.BASE, "modes": ranks.MODES, "jobs": jobs,
            "max_new": ranks.MAX_NEW, "deadline": ranks.DEADLINE}), inp],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root) for jobs in _ref_jobs()]
    try:
        params = {a: params_from_jax(jax.device_get(jax_init_params(
            dataclasses.replace(jax_reduced(a), dtype="float32"),
            jax.random.PRNGKey(0))), device="cpu") for a in archs}
        r4 = run_ranks(ranks.ranks_2x2, 4, args=({
            "params": params, "cases": CASES_2X2},), timeout=SPAWN_TIMEOUT_S)
        r14 = run_ranks(ranks.ranks_1x4, 4, args=({
            "params": {QWEN: params[QWEN]}, "cases": CASES_1X4,
            "refused": REFUSED_1X4},), timeout=SPAWN_TIMEOUT_S)
        with torch.no_grad():
            single = {(a, m): ranks.run_batcher(a, m, params[a])
                      for a, m in sorted({(c[0], c[1])
                                          for c in CASES_2X2 + CASES_1X4})}
        engine = ranks.engine(params[QWEN])
        outs = [ref.communicate(timeout=REF_TIMEOUT_S) for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    ref_out = {}
    for ref, (stdout, stderr) in zip(refs, outs):
        line = [s for s in stdout.splitlines() if s.startswith("REF-OUT ")]
        assert ref.returncode == 0 and line, stderr[-3000:]
        ref_out.update(json.loads(line[0][len("REF-OUT "):]))
    return {"ref": ref_out, "r4": r4, "r14": r14, "single": single,
            "engine": engine}


ALL =([(a, m, ep, (2, 2)) for a, m, ep in CASES_2X2]
       + [(a, m, ep, (1, 4)) for a, m, ep in CASES_1X4])
IDS = [f"{a}-{m}-{'ep' if ep else 'tp'}-{s[0]}x{s[1]}" for a, m, ep, s in ALL]


def _ranks(runs, shape):
    return runs["r4" if shape == (2, 2) else "r14"]


@pytest.mark.parametrize("arch,mode,ep,shape", ALL, ids=IDS)
def test_the_batcher_matches_both_reference_runs(runs, arch, mode, ep, shape):
    """Every request's tokens and every BatcherStats counter, on every
    rank, equal the reference's single-device run and its run under its
    own policy (the port's CUDA-graph counters, which it lacks, at 0)."""
    ref = runs["ref"]
    single = ref[f"{arch}/{mode}"]
    sharded = ref[f"{arch}/{mode}/{int(ep)}/{shape[0]}x{shape[1]}"]
    assert sharded == single
    for r in _ranks(runs, shape):
        got = r["serve"][(arch, mode, ep)]
        assert got["tokens"] == single["tokens"]
        assert got["stats"] == {**single["stats"],
                                **dict.fromkeys(PORT_STATS_FIELDS, 0)}


@pytest.mark.parametrize("arch,mode,ep,shape", ALL, ids=IDS)
def test_every_rank_keeps_the_single_process_bookkeeping(runs, arch, mode,
                                                         ep, shape):
    """After every round, on every rank: the slot state, and (paged) the
    page table, free stack, free_top and pinned bit-equal to the port's
    single process; the page ledger and the prefix cache's nodes equal to
    its ledgers."""
    single = runs["single"][(arch, mode)]
    for r in _ranks(runs, shape):
        got = r["serve"][(arch, mode, ep)]
        assert got["rounds"] == single["rounds"]
        assert got["tokens"] == single["tokens"]


@pytest.mark.parametrize("arch,mode,ep,shape",
                         [c for c in ALL if ranks.MODES[c[1]].get("paged")],
                         ids=[i for c, i in zip(ALL, IDS)
                              if ranks.MODES[c[1]].get("paged")])
def test_the_gathered_pool_equals_the_single_process(runs, arch, mode, ep,
                                                     shape):
    """The pool after the first round, gathered over "model", within 1e-5
    of the single process's on every page but the trash page (which
    absorbs duplicate writes), on every rank: every data group holds the
    whole pool."""
    want = runs["single"][(arch, mode)]["pool"]
    for r in _ranks(runs, shape):
        got = r["serve"][(arch, mode, ep)]["pool"]
        assert got.keys() == want.keys()
        for p in want:
            for g, w in zip(got[p], want[p]):
                assert g.shape == w.shape
                np.testing.assert_allclose(g[:, :-1].numpy(),
                                           w[:, :-1].numpy(), rtol=0,
                                           atol=TOL)


def test_the_cases_take_the_paths_they_name(runs):
    """The prefix cases hit the cache, the spec cases accept drafts, the
    overlap case overlaps, the audit case runs its agreement collectives,
    and the paged cases write the pool through the data-axis gather."""
    stats = {k: v["stats"] for k, v in runs["r4"][0]["serve"].items()}
    logs = {k: v["log"] for k, v in runs["r4"][0]["serve"].items()}
    for key in [(QWEN, "prefix", True), (DEEPSEEK, "prefix", True),
                (DEEPSEEK, "prefix", False)]:
        assert stats[key]["prefix_hits"] > 0
        assert stats[key]["prefill_tokens_skipped"] > 0
    for mode in ("spec", "spec_paged"):
        assert stats[(QWEN, mode, True)]["accepted_tokens"] > 0
    assert stats[(QWEN, "spec_paged", True)]["overlap_rounds"] > 0
    assert logs[(QWEN, "audit", True)]["agree"] > 0
    for key, log in logs.items():
        assert (log.get("pool-kv", 0) > 0) == bool(
            ranks.MODES[key[1]].get("paged"))
        assert log["rows"] > 0


@pytest.mark.parametrize("shape,mode", [((2, 2), "dense"), ((2, 2), "paged"),
                                        ((1, 4), "dense")])
def test_a_rank_holds_what_kv_cache_bytes_reckons(runs, shape, mode):
    """The rank's caches (its slots and heads, or its ring block; the pool
    at its heads) are the bytes ``kv_cache_bytes`` / ``paged_kv_cache_bytes``
    reckon for a rank, less than the whole cache the counter reports."""
    for r in _ranks(runs, shape):
        got = r["serve"][(QWEN, mode, True)]
        assert got["rank_bytes"] == got["reckoned"]
        assert got["rank_bytes"] < got["stats"]["cache_bytes"]


def test_a_policy_batcher_keeps_its_width(runs):
    """No remesh of a batcher under the SPMD policy, as the reference has
    none."""
    for r in runs["r4"] + runs["r14"]:
        for res in r["serve"].values():
            assert "SPMD policy" in res["remesh"]


def test_the_length_sharded_mesh_keeps_the_references_refusals(runs):
    """On (1, 4) the dense batcher runs (tested above); building a paged or
    speculative batcher raises the reference's NotImplementedError."""
    for r in runs["r14"]:
        assert r["kv_len_sharded"]
        for mode in REFUSED_1X4:
            assert r["refused"][mode] is not None
            assert r["refused"][mode] == runs["ref"][f"refused/{mode}"]
    assert runs["r14"][0]["refused"]["paged"] == (
        "paged decode does not support a length-sharded KV cache")


def _pool_err(got, want) -> float:
    return max(float((g - w).abs().max()) for p in want
               for g, w in zip(got[p], want[p]))


@pytest.mark.parametrize("step", ["cold", "cached", "decode", "spec"])
def test_the_engine_programs_match_one_process(runs, step):
    """Each paged program under the policy: its tokens (with the emitted
    masks, the sentinel, the device counters and the drafter's history)
    and page and slot state exactly the single process's, the pool within
    1e-5, on every rank."""
    want = runs["engine"][step]
    for r in runs["r4"]:
        got = r["engine"][step]
        assert torch.equal(got["tokens"], want["tokens"])
        for a, b in zip(got["pages"] + got["state"],
                        want["pages"] + want["state"]):
            assert torch.equal(a, b)
        assert _pool_err(got["pool"], want["pool"]) <= TOL


@pytest.mark.parametrize("entry", ["decode", "verify", "prefix"])
def test_the_paged_entry_points_logits_match_one_process(runs, entry):
    """A paged decode_step, a paged verify_step and a prefix_prefill under
    the policy (the rank's rows and heads), gathered, within 1e-5 of the
    single process's logits."""
    want = runs["engine"]["logits"][entry]
    for r in runs["r4"]:
        got = r["engine"]["logits"][entry]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=TOL)


def test_without_the_data_axis_gather_a_cross_group_hit_differs(runs):
    """With the data-axis K/V gather switched off, the cached admission's
    row on data group 0 reads prefix pages that data group 1 wrote and its
    own pool lacks: the suffix K/V it writes leaves the single process's by
    far more than the tolerance, so the tests above hold the gather."""
    want = runs["engine"]["cached"]["pool"]
    for r in runs["r4"]:
        assert _pool_err(r["engine_off"]["cold"]["pool"],
                         runs["engine"]["cold"]["pool"]) > 100 * TOL
        assert _pool_err(r["engine_off"]["cached"]["pool"], want) > 100 * TOL
