"""The SPMD policy for the MoE, SSM, hybrid, VLM and audio families
(``repro_torch.distributed.spmd``) on the serving path, against the
reference's, on the CPU.

Each case is a reduced config at f32 with the reference's weights
(``weights.params_from_jax``) and a seeded batch (the reference's
``make_batch``): a prefill through ``make_prefill_step``, two greedy serve
steps through ``make_serve_step`` and, from a second prefill, one dense
``make_decode_chunk`` of four steps, all under ``make_policy`` on a process
mesh of gloo ranks (``launch.spmd.run_ranks``; the rank programs are in
``test_torch_spmd_families_ranks.py``).  The cases: every family on (data
2, model 2), deepseek in both MoE layouts (experts over "model", and
expert-TP), and reduced jamba and qwen2-vl on (data 2, model 4), whose 2
kv heads do not divide 4.  Reduced jamba's 2 SSM groups split over model 2
and do not over model 4; mamba2's one group never does.

Each is held against the reference's single-device run and its sharded
run on forced host devices (its ``make_policy``, params placed by
``param_specs``, caches by ``cache_specs``), in one reference subprocess
that runs beside the ranks, and its gathered caches (KV, SSM state and
conv window, cross K/V) against the port's single process.

Tolerances: tokens exactly; logits within 1e-5 of both reference runs
(the reference's own sharded run is within 2e-6 of its single-device run;
the port's f32 sums over "model" take another order); caches within 1e-5
of each leaf's largest magnitude, positions exactly.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)
import test_torch_spmd_families_ranks as ranks

from repro.configs import get_reduced as jax_reduced
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import _swiglu_tp_perm
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.spmd import run_ranks
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

ARCHS = ("mamba2-370m", "deepseek-moe-16b", "jamba-1.5-large-398b",
         "qwen2-vl-72b", "whisper-base")
B, PROMPT = 4, 8
CASES_2X2 = [(a, True) for a in ARCHS] + [("deepseek-moe-16b", False)]
CASES_2X4 = [("jamba-1.5-large-398b", True), ("qwen2-vl-72b", True)]
CELLS = [("deepseek-moe-16b", "decode_32k"), ("deepseek-moe-16b", "prefill_32k"),
         ("mamba2-370m", "decode_32k"), ("mamba2-370m", "prefill_32k")]
TOL = 1e-5
SPAWN_TIMEOUT_S = 300
REF_TIMEOUT_S = 600

# The reference's runs on 8 forced host devices: each arch single-device
# (prefill, two serve steps, a decode chunk of four steps) and each case
# sharded (prefill and two serve steps under make_policy).
REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.distributed.sharding import (
        cache_specs, make_policy, param_specs, train_batch_specs)
    from repro.launch.mesh import make_mesh_compat
    from repro.models import init_params
    from repro.serving.engine import (
        ServeConfig, SlotState, make_decode_chunk, make_prefill_step,
        make_serve_step)

    inp = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    out = {}

    def f32(x):
        return np.asarray(x, np.float32)

    def put(tree, specs, mesh):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))

    for arch in sorted({c[0] for c in cases}):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        scfg = ServeConfig(max_len=int(inp["max_len"]))
        params = init_params(cfg, jax.random.PRNGKey(0))
        out[arch + "/checksum"] = np.float64(sum(
            np.abs(f32(l)).astype(np.float64).sum()
            for l in jax.tree.leaves(params)))
        batch = {k.split("/")[1]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(arch + "/")}
        S = batch["tokens"].shape[1] + (batch["extra_embeds"].shape[1]
                                        if "extra_embeds" in batch else 0)
        prefill = jax.jit(make_prefill_step(cfg, scfg))
        logits0, caches = prefill(params, batch)
        t0 = jnp.argmax(logits0[..., :cfg.vocab], -1).astype(jnp.int32)
        cur = jnp.full((t0.shape[0],), S, jnp.int32)
        out[arch + "/first"] = f32(logits0)
        step = jax.jit(make_serve_step(cfg, scfg))
        keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
        tok, c = t0, caches
        for i in range(2):
            tok, lg, c = step(params, tok, c, cur + i, keys[i])
            out[arch + f"/tok{i}"] = np.asarray(tok)
            out[arch + f"/logits{i}"] = f32(lg)
        n = t0.shape[0]
        state = SlotState(tokens=t0, cur_pos=cur,
                          active=jnp.ones((n,), bool),
                          remaining=jnp.full((n,), 100, jnp.int32),
                          eos=jnp.full((n,), -1, jnp.int32))
        chunk = jax.jit(make_decode_chunk(cfg, scfg, int(inp["chunk"])))
        _, _, toks, emitted, poisoned = chunk(params, caches, state,
                                              jax.random.PRNGKey(3))
        out[arch + "/chunk_toks"] = np.asarray(toks)
        out[arch + "/chunk_emitted"] = np.asarray(emitted)
        for a, shape, ep in cases:
            if a != arch:
                continue
            name = f"{arch}/{shape[0]}x{shape[1]}/{int(ep)}/"
            mesh = make_mesh_compat(tuple(shape), ("data", "model"),
                                    devices=jax.devices()[:shape[0] * shape[1]])
            policy = make_policy(cfg, mesh, batch=n, moe_ep=ep)
            out[name + "kv_len_sharded"] = np.bool_(policy.kv_len_sharded)
            with mesh:
                p_sh = put(params, param_specs(cfg, mesh, moe_ep=ep), mesh)
                b_sh = put(batch, {k: v for k, v in train_batch_specs(
                    cfg, mesh, batch=n).items() if k in batch}, mesh)
                lg0, c = jax.jit(make_prefill_step(cfg, scfg, policy=policy))(
                    p_sh, b_sh)
                out[name + "first"] = f32(lg0)
                c = put(c, cache_specs(cfg, mesh, batch=n), mesh)
                step_sh = jax.jit(make_serve_step(cfg, scfg, policy=policy))
                tok = t0
                for i in range(2):
                    tok, lg, c = step_sh(p_sh, tok, c, cur + i, keys[i])
                    out[name + f"tok{i}"] = np.asarray(tok)
                    out[name + f"logits{i}"] = f32(lg)
    np.savez(sys.argv[2], **out)
    print("REF-OK")
""")


def _batch(arch):
    """The reference's seeded serving batch of the reduced config: 4
    prompts of 8 tokens (the VLM's after its 8 patches), no labels."""
    cfg = jax_reduced(arch)
    n_patch = 8 if cfg.family == "vlm" else 0
    batch = jax_make_batch(cfg, seq_len=PROMPT + n_patch, batch=B, step=0,
                           seed=0, reduced=True)
    batch.pop("labels")
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs():
    """The reference's subprocess (started first, running beside the
    ranks), 4 ranks on (2, 2), 8 ranks on (2, 4) and the port's single
    process."""
    batches = {a: _batch(a) for a in ARCHS}
    tmp = tempfile.mkdtemp(prefix="spmd-fam-ref-")
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, max_len=ranks.MAX_LEN, chunk=ranks.CHUNK,
             **{f"{a}/{k}": v for a, b in batches.items()
                for k, v in b.items()})
    cases = ([[a, [2, 2], ep] for a, ep in CASES_2X2]
             + [[a, [2, 4], ep] for a, ep in CASES_2X4])
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    root = os.path.join(os.path.dirname(__file__), "..")
    ref_out = os.path.join(tmp, "out.npz")
    import json
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, inp, ref_out, json.dumps(cases)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root)
    try:
        params = {a: params_from_jax(jax.device_get(jax_init_params(
            dataclasses.replace(jax_reduced(a), dtype="float32"),
            jax.random.PRNGKey(0))), device="cpu") for a in ARCHS}
        tb = {a: {k: torch.from_numpy(v) for k, v in b.items()}
              for a, b in batches.items()}
        r4 = run_ranks(ranks.ranks_2x2, 4, args=({
            "params": params, "batches": tb, "cases": CASES_2X2,
            "round_trip": ARCHS, "cells": CELLS},), timeout=SPAWN_TIMEOUT_S)
        r8 = run_ranks(ranks.ranks_2x4, 8, args=({
            "params": {a: params[a] for a, _ in CASES_2X4}, "batches": tb,
            "cases": CASES_2X4},), timeout=SPAWN_TIMEOUT_S)
        single = {a: ranks.single(a, params[a], tb[a]) for a in ARCHS}
        stdout, stderr = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF-OK" in stdout, stderr[-3000:]
    return {"ref": dict(np.load(ref_out)), "r4": r4, "r8": r8,
            "single": single, "params": params}


def _assert_logits(got, want, atol=TOL):
    got = got.float().numpy()
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()           # the vocab mask
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=atol)


def _result(runs, arch, shape, ep):
    return runs["r4" if shape == (2, 2) else "r8"][0]["serve"][(arch, ep)]


ALL_CASES = ([(a, (2, 2), ep) for a, ep in CASES_2X2]
             + [(a, (2, 4), ep) for a, ep in CASES_2X4])
IDS = [f"{a}-{s[0]}x{s[1]}-{'ep' if ep else 'tp'}" for a, s, ep in ALL_CASES]


def test_reference_params_are_the_ones_the_ranks_hold(runs):
    for a in ARCHS:
        mine = sum(np.abs(t.float().numpy()).astype(np.float64).sum()
                   for t in leaves(runs["params"][a]))
        assert mine == pytest.approx(float(runs["ref"][a + "/checksum"]),
                                     rel=1e-12)


@pytest.mark.parametrize("arch,shape,ep", ALL_CASES, ids=IDS)
def test_serving_matches_both_reference_runs(runs, arch, shape, ep):
    """The prefill's logits and two serve steps under make_policy: the
    tokens of the reference's single-device run and of its sharded run,
    logits within 1e-5 of both."""
    res, ref = _result(runs, arch, shape, ep), runs["ref"]
    name = f"{arch}/{shape[0]}x{shape[1]}/{int(ep)}/"
    assert res["kv_len_sharded"] == bool(ref[name + "kv_len_sharded"])
    _assert_logits(res["first"], ref[arch + "/first"])
    _assert_logits(res["first"], ref[name + "first"])
    for i, (tok, logits) in enumerate(res["steps"]):
        np.testing.assert_array_equal(tok.numpy(), ref[f"{arch}/tok{i}"])
        np.testing.assert_array_equal(tok.numpy(), ref[name + f"tok{i}"])
        _assert_logits(logits, ref[f"{arch}/logits{i}"])
        _assert_logits(logits, ref[name + f"logits{i}"])


@pytest.mark.parametrize("arch,shape,ep", ALL_CASES, ids=IDS)
def test_a_decode_chunk_matches_the_reference(runs, arch, shape, ep):
    toks, emitted, poisoned = _result(runs, arch, shape, ep)["chunk"]
    np.testing.assert_array_equal(toks.numpy(),
                                  runs["ref"][arch + "/chunk_toks"])
    np.testing.assert_array_equal(emitted.numpy(),
                                  runs["ref"][arch + "/chunk_emitted"])
    assert not poisoned.any()


def _assert_tree_close(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        if not b.is_floating_point():
            assert torch.equal(a, b)
            continue
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("arch,shape,ep", ALL_CASES, ids=IDS)
def test_gathered_caches_equal_the_single_process(runs, arch, shape, ep):
    """Every rank's KV (heads or length blocks), SSM state and conv window
    (its heads and channels) and cross K/V (its heads), gathered, equal
    the single process's after the prefill and after two steps."""
    res, single = _result(runs, arch, shape, ep), runs["single"][arch]
    _assert_tree_close(res["caches0"], single["caches0"])
    _assert_tree_close(res["caches"], single["caches"])
    caches = single["caches"]
    assert bool(caches.ssm) == (arch in ("mamba2-370m", "jamba-1.5-large-398b"))
    assert (caches.cross is not None) == (arch == "whisper-base")


@pytest.mark.parametrize("mesh", ["r4", "r8"])
def test_every_rank_holds_the_same_result(runs, mesh):
    r = runs[mesh]
    shape = (2, 2) if mesh == "r4" else (2, 4)
    assert sorted(x["coords"] for x in r) == [
        (d, m) for d in range(shape[0]) for m in range(shape[1])]
    for other in r[1:]:
        for key, res in r[0]["serve"].items():
            for (t0, l0), (t, lg) in zip(res["steps"],
                                         other["serve"][key]["steps"]):
                assert torch.equal(t, t0) and torch.equal(lg, l0)
            assert all(torch.equal(a, b) for a, b in zip(
                res["chunk"], other["serve"][key]["chunk"]))


def test_each_rank_runs_its_experts_and_heads(runs):
    """Expert-parallel deepseek on model 2: rank m holds experts 4m .. 4m +
    3 of 8; mamba2's one group is every rank's; reduced jamba's two groups
    split over model 2 (no selection), and on model 4 each rank's two
    heads read one group: ranks 0 and 1 group 0, ranks 2 and 3 group 1."""
    for r in runs["r4"]:
        m = r["coords"][1]
        assert r["serve"][("deepseek-moe-16b", True)]["expert_block"] == (
            4 * m, 4 * m + 4)
        assert r["serve"][("deepseek-moe-16b", False)]["expert_block"] is None
        assert r["serve"][("mamba2-370m", True)]["ssm_groups"] == slice(0, 1)
        assert r["serve"][("jamba-1.5-large-398b", True)]["ssm_groups"] is None
    for r in runs["r8"]:
        g = r["coords"][1] // 2
        assert r["serve"][("jamba-1.5-large-398b", True)]["ssm_groups"] == (
            slice(g, g + 1))


def test_a_local_mean_in_the_ssm_norm_is_seen(runs):
    """The same mamba2 run with each rank's gated norm over its own half
    of ``d_inner`` (its sum of squares, not the sum over "model"): its
    logits leave the reference's by far more than the tolerance, so the
    serving test holds the norm's all-reduce."""
    res, ref = runs["r4"][0]["norm_local"], runs["ref"]
    want = ref["mamba2-370m/first"]
    finite = np.isfinite(want)
    err = np.abs(res["first"].numpy()[finite] - want[finite]).max()
    assert err > 100 * TOL


def test_the_collectives_of_a_family_step(runs):
    """Two serve steps' collectives on (2, 2): mamba2 (2 SSM layers, no
    FSDP-free leaf: every projection's "data" block gathered, wb and wc's
    "model" blocks too since one group does not split; the norm's sum and
    the output's sum a layer), deepseek in both layouts (the MoE output
    summed once a layer with the shared experts'), whisper (the
    cross-attention's sum beside the self-attention's and the MLP's)."""
    log = {k: r["log"] for k, r in runs["r4"][0]["serve"].items()}
    n = 2 * 2                                   # two layers, two steps
    assert log[("mamba2-370m", True)] == {
        "embed": 2, "gather-data": 6 * n, "gather-model": 2 * n,
        "ssm-norm": n, "attn_out": n, "logits": 2}
    for ep in (True, False):
        assert log[("deepseek-moe-16b", ep)] == {
            "embed": 2, "gather-data": 9 * n, "attn_out": n, "mlp_out": n,
            "logits": 2}
    assert log[("whisper-base", True)] == {
        "embed": 2, "gather-data": 10 * n, "attn_out": n, "cross_out": n,
        "mlp_out": n, "logits": 2}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp,ep", [(True, True), (True, False),
                                     (False, True), (False, False)])
def test_param_shardings_round_trip_bit_for_bit(runs, arch, fsdp, ep):
    assert all(r["round_trip"][arch][(fsdp, ep)] for r in runs["r4"])


def test_expert_tp_takes_each_experts_gate_and_up_columns(runs):
    """Without ``moe_ep`` rank (d, m) holds, of every expert, the gate and
    up columns of its own hidden features (``_swiglu_tp_perm`` applied per
    expert); with it, experts 4m .. 4m + 3 whole."""
    cfg = get_reduced("deepseek-moe-16b")
    wi = next(lp["moe"]["wi"] for lp in runs["params"]["deepseek-moe-16b"]
              ["blocks"] if "moe" in lp)                  # (nb, E, d, 2f)
    perm = torch.from_numpy(_swiglu_tp_perm(cfg.moe.expert_d_ff, 2))
    f = cfg.moe.expert_d_ff
    for r in runs["r4"]:
        m = r["coords"][1]
        got = r["round_trip"]["deepseek-moe-16b"]
        assert torch.equal(got[("wi", False)],
                           wi[..., perm[m * f:(m + 1) * f]])
        assert torch.equal(got[("wi", True)], wi[:, 4 * m:4 * m + 4])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_collectives_equal_what_the_gloo_run_moved(runs, arch, shape):
    """The reduced cell built on a (2, 2) mesh description and counted on
    meta tensors records, for each collective, the bytes one device sends;
    every rank of the gloo run of the same cell on a (2, 2) process mesh
    sent exactly those, collective by collective."""
    cell = build_cell(arch, shape, MeshSpec(("data", "model"), (2, 2)),
                      reduced=True)
    st = cell.analyze()
    assert st.collective_count and cell.policy is not None
    for r in runs["r4"]:
        got = r["cells"][(arch, shape)]
        assert got["by_op_count"] == st.collective_count
        assert got["by_site_count"] == cell.policy.log.count
        for op, wire in st.collective_by_op.items():
            assert got["by_op_bytes"][op] == pytest.approx(wire, rel=1e-12)
        for site, wire in cell.policy.log.wire.items():
            assert got["by_site_bytes"][site] == pytest.approx(wire,
                                                               rel=1e-12)
