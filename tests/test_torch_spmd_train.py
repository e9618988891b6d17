"""Training under the SPMD policy (``repro_torch.distributed.spmd``,
``training.make_train_step(policy=make_policy(...))``) against the
reference's, on the CPU.

Each case is a reduced config at f32 with the reference's weights
(``weights.params_from_jax``) and the reference's seeded batches
(``make_batch(seq_len=32, batch=4)``, steps 0 and 1), ``loss_chunk`` 8, lr
3e-4: two train steps (the first keeping its gradients before clipping,
``keep_grads``), on 4 gloo ranks
(``launch.spmd.run_ranks``; the rank programs are in
``test_torch_spmd_train_ranks.py``), each rank holding its
``param_shardings`` blocks of the params and moments and its
``shard_batch`` rows.  The cases: reduced qwen3 on (data 2, model 2) with
FSDP on and off, remat none and full, and ``grad_accum=2``; on (1, 4),
whose 2 kv heads do not divide 4 (``kv_len_sharded``); on (pod 2, data 1,
model 2); deepseek on (2, 2) with its experts over "model" and as
expert-TP; mamba2 (remat "dots"), jamba, qwen2-vl and whisper on (2, 2);
8-bit moments on (2, 2) under the options of the single process's 8-bit
case (``test_torch_training.py``).

Each is held against the reference's single-device run and its sharded
run (``jax.jit`` of its ``make_train_step`` under its ``make_policy``,
params, moments and batch placed by ``param_specs``, ``opt_state_specs``
and ``train_batch_specs``) on 8 forced host devices, in two reference
subprocesses that run beside the ranks.

Tolerances, those of ``test_torch_train_parity.py``: loss, aux and lr
within 1e-5 relative, the grad norm within 1e-4; the gathered gradients
within 1e-4 of each leaf's largest magnitude; the params and the moments
after the second step within rtol 1e-3, atol 1e-4; every leaf's block
bit-equal on the ranks that hold the same block (a replicated leaf on
every rank).
"""

import dataclasses
import json
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
import test_torch_spmd_train_ranks as ranks

from repro.configs import get_reduced as jax_reduced
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import init_params as jax_init_params
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.spmd import run_ranks
from repro_torch.tree import flatten_with_path, leaves
from repro_torch.weights import params_from_jax

DM = ("data", "model")
PDM = ("pod", "data", "model")
INT8 = dict(grad_accum=2, quantize_opt=True, schedule="warmup_cosine",
            warmup=2, total_steps=6, clip_norm=0.5)
# (name, arch, axes, shape, fsdp, moe_ep, trainer options)
CASES = [
    ("qwen3", "qwen3-0.6b", DM, (2, 2), True, True, {}),
    ("qwen3-nofsdp", "qwen3-0.6b", DM, (2, 2), False, True, {}),
    ("qwen3-remat", "qwen3-0.6b", DM, (2, 2), True, True, {"remat": "full"}),
    ("qwen3-accum", "qwen3-0.6b", DM, (2, 2), True, True, {"grad_accum": 2}),
    ("qwen3-1x4", "qwen3-0.6b", DM, (1, 4), True, True, {}),
    ("qwen3-pod", "qwen3-0.6b", PDM, (2, 1, 2), True, True, {}),
    ("deepseek-ep", "deepseek-moe-16b", DM, (2, 2), True, True, {}),
    ("deepseek-tp", "deepseek-moe-16b", DM, (2, 2), True, False, {}),
    ("mamba2", "mamba2-370m", DM, (2, 2), True, True, {"remat": "dots"}),
    ("jamba", "jamba-1.5-large-398b", DM, (2, 2), True, True, {}),
    ("qwen2-vl", "qwen2-vl-72b", DM, (2, 2), True, True, {}),
    ("whisper", "whisper-base", DM, (2, 2), True, True, {}),
    ("int8", "qwen3-0.6b", DM, (2, 2), True, True, INT8),
]
ARCHS = sorted({c[1] for c in CASES})
METRIC_RTOL = {"loss": 1e-5, "aux": 1e-5, "lr": 1e-5, "grad_norm": 1e-4}
SPAWN_TIMEOUT_S = 300
REF_TIMEOUT_S = 600

# The reference's runs on 8 forced host devices: each (arch, options) on one
# device (remat changes no value, so one run serves every remat), and each
# case sharded.  One jitted program a run gives the first batch's gradients
# (before clipping) and a train step; it is called once a batch.
REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import contextlib
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.distributed.sharding import (
        make_policy, param_specs, train_batch_specs)
    from repro.launch.mesh import make_mesh_compat
    from repro.models import init_params
    from repro.optim import adamw_init
    from repro.optim.adamw import QTensor, _dq, opt_state_specs
    from repro.training.steps import (
        TrainerConfig, _accumulate_grads, make_loss_fn, make_train_step)

    inp = dict(np.load(sys.argv[1]))
    runs = json.loads(sys.argv[3])
    out = {}

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
                for p, x in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(tree))[0]}

    def moments(params, opt, quantized):
        if not quantized:
            return opt.m, opt.v
        dq = lambda p, q: _dq(q, p.shape)
        isq = lambda x: isinstance(x, QTensor)
        return (jax.tree.map(dq, params, opt.m, is_leaf=isq),
                jax.tree.map(dq, params, opt.v, is_leaf=isq))

    def put(tree, specs, mesh):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))

    for tag, arch, axes, shape, ep, tkw in runs:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        tcfg = TrainerConfig(loss_chunk=8, lr=3e-4, **tkw)
        params = init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw_init(params, quantize=tcfg.quantize_opt)
        batches = [{k.split("/")[2]: jnp.asarray(v) for k, v in inp.items()
                    if k.startswith(f"{arch}/{i}/")} for i in range(2)]
        policy, mesh = None, None
        if axes:
            n = int(np.prod(shape))
            mesh = make_mesh_compat(tuple(shape), tuple(axes),
                                    devices=jax.devices()[:n])
            policy = make_policy(cfg, mesh, batch=4, moe_ep=ep)
            p_specs = param_specs(cfg, mesh, moe_ep=ep)
            with mesh:
                params = put(params, p_specs, mesh)
                opt = put(opt, opt_state_specs(
                    p_specs, quantize=tcfg.quantize_opt, params=params,
                    mesh=mesh), mesh)
                specs = train_batch_specs(cfg, mesh, batch=4)
                batches = [put(b, {k: specs[k] for k in b}, mesh)
                           for b in batches]
        loss_fn = make_loss_fn(cfg, tcfg, policy=policy)
        step = make_train_step(cfg, tcfg, policy=policy, mesh=mesh)

        def both(p, o, b):
            if tcfg.grad_accum > 1:
                g, _ = _accumulate_grads(loss_fn, p, b, tcfg.grad_accum)
            else:
                g, _ = jax.grad(loss_fn, has_aux=True)(p, b)
            return g, step(p, o, b)

        f = jax.jit(both)
        with mesh if mesh is not None else contextlib.nullcontext():
            grads, _ = f(params, opt, batches[0])
            for name, x in flat(grads).items():
                out[f"{tag}/grads{name}"] = x
            for i, b in enumerate(batches):
                _, (params, opt, m) = f(params, opt, b)
                for k, v in m.items():
                    out[f"{tag}/m{i}/{k}"] = np.float64(v)
        m, v = moments(params, opt, tcfg.quantize_opt)
        for what, tree in (("params", params), ("m", m), ("v", v)):
            for name, x in flat(tree).items():
                out[f"{tag}/{what}{name}"] = x
    np.savez(sys.argv[2], **out)
    print("REF-OK")
""")


def _single_key(arch, tkw):
    """The tag of the single-device run a case is held against: remat
    changes no value."""
    return "~".join([arch] + [f"{k}={tkw[k]}" for k in sorted(tkw)
                              if k != "remat"])


def _batches(arch):
    """The reference's seeded train batches 0 and 1 of the reduced
    config."""
    cfg = jax_reduced(arch)
    return [{k: np.ascontiguousarray(v) for k, v in jax_make_batch(
        cfg, seq_len=ranks.SEQ, batch=ranks.B, step=i, seed=0,
        reduced=True).items()} for i in range(2)]


def _ref_runs():
    """[tag, arch, axes, shape, moe_ep, options]: each case sharded, each
    single-device key once (axes empty)."""
    single = {}
    for _, arch, _, _, _, ep, tkw in CASES:
        single.setdefault(_single_key(arch, tkw), [
            _single_key(arch, tkw), arch, [], [], True,
            {k: v for k, v in tkw.items() if k != "remat"}])
    sharded = [[name, arch, list(axes), list(shape), ep, tkw]
               for name, arch, axes, shape, _, ep, tkw in CASES]
    return list(single.values()) + sharded


@pytest.fixture(scope="module")
def runs():
    """Two reference subprocesses (started first, running beside the
    ranks, each taking half the runs) and 4 ranks running every case."""
    batches = {a: _batches(a) for a in ARCHS}
    tmp = tempfile.mkdtemp(prefix="spmd-train-ref-")
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, **{f"{a}/{i}/{k}": v for a, bs in batches.items()
                     for i, b in enumerate(bs) for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    root = os.path.join(os.path.dirname(__file__), "..")
    todo = _ref_runs()
    procs = []
    for part in range(2):
        path = os.path.join(tmp, f"out{part}.npz")
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, inp, path,
             json.dumps(todo[part::2])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root)))
    try:
        params = {a: params_from_jax(jax.device_get(jax_init_params(
            dataclasses.replace(jax_reduced(a), dtype="float32"),
            jax.random.PRNGKey(0))), device="cpu") for a in ARCHS}
        tb = {a: [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]
              for a, bs in batches.items()}
        r4 = run_ranks(ranks.ranks_train, 4, args=({
            "params": params, "batches": tb, "cases": CASES,
            "hook_off": ("deepseek-moe-16b", DM, (2, 2))},),
            timeout=SPAWN_TIMEOUT_S)
        ref = {}
        for path, p in procs:
            stdout, stderr = p.communicate(timeout=REF_TIMEOUT_S)
            assert p.returncode == 0 and "REF-OK" in stdout, stderr[-3000:]
            ref.update(np.load(path))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"ref": ref, "r4": r4}


def _ref_tree(ref, tag, what):
    prefix = f"{tag}/{what}"
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix + "[")}


def _assert_grads(got, want, tol=1e-4):
    flat = flatten_with_path(got)
    assert sorted(k for k, _ in flat) == sorted(want)
    for key, t in flat:
        w = want[key]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(t.float().numpy() - w).max()) / scale
        assert err <= tol, f"grad {key}: {err:.3e} of its largest"


def _assert_tree(got, want, what):
    flat = flatten_with_path(got)
    assert sorted(k for k, _ in flat) == sorted(want), what
    for key, t in flat:
        np.testing.assert_allclose(t.float().numpy(), want[key], rtol=1e-3,
                                   atol=1e-4, err_msg=f"{what} {key}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_training_under_the_policy_matches_both_reference_runs(runs, case):
    name, arch, _, _, _, _, tkw = case
    got = runs["r4"][0]["cases"][name]
    for tag in (_single_key(arch, tkw), name):
        ref = runs["ref"]
        _assert_grads(got["grads"], _ref_tree(ref, tag, "grads"))
        for i, m in enumerate(got["metrics"]):
            for k, rtol in METRIC_RTOL.items():
                np.testing.assert_allclose(m[k], float(ref[f"{tag}/m{i}/{k}"]),
                                           rtol=rtol, atol=1e-7,
                                           err_msg=f"{tag} step {i} {k}")
            assert m["tokens"] == float(ref[f"{tag}/m{i}/tokens"])
        for what in ("params", "m", "v"):
            _assert_tree(got[what], _ref_tree(ref, tag, what),
                         f"{name} against {tag}: {what}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_rank_holding_a_block_holds_it_bit_for_bit(runs, case):
    """After two steps, the ranks that hold the same block of a leaf (every
    rank, for a replicated leaf) hold it bit for bit, params and moments
    alike, and every rank gathers the same metrics."""
    name = case[0]
    rows = [r["cases"][name] for r in runs["r4"]]
    axes = case[2]
    for what in ("params", "m", "v"):
        for i, split in enumerate(rows[0]["split"]):
            owners = {}
            for r in rows:
                key = tuple(c for a, c in zip(axes, r["coords"]) if a in split)
                owners.setdefault(key, []).append(
                    leaves(r["local"][what])[i])
            for blocks in owners.values():
                for b in blocks[1:]:
                    assert torch.equal(b, blocks[0]), (name, what, i, split)
    for r in rows[1:]:
        assert r["metrics"] == rows[0]["metrics"]


def test_the_layouts_the_cases_cover(runs):
    """The cases reach the policy's branches: length-sharded attention on
    (1, 4); the batch over "pod" on the pod mesh; FSDP's reduce-scatters,
    the entry hooks' sums and the SSM norm's backward sum."""
    cases = runs["r4"][0]["cases"]
    assert cases["qwen3-1x4"]["kv_len_sharded"]
    assert not cases["qwen3"]["kv_len_sharded"]
    assert cases["qwen3-pod"]["batch_axes"] == ("pod", "data")
    assert cases["qwen3"]["log"]["bwd:gather-data"] > 0
    assert "bwd:gather-data" not in cases["qwen3-nofsdp"]["log"]
    assert cases["deepseek-ep"]["log"]["bwd:moe_weights"] > 0
    assert cases["mamba2"]["log"]["bwd:ssm-norm"] > 0
    assert cases["whisper"]["log"]["bwd:enc_in"] > 0


def test_a_switched_off_entry_hook_gives_the_router_a_wrong_gradient(runs):
    """The check can fail: with the MoE's combine weights passing into the
    split experts without their sum over "model" in the backward, the
    router's gathered gradient is no longer the reference's (nor, through
    the router's share of the normed input's gradient, are the layers'
    below it)."""
    want = _ref_tree(runs["ref"], "deepseek-ep", "grads")
    got = dict(flatten_with_path(runs["r4"][0]["hook_off"]["grads"]))
    routers = [k for k in want if k.endswith("['router']")]
    assert routers
    for key in routers:
        w = want[key]
        err = float(np.abs(got[key].numpy() - w).max()) / float(
            np.abs(w).max())
        assert err > 1e-2, (key, err)
    with pytest.raises(AssertionError, match="of its largest"):
        _assert_grads(runs["r4"][0]["hook_off"]["grads"], want)


def test_compress_pods_under_a_live_policy_is_refused_for_the_references_reason(
        runs):
    for r in runs["r4"]:
        assert r["refused"] is not None
        assert "shard_map over 'pod'" in r["refused"]
        assert "make_policy" in r["refused"]


def test_the_train_cell_records_what_the_gloo_run_moved(runs):
    """The reduced train cell on the (2, 2) description, counted on meta
    tensors, records the bytes one device sends in each collective,
    forward and backward; every rank of the gloo run of the same cell sent
    exactly those, collective by collective."""
    cell = build_cell("qwen3-0.6b", "train_4k",
                      MeshSpec(("data", "model"), (2, 2)), reduced=True)
    st = cell.analyze()
    assert st.collective_count["reduce-scatter"] > 0
    assert any(k.startswith("bwd:") for k in cell.policy.log.count)
    for r in runs["r4"]:
        got = r["cell"]
        assert got["by_op_count"] == st.collective_count
        assert got["by_site_count"] == cell.policy.log.count
        for op, wire in st.collective_by_op.items():
            assert got["by_op_bytes"][op] == pytest.approx(wire, rel=1e-12)
        for site, wire in cell.policy.log.wire.items():
            assert got["by_site_bytes"][site] == pytest.approx(wire,
                                                               rel=1e-12)
