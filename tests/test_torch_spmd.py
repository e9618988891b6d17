"""The port's SPMD runtime (``repro_torch.distributed.spmd``,
``launch.mesh`` process meshes, ``compression.pod_psum_compressed``, the
``"pod"`` branch of ``training.make_train_step``) against the reference's,
on the CPU.

The port's ranks are processes of one gloo group
(``repro_torch.launch.spmd.run_ranks``; their programs are in
``test_torch_spmd_ranks.py``), one intra-op thread each.  The reference
runs its sharded programs on 8 forced host devices in a subprocess, as
``tests/test_multidevice.py`` does (that file is untouched).  Three
launches serve the whole file, each checking many things: 8 ranks on a
(data 2, model 4) mesh, 2 ranks on the (1, 2), (2, 1) and ("pod" 2)
meshes, and the reference's subprocess, which runs beside the ranks.

Tolerances: logits within 1e-5 at f32 (the reference's and the port's
f32 arithmetic in another order: partial sums over "model", the merge of
the cache's length shards) and within 2e-2 at bf16 (the reference test's
own); tokens exactly.  ``pod_psum_compressed`` is bit for bit.  The
``compress_pods`` train step: loss within 1e-5 and grad norm within 1e-4
relative, as the train parity tests hold them; params after one AdamW
step within 2 lr, since AdamW turns a rounding-level gradient into an
update of about +-lr and the int8 wire rounds each pod's share to a grid
1 / 63.5 of its block's largest value, so the two packages' f32 gradients
may round to neighbouring points.
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
import test_torch_spmd_ranks as ranks

from repro.configs import get_reduced as jax_reduced
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import _swiglu_tp_perm
from repro_torch.distributed.spmd import make_policy, policy_supported
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_merge_ref, decode_attention_ref)
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import MeshSpec, make_host_mesh
from repro_torch.launch.spmd import run_ranks
from repro_torch.models.attention import _decode_attn_torch
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

ARCH = "qwen3-0.6b"
B, PROMPT, MAX_LEN = 4, 8, 32
WRAP_PROMPT, WRAP_LEN = 20, 16
LR = 3e-4
SPAWN_TIMEOUT_S = 300          # a launch that hangs fails the tests here
REF_TIMEOUT_S = 600

# The reference's runs, on 8 forced host devices: the (2, 4) scenario of
# tests/test_multidevice.py at f32 and bf16 (single-device and sharded),
# the wrapped ring single-device, pod_psum_compressed and a compress_pods
# train step on a ("pod",) mesh of 2.
REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.distributed.compression import pod_psum_compressed
    from repro.distributed.sharding import (
        cache_specs, make_policy, shard_map_compat)
    from repro.launch.mesh import make_mesh_compat
    from repro.models import init_params
    from repro.optim import adamw_init
    from repro.serving.engine import (
        ServeConfig, make_prefill_step, make_serve_step)
    from repro.training.steps import TrainerConfig, make_train_step

    inp = dict(np.load(sys.argv[1]))
    out = {}
    base = get_reduced("qwen3-0.6b")

    def f32(x):
        return np.asarray(x, np.float32)

    def run(cfg, toks, max_len, mesh=None, name=""):
        scfg = ServeConfig(max_len=max_len)
        params = init_params(cfg, jax.random.PRNGKey(0))
        out[name + "checksum"] = np.float64(sum(
            np.abs(f32(l)).astype(np.float64).sum()
            for l in jax.tree.leaves(params)))
        logits0, caches = jax.jit(make_prefill_step(cfg, scfg))(
            params, {"tokens": toks})
        t = jnp.argmax(logits0[..., : cfg.vocab], -1).astype(jnp.int32)
        cur = jnp.full((toks.shape[0],), toks.shape[1], jnp.int32)
        out[name + "first"] = f32(logits0)
        step = jax.jit(make_serve_step(cfg, scfg))
        keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
        c, tok = caches, t
        for i in range(2):
            tok, lg, c = step(params, tok, c, cur + i, keys[i])
            out[name + f"tok{i}"] = np.asarray(tok)
            out[name + f"logits{i}"] = f32(lg)
        if mesh is None:
            return
        policy = make_policy(cfg, mesh, batch=toks.shape[0])
        assert policy.kv_len_sharded
        with mesh:
            c_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                cache_specs(cfg, mesh, batch=toks.shape[0]),
                                is_leaf=lambda x: isinstance(x, P))
            c = jax.device_put(caches, c_sh)
            step_sh = jax.jit(make_serve_step(cfg, scfg, policy=policy))
            tok = t
            for i in range(2):
                tok, lg, c = step_sh(params, tok, c, cur + i, keys[i])
                out[name + f"sh_tok{i}"] = np.asarray(tok)
                out[name + f"sh_logits{i}"] = f32(lg)
        out[name + "sh_kv_dtype"] = str(jax.tree.leaves(c.kv)[0].dtype)

    mesh = make_mesh_compat((2, 4), ("data", "model"))
    toks = jnp.asarray(inp["toks"])
    for dt in ("float32", "bfloat16"):
        run(dataclasses.replace(base, dtype=dt), toks, inp["max_len"].item(),
            mesh, dt + "_")
    run(dataclasses.replace(base, dtype="float32"),
        jnp.asarray(inp["toks_wrap"]), inp["wrap_len"].item(), name="wrap_")

    pmesh = make_mesh_compat((2,), ("pod",), devices=jax.devices()[:2])
    names = sorted(k[3:] for k in inp if k.startswith("pg_"))
    g = {n: jnp.asarray(inp["pg_" + n]) for n in names}
    e = {n: jnp.asarray(inp["pe_" + n]) for n in names}

    def per_pod(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        red, e_new = pod_psum_compressed(g, e, axis="pod")
        return red, jax.tree.map(lambda x: x[None], e_new)

    red, e_new = jax.jit(shard_map_compat(
        per_pod, pmesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P("pod")), manual_axes={"pod"}))(g, e)
    for n in names:
        out["psum_red_" + n] = np.asarray(red[n])
        out["psum_efb_" + n] = np.asarray(e_new[n])

    cfg = dataclasses.replace(base, dtype="float32")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = TrainerConfig(compress_pods=True, lr=inp["lr"].item())
    batch = {k[6:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith("batch_")}
    p2, _, metrics = jax.jit(make_train_step(cfg, tcfg, mesh=pmesh))(
        params, adamw_init(params), batch)
    for i, leaf in enumerate(jax.tree.leaves(p2)):
        out[f"train_p{i}"] = np.asarray(leaf)
    for k, v in metrics.items():
        out["train_m_" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("REF-OK")
""")


def _pod_tree(rng):
    """Two pods' gradients and error feedback: a leaf that fills its int8
    blocks, a ragged one (a padded last block), one with a block of zeros
    and one spanning three orders of magnitude."""
    shapes = {"a": (4, 128), "b": (300,), "c": (2, 256), "d": (17, 9)}
    g = {n: rng.standard_normal((2,) + s).astype(np.float32)
         for n, s in shapes.items()}
    g["c"][:, 0, :] = 0.0
    g["d"] *= np.logspace(-3, 0, 9, dtype=np.float32)
    e = {n: (rng.standard_normal((2,) + s) * 1e-3).astype(np.float32)
         for n, s in shapes.items()}
    return g, e


def _merge_case(rng):
    """A (B 4, H 4, dh 32) query over a 32-slot cache of 2 kv heads, split
    4 ways: row 0 every slot valid; row 1 valid only in the second block;
    row 2 no valid slot anywhere; row 3 a wrapped ring (slots 0-9 hold
    positions 32-41)."""
    q = torch.from_numpy(rng.standard_normal((4, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 32, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 32, 2, 32)).astype(np.float32))
    pos = torch.arange(32, dtype=torch.int32).repeat(4, 1)
    pos[1, :8] = -1
    pos[2] = -1
    pos[3, :10] += 32
    cur = torch.tensor([31, 15, 31, 41], dtype=torch.int32)
    return {"q": q, "k": k, "v": v, "pos": pos, "cur": cur}


@pytest.fixture(scope="module")
def runs():
    """One run of each launch: the reference's subprocess (started first,
    running beside the ranks), 8 ranks on (2, 4), 2 ranks on (1, 2), (2, 1)
    and ("pod" 2)."""
    rng = np.random.default_rng(0)
    toks = ((np.arange(B * PROMPT, dtype=np.int32).reshape(B, PROMPT) * 3 + 1)
            % get_reduced(ARCH).vocab)
    toks_wrap = rng.integers(0, get_reduced(ARCH).vocab, (B, WRAP_PROMPT),
                             dtype=np.int32)
    pod_g, pod_e = _pod_tree(rng)
    jcfg = dataclasses.replace(jax_reduced(ARCH), dtype="float32")
    batch = jax_make_batch(jcfg, seq_len=16, batch=4, step=0, seed=0)
    tmp = tempfile.mkdtemp(prefix="spmd-ref-")
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, toks=toks, toks_wrap=toks_wrap, max_len=MAX_LEN,
             wrap_len=WRAP_LEN, lr=LR,
             **{f"pg_{n}": x for n, x in pod_g.items()},
             **{f"pe_{n}": x for n, x in pod_e.items()},
             **{f"batch_{k}": v for k, v in batch.items()})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    root = os.path.join(os.path.dirname(__file__), "..")
    ref_out = os.path.join(tmp, "out.npz")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, inp, ref_out],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=root)
    try:
        params = {dt: params_from_jax(jax.device_get(jax_init_params(
            dataclasses.replace(jax_reduced(ARCH), dtype=dt),
            jax.random.PRNGKey(0))), device="cpu")
            for dt in ("float32", "bfloat16")}
        tt = torch.from_numpy
        data8 = {"params_f32": params["float32"],
                 "params_bf16": params["bfloat16"], "toks": tt(toks),
                 "toks_wrap": tt(toks_wrap),
                 "boundary_ids": torch.tensor(
                     [[0, 127, 128, 255], [256, 383, 384, 511]]),
                 "merge_case": _merge_case(rng)}
        r8 = run_ranks(ranks.ranks_2x4, 8, args=(data8,),
                       timeout=SPAWN_TIMEOUT_S)
        data2 = {"params_f32": params["float32"], "toks": tt(toks),
                 "pod_grads": [{n: tt(x[r]) for n, x in pod_g.items()}
                               for r in range(2)],
                 "pod_efb": [{n: tt(x[r]) for n, x in pod_e.items()}
                             for r in range(2)],
                 "batch": {k: tt(np.ascontiguousarray(v))
                           for k, v in batch.items()},
                 "lr": LR}
        r2 = run_ranks(ranks.ranks_2, 2, args=(data2,),
                       timeout=SPAWN_TIMEOUT_S)
        stdout, stderr = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF-OK" in stdout, stderr[-3000:]
    out = dict(np.load(ref_out))
    return {"ref": out, "r8": r8, "r2": r2, "params": params,
            "pod_g": pod_g, "pod_e": pod_e}


def _assert_logits(got, want, atol):
    got = got.float().numpy()
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()           # the vocab mask
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=atol)


def _check_serve(res, ref, prefix, atol, *, sharded_ref=True):
    _assert_logits(res["first"], ref[prefix + "first"], atol)
    for i, (tok, logits) in enumerate(res["steps"]):
        np.testing.assert_array_equal(tok.numpy(), ref[prefix + f"tok{i}"])
        if sharded_ref:
            np.testing.assert_array_equal(tok.numpy(),
                                          ref[prefix + f"sh_tok{i}"])
        _assert_logits(logits, ref[prefix + f"logits{i}"], atol)


# ---------------------------------------------------------------------------
# (a) the reference's test_multidevice scenario on (2, 4)
# ---------------------------------------------------------------------------


def test_reference_params_are_the_ones_the_ranks_hold(runs):
    for dt in ("float32", "bfloat16"):
        mine = sum(np.abs(t.float().numpy()).astype(np.float64).sum()
                   for t in leaves(runs["params"][dt]))
        assert mine == pytest.approx(float(runs["ref"][dt + "_checksum"]),
                                     rel=1e-12)


@pytest.mark.parametrize("flow", ["f32_placed", "f32_policy",
                                  "f32_cuda_route"])
def test_length_sharded_decode_matches_the_reference_at_f32(runs, flow):
    """Two serve steps under make_policy on (data 2, model 4): the tokens of
    the reference's single-device run and of its sharded run, logits within
    1e-5; after a single-device prefill placed by cache_specs, after a
    prefill under the policy, and on the kernels' route (their plain
    versions on the CPU: the decode kernel's stats route) with the params
    off the "data" axis."""
    res = runs["r8"][0][flow]
    assert res["kv_len_sharded"]
    # batch 4 over "data" 2, the 32-slot ring over "model" 4
    assert res["cache_shape"] == (2, 2, 8, 2, 32)     # (layers, B, C, Hkv, dh)
    assert res["cache_dtypes"] == (torch.float32, torch.float32, torch.int32)
    _check_serve(res, runs["ref"], "float32_", 1e-5)


def test_length_sharded_decode_matches_the_reference_at_bf16(runs):
    res = runs["r8"][0]["bf16_placed"]
    assert res["cache_dtypes"] == (torch.bfloat16, torch.bfloat16, torch.int32)
    assert runs["ref"]["bfloat16_sh_kv_dtype"] == "bfloat16"
    _check_serve(res, runs["ref"], "bfloat16_", 2e-2)


def test_a_wrapped_ring_matches_the_reference(runs):
    """A 20-token prompt in a 16-slot ring (4 slots a model rank): the
    first steps overwrite the oldest slots, on another rank than the
    prompt's last token."""
    res = runs["r8"][0]["wrap"]
    assert res["cache_shape"] == (2, 2, 4, 2, 32)
    _check_serve(res, runs["ref"], "wrap_", 1e-5, sharded_ref=False)


def test_every_rank_holds_the_same_result(runs):
    r8 = runs["r8"]
    assert sorted(r["coords"] for r in r8) == [(d, m) for d in range(2)
                                               for m in range(4)]
    for r in r8[1:]:
        for flow in ("f32_placed", "f32_policy", "bf16_placed", "wrap"):
            for (t0, l0), (t, lg) in zip(r8[0][flow]["steps"],
                                         r[flow]["steps"]):
                assert torch.equal(t, t0) and torch.equal(lg, l0)


def test_the_collectives_of_a_length_sharded_step(runs):
    """Per layer: 10 gathers of the FSDP and attention blocks (wq, wk, wv,
    wo over "data" and "model"; the MLP's two over "data"), one sum of
    the MLP output and the merge's MAX and SUM; once a step: the embedding
    sum and the logits gather."""
    log = runs["r8"][0]["f32_policy"]["log"]
    n = get_reduced(ARCH).n_layers
    # the prefill (no merge) and two steps
    assert log == {"embed": 3, "gather-data": 18 * n, "gather-model": 12 * n,
                   "mlp_out": 3 * n, "attn-merge-max": 2 * n,
                   "attn-merge-sum": 2 * n, "logits": 3}


# ---------------------------------------------------------------------------
# (b) the head-aligned and the data-only meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_head_aligned_and_data_only_meshes_match_the_reference(runs, shape):
    res = runs["r2"][0][shape]
    assert not res["kv_len_sharded"]
    _check_serve(res, runs["ref"], "float32_", 1e-5, sharded_ref=False)
    n = get_reduced(ARCH).n_layers
    if shape == (1, 2):
        # 2 kv heads, one a rank: local attention, both outputs summed
        assert res["cache_shape"] == (2, 4, 32, 1, 32)
        assert res["log"] == {"embed": 3, "attn_out": 3 * n,
                              "mlp_out": 3 * n, "logits": 3}
    else:
        assert res["cache_shape"] == (2, 2, 32, 2, 32)
        assert res["log"] == {"gather-data": 3 * 6 * n}


# ---------------------------------------------------------------------------
# (c) the vocab-parallel embedding, (d) the parameter placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vocab_parallel_embed_is_the_plain_take_bit_for_bit(runs, dtype):
    assert all(r[f"embed_{dtype}"] for r in runs["r8"])


@pytest.mark.parametrize("fsdp", [1, 0])
def test_param_shardings_round_trip_bit_for_bit(runs, fsdp):
    """Every rank's blocks gather back to the full tree, and rank (d, m)
    holds swiglu wi's gate and up columns of its own hidden features:
    ``_swiglu_tp_perm``'s block m (rows of data block d under FSDP)."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    wi = runs["params"]["float32"]["blocks"][0]["mlp"]["wi"]
    perm = torch.from_numpy(_swiglu_tp_perm(cfg.d_ff, 4))
    f = 2 * cfg.d_ff // 4
    for r in runs["r8"]:
        assert r[f"roundtrip_fsdp{fsdp}"]
        d, m = r["coords"]
        want = wi[..., perm[m * f:(m + 1) * f]]
        if fsdp:
            rows = cfg.d_model // 2
            want = want[:, d * rows:(d + 1) * rows]
        assert torch.equal(r[f"wi_block_fsdp{fsdp}"], want)


# ---------------------------------------------------------------------------
# (f) the decode kernel's stats route and the merge
# ---------------------------------------------------------------------------


def test_the_merge_across_model_ranks_handles_empty_shards(runs):
    """The policy's merge of four length blocks equals attention over the
    whole cache in every row: one block with valid slots, none at all (the
    mean of V over all 32 slots), a wrapped ring."""
    for r in runs["r8"]:
        got = r["merge"]
        np.testing.assert_allclose(got["merged"].numpy(), got["whole"].numpy(),
                                   rtol=0, atol=1e-6)
    for r in runs["r8"]:
        valid = r["merge"]["rows_valid"].tolist()
        # rows 0 and 3 everywhere, row 1 in the second block, row 2 nowhere
        assert valid == [True, r["coords"][1] == 1, False, True]


def _split(x, n, dim=1):
    return list(torch.chunk(x, n, dim=dim))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_route_merged_over_three_shards_equals_the_whole_cache(window,
                                                                     dtype):
    """``decode_attention_ref(return_stats=True)`` on three length shards of
    a 48-slot cache (one shard without a valid slot for row 1, no valid
    slot anywhere for row 2), merged by ``decode_attention_merge_ref``,
    equals the whole cache's ``decode_attention_ref``; so does the torch
    route's ``_decode_attn_torch(return_stats=True)``.  (m, l) of the whole
    cache are the kernel's: the max scaled score and sum exp(s - m)."""
    rng = np.random.default_rng(3)
    Bq, C, H, Hkv, dh = 3, 48, 8, 2, 32
    q = torch.from_numpy(rng.standard_normal((Bq, H, dh)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((Bq, C, Hkv, dh)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((Bq, C, Hkv, dh)).astype(np.float32)).to(dtype)
    pos = torch.arange(C, dtype=torch.int32).repeat(Bq, 1)
    pos[1, 16:] = -1
    pos[2] = -1
    cur = torch.tensor([40, 20, 47], dtype=torch.int32)
    whole, m, l = decode_attention_ref(q, k, v, pos, cur, window=window,
                                       return_stats=True)
    assert torch.equal(whole, decode_attention_ref(q, k, v, pos, cur,
                                                   window=window))
    assert (m[2] == -1e30).all() and (l[2] == C).all()
    parts = [decode_attention_ref(q, ks, vs, ps, cur, window=window,
                                  return_stats=True)
             for ks, vs, ps in zip(_split(k, 3), _split(v, 3),
                                   _split(pos, 3))]
    assert (parts[2][1][1] == -1e30).all()          # shard 3 empty for row 1
    merged = decode_attention_merge_ref(*zip(*parts))
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(merged.float().numpy(), whole.float().numpy(),
                               rtol=0, atol=tol)
    cfg = dataclasses.replace(get_reduced(ARCH), sliding_window=window)
    tparts = [_decode_attn_torch(q[:, None], ks, vs, ps, cur, cfg,
                                 return_stats=True)
              for ks, vs, ps in zip(_split(k, 3), _split(v, 3),
                                    _split(pos, 3))]
    tmerged = decode_attention_merge_ref(*zip(*((o[:, 0], mm, ll)
                                                for o, mm, ll in tparts)))
    twhole = _decode_attn_torch(q[:, None], k, v, pos, cur, cfg)[:, 0]
    np.testing.assert_allclose(tmerged.float().numpy(), twhole.float().numpy(),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# (g) a cell's recorded collectives against a gloo run of its program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_cell_collectives_equal_what_the_gloo_run_moved(runs, shape):
    """The reduced cell built on a (2, 4) mesh description and counted on
    meta tensors records, for each collective, the bytes one device sends
    (a train cell's backward included); every rank of the gloo run of the
    same cell on a (2, 4) process mesh sent exactly those, collective by
    collective.  ``tests/test_torch_spmd_train.py`` holds the train cell
    on (2, 2) too."""
    cell = build_cell(ARCH, shape, MeshSpec(("data", "model"), (2, 4)),
                      reduced=True)
    st = cell.analyze()
    assert st.collective_count and cell.policy is not None
    for r in runs["r8"]:
        got = r["cells"][shape]
        assert got["by_op_count"] == st.collective_count
        assert got["by_site_count"] == cell.policy.log.count
        for op, wire in st.collective_by_op.items():
            assert got["by_op_bytes"][op] == pytest.approx(wire, rel=1e-12)
        for site, wire in cell.policy.log.wire.items():
            assert got["by_site_bytes"][site] == pytest.approx(wire,
                                                               rel=1e-12)


def test_a_cell_on_one_device_records_no_collective():
    cell = build_cell(ARCH, "decode_32k", make_host_mesh((1, 1), device="cpu"),
                      reduced=True)
    st = cell.analyze()
    assert st.collective_count == {} and cell.policy is not None


# ---------------------------------------------------------------------------
# (e) the "pod" axis: pod_psum_compressed and a compress_pods train step
# ---------------------------------------------------------------------------


def test_pod_psum_compressed_equals_the_reference_bit_for_bit(runs):
    ref = runs["ref"]
    for rank, r in enumerate(runs["r2"]):
        red, efb, count, wire = r["psum"]
        for n in red:
            np.testing.assert_array_equal(red[n].numpy(), ref["psum_red_" + n])
            np.testing.assert_array_equal(efb[n].numpy(),
                                          ref["psum_efb_" + n][rank])
        # one MAX of 4 B a block and one int8 SUM of 1 B an element a leaf
        assert count == {"pod-scale-max": 4, "pod-int8-sum": 4}
        blocks = sum(-(-x[0].size // 256) for x in runs["pod_g"].values())
        assert wire["pod-scale-max"] == 2 * 4 * blocks * 1 / 2
        assert wire["pod-int8-sum"] == 2 * 256 * blocks * 1 / 2


def test_compress_pods_train_step_matches_the_reference(runs):
    ref = runs["ref"]
    r0, r1 = (r["train"] for r in runs["r2"])
    for k in ("loss", "grad_norm", "tokens", "aux", "lr"):
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    rtol = {"loss": 1e-5, "aux": 1e-5, "lr": 1e-5, "grad_norm": 1e-4,
            "tokens": 0}
    for k, tol in rtol.items():
        want = float(ref["train_m_" + k])
        assert float(r0["metrics"][k]) == pytest.approx(want, rel=tol,
                                                        abs=1e-12), k
    # the loss is the mean of the two pods' losses
    assert float(r0["metrics"]["loss"]) == pytest.approx(
        (float(r0["local_loss"]) + float(r1["local_loss"])) / 2, rel=1e-6)
    got = leaves(r0["params"])
    assert len(got) == sum(1 for k in ref if k.startswith("train_p"))
    for i, (a, b) in enumerate(zip(got, leaves(r1["params"]))):
        assert torch.equal(a, b)                     # every pod takes one step
        np.testing.assert_allclose(a.numpy(), ref[f"train_p{i}"], rtol=0,
                                   atol=2 * LR)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b",
                                  "whisper-base"])
def test_make_policy_builds_a_policy_for_every_family(arch):
    """make_policy covers the MoE, SSM, hybrid, VLM and audio families: on
    the (2, 4) and 16 x 16 descriptions, reduced and full width, with
    ``moe_ep`` both ways, its batch axes, ``kv_len_sharded`` and
    ``vocab_parallel`` are the reference's, and it puts the experts over
    "model" where the reference sets its ``"moe_ecap"`` rule."""
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jax_config
    from repro.distributed.sharding import make_policy as jax_make_policy
    from repro_torch.configs import get_config

    for cfg, jcfg in ((get_reduced(arch), jax_reduced(arch)),
                      (get_config(arch), jax_config(arch))):
        assert policy_supported(cfg) is None
        for shape in ((2, 4), (16, 16)):
            for ep in (True, False):
                pol = make_policy(cfg, MeshSpec(("data", "model"), shape),
                                  batch=4, moe_ep=ep)
                ref = jax_make_policy(jcfg, AbstractMesh(shape,
                                                         ("data", "model")),
                                      batch=4, moe_ep=ep)
                assert pol.batch_axes == ref.batch_axes
                assert pol.kv_len_sharded == ref.kv_len_sharded
                assert pol.vocab_parallel == ref.vocab_parallel
                assert pol.moe_ep == ("moe_ecap" in ref.rules)


def test_a_cache_that_does_not_split_over_model_is_refused():
    cfg = get_reduced(ARCH)
    pol = make_policy(cfg, MeshSpec(("data", "model"), (1, 3)), batch=4)
    assert pol.kv_len_sharded and not pol.vocab_parallel     # 512 % 3
    assert pol.kv_block(cfg, 48) is None        # a description: the whole ring
    with pytest.raises(ValueError, match="C % model"):
        pol.kv_block(cfg, 16)


def test_a_ring_block_seeds_what_the_whole_ring_holds_there():
    """``seed_kv_cache(block=(lo, hi))`` equals slots [lo, hi) of the whole
    ring, for a prompt that wraps it."""
    from repro_torch.serving.kv_cache import seed_kv_cache

    cfg = get_reduced(ARCH)
    k = torch.randn(2, 3, 20, 2, 4)
    v = torch.randn(2, 3, 20, 2, 4)
    whole = seed_kv_cache(cfg, k, v, max_len=16)
    for lo in range(0, 16, 4):
        part = seed_kv_cache(cfg, k, v, max_len=16, block=(lo, lo + 4))
        for got, want in zip(part, whole):
            assert torch.equal(got, want[:, :, lo:lo + 4])


def test_the_paged_and_verify_paths_refuse_the_policy():
    """A length-sharded policy keeps the reference's refusal on the verify
    path; a head-aligned one runs it."""
    from repro_torch.models import init_caches, init_params, verify_step

    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    caches = init_caches(cfg, 2, 16, device="cpu")
    toks = torch.zeros(2, 3, dtype=torch.int32)
    cur = torch.zeros(2, dtype=torch.int32)
    pol = make_policy(cfg, MeshSpec(("data", "model"), (1, 4)), batch=2)
    with pytest.raises(NotImplementedError,
                       match="verify decode does not support a length-sharded"):
        verify_step(params, toks, caches, cur, cfg, impl="torch", policy=pol)
    # head-aligned, the verify path runs under the policy: on a mesh
    # description its program is the global one, the collectives recorded
    heads = make_policy(cfg, MeshSpec(("data", "model"), (1, 2)), batch=2)
    plain, _ = verify_step(params, toks, init_caches(cfg, 2, 16, device="cpu"),
                           cur, cfg, impl="torch")
    got, _ = verify_step(params, toks, caches, cur, cfg, impl="torch",
                         policy=heads)
    assert torch.equal(got, plain)
    assert heads.log.count["attn_out"] == cfg.n_layers


def test_a_mesh_of_several_devices_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh((2, 4), device="cpu")


def test_pod_psum_plain_version_equals_the_gloo_run(runs):
    """``pod_psum_compressed_ref`` (one process, the pods' gradients side by
    side: the phase-5n gate on the card) gives what the two gloo ranks
    gave, bit for bit."""
    from repro_torch.distributed.compression import pod_psum_compressed_ref

    for n, g in runs["pod_g"].items():
        red, efb = pod_psum_compressed_ref(
            [torch.from_numpy(g[r]) for r in range(2)],
            [torch.from_numpy(runs["pod_e"][n][r]) for r in range(2)])
        for rank, r in enumerate(runs["r2"]):
            assert torch.equal(red, r["psum"][0][n])
            assert torch.equal(efb[rank], r["psum"][1][n])


def test_training_refuses_a_policy_that_splits_the_model():
    """Training runs under a policy that splits "data" and "model"; what
    stays refused is ``compress_pods`` under a policy over a "pod" axis,
    where the reference's own step fails (its ``shard_map`` over "pod"
    cannot take the policy's rules), and a process mesh that splits "data"
    or "model" without a policy.  A live policy's refusal is held in
    ``tests/test_torch_spmd_train.py``."""
    from repro_torch.training import TrainerConfig, make_train_step

    cfg = get_reduced(ARCH)
    for shape in ((2, 1, 2), (2, 2, 1)):
        mesh = MeshSpec(("pod", "data", "model"), shape)
        with pytest.raises(NotImplementedError, match="shard_map over 'pod'"):
            make_train_step(cfg, TrainerConfig(compress_pods=True),
                            policy=make_policy(cfg, mesh, batch=4), mesh=mesh)
        # uncompressed, the pods' gradients are summed under the policy
        make_train_step(cfg, TrainerConfig(), mesh=mesh,
                        policy=make_policy(cfg, mesh, batch=4))
    # the policy over (data, model): the step builds
    make_train_step(cfg, TrainerConfig(), policy=make_policy(
        cfg, MeshSpec(("data", "model"), (2, 4)), batch=4))


def test_a_train_cell_on_the_two_pod_description_is_the_global_program():
    """The dry-run's train cells over the 2 x 16 x 16 description build
    under the policy (the reference's uncompressed GSPMD branch, with its
    ``make_policy``): the global program, each collective and its adjoint
    recorded, the gradients summed over "pod" and "data"; only
    ``compress_pods`` there needs the pods' processes."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.training import TrainerConfig, make_train_step

    mesh = make_production_mesh(multi_pod=True)
    cell = build_cell(ARCH, "train_4k", mesh, reduced=True)
    assert cell.policy is not None and cell.analyze().flops > 0
    count = cell.policy.log.count
    # 4 rows of the reduced batch split over "pod" (2) and "data" (16
    # does not divide 4 / 2): the count and the loss over "pod"
    assert cell.policy.batch_axes == ("pod",)
    assert count["tokens"] == count["loss"] == 1
    assert count["bwd:logits_in"] == 1 and count["grad-sum"] >= 1
    with pytest.raises(NotImplementedError, match="needs a process group"):
        make_train_step(get_reduced(ARCH), TrainerConfig(compress_pods=True),
                        mesh=mesh)
