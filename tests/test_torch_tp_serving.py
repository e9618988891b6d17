"""Tensor-parallel serving in the port, against the JAX package's tp=1
batcher on the CPU, at f32.

Mirrors ``tests/test_sharded_serving.py``: the same ``ServingConfig(slots=3,
prompt_len=8, max_len=36, chunk=4, page_size=4)`` and requests.  The port's
``tp=2`` (and ``tp=4`` on the reduced qwen3-0.6b with ``n_kv_heads=4``)
batcher must give the reference's tp=1 tokens in every mode, with the
dispatch and host-sync counts (every ``BatcherStats`` counter) of the
port's tp=1; a live ``remesh`` 1 -> 2 -> 1, by hand and through the
hypervisor's ``exec_resize``, must not change a token; the fault guards at
tp=2 keep the reference's tokens and counters, and every shard's replica
of the slot, page and draft state stays equal to shard 0's.  Weights come
from ``repro.models.init_params`` through ``weights.params_from_jax``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro.serving.engine import generate as jax_generate
from repro_torch.configs import get_reduced
from repro_torch.core import TenantSpec
from repro_torch.distributed import sharding as tsh
from repro_torch.models import decode_step, prefill
from repro_torch.serving import (
    ContinuousBatcher, Request, ServingConfig, ServingExecutor, TensorSpec,
    TwoStageCompiler, VirtualAcceleratorPool,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")


def _configs(**kw):
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32", **kw)
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """(jax params, port params, jax cfg, port cfg) per n_kv_heads."""
    out = {}
    for hkv in (2, 4):
        jcfg, cfg = _configs(n_kv_heads=hkv)
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        out[hkv] = (jp, params_from_jax(jax.device_get(jp), device="cpu"),
                    jcfg, cfg)
    return out


def _reqs(Req, cfg, n=6, max_new=20, prefix=0):
    """test_sharded_serving.py's requests: one shared prefix, tails of 1..8
    tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, size=prefix).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(1, cfg.vocab,
                            size=1 + i % (8 - prefix)).astype(np.int32)
        out.append(Req(rid=i, prompt=np.concatenate([shared, tail]),
                       max_new=max_new))
    return out


def _sc(cls, tp=1, paged=False, spec=False, prefix=False, overlap=False,
        **kw):
    extra = {} if cls is JaxServingConfig else {"tp": tp}
    return cls(slots=3, prompt_len=8, max_len=36, chunk=4, paged=paged,
               page_size=4, n_pages=64 if paged else None,
               prefix_cache=prefix or None, speculative=spec, draft_window=4,
               overlap=overlap,
               attn_impl="xla" if cls is JaxServingConfig else "torch",
               **extra, **kw)


MODES = {
    "dense": dict(),
    "paged": dict(paged=True),
    "paged prefix": dict(paged=True, prefix=True),
    "spec dense": dict(spec=True),
    "spec paged overlap": dict(paged=True, spec=True, overlap=True),
}

_REF = {}


def _reference(models, mode, hkv=2, max_new=20, eos=None):
    """The JAX package's tp=1 tokens for ``mode`` (cached per module)."""
    key = (mode, hkv, max_new, eos)
    if key not in _REF:
        jp, _, jcfg, _ = models[hkv]
        kw = MODES[mode]
        b = JaxBatcher(jp, jcfg, _sc(JaxServingConfig, **kw))
        rs = _reqs(JaxRequest, jcfg, max_new=max_new,
                   prefix=4 if kw.get("prefix") else 0)
        if eos is not None:
            rs[0] = JaxRequest(rid=0, prompt=rs[0].prompt, max_new=max_new,
                               eos=eos)
        for r in rs:
            b.submit(r)
        b.run(max_steps=500)
        _REF[key] = [list(map(int, r.out)) for r in rs]
    return _REF[key]


def _port(models, mode, tp, hkv=2, max_new=20, **kw):
    _, params, _, cfg = models[hkv]
    mk = MODES[mode]
    b = ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=tp, **mk),
                          device="cpu", **kw)
    rs = _reqs(Request, cfg, max_new=max_new,
               prefix=4 if mk.get("prefix") else 0)
    for r in rs:
        b.submit(r)
    return b, rs


def _tokens(rs):
    return [list(r.out) for r in rs]


def _replicas_equal(b):
    """Every shard's replica of the slot, page and draft state equals shard
    0's, and every shard's cache has Hkv / tp heads."""
    for name in ("state", "pages", "draft"):
        tree = getattr(b, name)
        if tree is None:
            continue
        assert isinstance(tree, tsh.PerShard) and len(tree) == b.tp
        for rep in tree[1:]:
            for a, c in zip(tree[0], rep):
                assert torch.equal(a, c), name
    for shard in b.caches:
        for view in shard.kv.values():
            assert view.k.shape[3] == b.cfg.n_kv_heads // b.tp


CASES = [("dense", 2, 2), ("paged", 2, 2), ("paged prefix", 2, 2),
         ("spec dense", 2, 2), ("spec paged overlap", 2, 2),
         ("dense", 4, 4), ("paged", 4, 4)]


@pytest.mark.parametrize("mode,tp,hkv", CASES,
                         ids=[f"{m} tp{t}" for m, t, _ in CASES])
def test_tp_matches_reference_tp1(models, mode, tp, hkv):
    """tp=N gives the reference tp=1's tokens, with every counter of the
    port's tp=1 (one dispatch and one host sync per admission and chunk)."""
    b1, r1 = _port(models, mode, 1, hkv)
    b1.run(max_steps=500)
    bn, rn = _port(models, mode, tp, hkv)
    bn.run(max_steps=500)
    assert _tokens(rn) == _reference(models, mode, hkv)
    assert _tokens(r1) == _tokens(rn)
    assert bn.stats.as_dict() == b1.stats.as_dict()
    assert bn.stats.host_syncs <= bn.stats.dispatches
    if MODES[mode].get("spec"):
        assert bn.stats.accepted_tokens > 0
    if MODES[mode].get("overlap"):
        assert bn.stats.overlap_rounds > 0
    _replicas_equal(bn)
    if bn.paged:
        bn.kv_pool.check()
        assert int(bn.pages[0].free_top) + bn.kv_pool.shared == bn.n_pages


def test_first_decode_logits_match_reference(models):
    """The shard-local prefill and decode step at tp=2, summed by the
    policy, give the reference's single-device logits within 1e-5."""
    jp, params, jcfg, cfg = models[2]
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab, size=(3, 8)).astype(np.int32)
    jl, jc = jax_prefill(jp, jax.numpy.asarray(toks), jcfg, max_len=16,
                         impl="xla")
    nxt = np.asarray(jax.numpy.argmax(jl, axis=-1)).astype(np.int32)
    pos = np.full((3,), 8, np.int32)
    jlog, _ = jax_decode_step(jp, jax.numpy.asarray(nxt), jc,
                              jax.numpy.asarray(pos), jcfg, impl="xla")

    tp = 2
    group = tsh.ShardGroup(tsh.make_tp_mesh(tp, [CPU] * tp))
    shards = tsh.tp_shards(tsh.permute_params_for_tp(params, cfg, tp),
                           tsh.tp_param_specs(cfg), tp)
    local = tsh.tp_local_cfg(cfg, tp)

    def shard(p):
        logits, caches = prefill(p, torch.from_numpy(toks), local,
                                 max_len=16, impl="torch",
                                 policy=tsh.TP_POLICY)
        step, _ = decode_step(p, torch.from_numpy(nxt), caches,
                              torch.from_numpy(pos), local, impl="torch",
                              policy=tsh.TP_POLICY)
        return logits, step

    outs = group.run(shard, [(p,) for p in shards])
    assert torch.equal(outs[0][1], outs[1][1])
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(outs[0][1].numpy(), np.asarray(jlog),
                               atol=1e-5)


def test_generate_oracle_at_tp2(models):
    jp, params, jcfg, cfg = models[2]
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab, size=(3, 8)).astype(np.int32)
    oracle = np.asarray(jax_generate(jp, jcfg, prompts, n_new=10))
    b = ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=2),
                          device="cpu")
    rs = [Request(rid=i, prompt=prompts[i], max_new=10) for i in range(3)]
    for r in rs:
        b.submit(r)
    b.run(max_steps=500)
    assert _tokens(rs) == [list(map(int, row)) for row in oracle]


@pytest.mark.parametrize("mode", ["dense", "paged", "spec paged overlap"])
def test_live_remesh_1_2_1_is_token_identical(models, mode):
    b, rs = _port(models, mode, 1)
    b.step()
    b.step()
    b.remesh(2)
    assert b.tp == 2 and b.config.tp == 2
    _replicas_equal(b)
    b.step()
    b.step()
    b.remesh(1)
    assert b.tp == 1 and not isinstance(b.state, tsh.PerShard)
    b.run(max_steps=500)
    assert _tokens(rs) == _reference(models, mode)
    assert b.stats.remeshes == 2
    if b.paged:
        b.kv_pool.check()


def test_drafter_keeps_accepting_after_remesh(models):
    b, rs = _port(models, "spec dense", 1, max_new=24)
    b.step()
    b.step()
    b.remesh(2)
    before = b.stats.accepted_tokens
    b.run(max_steps=500)
    assert b.stats.accepted_tokens > before, \
        "drafter stopped accepting after the re-mesh"
    assert _tokens(rs) == _reference(models, "spec dense", max_new=24)


def test_eos_inside_a_chunk_across_a_remesh(models):
    probe = _reference(models, "dense")
    eos0 = probe[0][5]                 # fires inside a chunk
    ref = _reference(models, "dense", eos=eos0)
    assert len(ref[0]) < 20 and ref[0][-1] == eos0
    b, rs = _port(models, "dense", 1)
    rs[0].eos = eos0
    b.step()
    b.remesh(2)
    b.run(max_steps=500)
    assert _tokens(rs) == ref


def test_hypervisor_resize_remeshes_the_live_batcher(models):
    """``exec_resize`` 1 -> 2 -> 1 hands ``tp_mesh_for`` of the new lease
    to ``register_remesh``'s callback between chunks."""
    _, params, _, cfg = models[2]
    vpool = VirtualAcceleratorPool(devices=[CPU] * 8, devices_per_core=1)
    ex = ServingExecutor(vpool)
    ex.exec_admit(TenantSpec(name="t", requested_cores=1, artifact=None),
                  1, at=0.0)
    b, rs = _port(models, "paged", 1)
    ex.register_remesh("t", lambda mesh: b.remesh(mesh=mesh))
    b.step()
    b.step()
    ex.exec_resize("t", 2, at=1.0, mode=None)
    assert b.tp == 2 and len(b.caches) == 2
    b.step()
    b.step()
    ex.exec_resize("t", 1, at=2.0, mode=None)
    assert b.tp == 1 and b.stats.remeshes == 2
    b.run(max_steps=500)
    assert _tokens(rs) == _reference(models, "paged")
    assert sum("t_remesh" in e for e in ex.reconfig_log) == 2


def _guard_state(b, reqs):
    pg = b.pages[0] if isinstance(b.pages, tsh.PerShard) else b.pages
    top = int(np.asarray(pg.free_top))
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "stats": {k: v for k, v in b.stats.as_dict().items()},
            "quarantined": sorted(b._quarantined),
            "table": np.asarray(pg.table).tolist(),
            "free": np.asarray(pg.free)[:top].tolist()}


def test_fault_guards_at_tp2_match_reference(models):
    """audit=True with one out-of-range page id injected: the port's tp=2
    batcher keeps the reference tp=1's tokens, counters, quarantine and
    tables, and the corruption, the audit's repairs and the slot releases
    reach every shard's replica."""
    jp, params, jcfg, cfg = models[2]
    kw = dict(paged=True, audit=True)
    j = JaxBatcher(jp, jcfg, _sc(JaxServingConfig, **kw))
    t = ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=2, **kw),
                          device="cpu")
    jr, tr = _reqs(JaxRequest, jcfg), _reqs(Request, cfg)
    for a, c in zip(jr, tr):
        j.submit(a)
        t.submit(c)
    for _ in range(2):
        j.step()
        t.step()
        _replicas_equal(t)
    slot = next(i for i, r in enumerate(t.slot_req) if r is not None)
    j.inject_kv_corruption(slot)
    t.inject_kv_corruption(slot)
    _replicas_equal(t)
    while j.queue or any(r is not None for r in j.slot_req):
        j.step()
        t.step()
        _replicas_equal(t)
    t.run(max_steps=500)
    assert t.stats.audit_repairs > 0
    got, want = _guard_state(t, tr), _guard_state(j, jr)
    want["stats"]["remeshes"] = 0
    want["stats"].update(dict.fromkeys(PORT_STATS_FIELDS, 0))
    assert got == want


def test_reconfigure_places_state_by_specs():
    """``reconfigure(state_specs=...)`` checks each spec against the
    lease's ("data", "model") width, as a NamedSharding would, and places
    the tree on the lease's device."""
    pool = VirtualAcceleratorPool(devices=[CPU] * 4, devices_per_core=1)
    comp = TwoStageCompiler(pool)
    comp.static_compile("k", lambda x: x, (TensorSpec((2,), torch.float32),),
                        lease_sizes=[2, 3])
    pool.lease("t", 1)
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    specs = {"a": tsh.P("data", None), "b": tsh.P()}
    _, moved, timing = comp.reconfigure("t", "k", 2, live_state=state,
                                        state_specs=specs)
    assert moved["a"].device == CPU and torch.equal(moved["a"], state["a"])
    assert "t_migrate" in timing
    with pytest.raises(ValueError, match="does not divide"):
        comp.reconfigure("t", "k", 3, live_state=state, state_specs=specs)
    with pytest.raises(ValueError, match="names axis 'tp'"):
        comp.reconfigure("t", "k", 2, live_state=state,
                         state_specs={"a": tsh.P("tp"), "b": tsh.P()})


REFUSED = ["deepseek-moe-16b", "mamba2-370m", "jamba-1.5-large-398b",
           "qwen2-vl-72b", "whisper-base"]


@pytest.mark.parametrize("arch", REFUSED)
def test_tp_refuses_what_the_reference_refuses(arch):
    cfg = get_reduced(arch)
    with pytest.raises(ValueError,
                       match=f"tp=2 unsupported for {cfg.name}"):
        ContinuousBatcher({}, cfg, ServingConfig(
            slots=2, prompt_len=8, max_len=16, tp=2), device="cpu")


def test_tp_refuses_a_custom_policy_and_distinct_devices(models):
    _, params, _, cfg = models[2]
    with pytest.raises(ValueError, match="custom activation policies"):
        ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=2),
                          device="cpu", policy=lambda x, name: x)
    with pytest.raises(ValueError, match="Queue 1 item 18 part b"):
        ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=2), device="cpu",
                          mesh=tsh.make_tp_mesh(2, [CPU, torch.device("meta")]))
    with pytest.raises(ValueError, match="mesh is tp=3 wide"):
        ContinuousBatcher(params, cfg, _sc(ServingConfig, tp=2), device="cpu",
                          mesh=tsh.make_tp_mesh(3, [CPU] * 3))
    b, _ = _port(models, "dense", 1)
    with pytest.raises(ValueError, match="needs a tp width or a mesh"):
        b.remesh()
    with pytest.raises(ValueError, match="conflicts with the mesh width"):
        b.remesh(2, mesh=tsh.make_tp_mesh(4, [CPU] * 4))
    with pytest.raises(ValueError, match="must divide n_kv_heads=2"):
        b.remesh(4)
    assert b.tp == 1 and b.stats.remeshes == 0
