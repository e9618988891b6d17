"""The port's shared-prefix admission on the CPU, against the JAX package at
f32.

Model: ``prefix_prefill`` and ``self_attention(prefix_kv=)`` within 1e-4 of
the reference's (rounding grows through the layers).  Engine: one cached
admission equals the reference's in tokens, table rows, free stack and pin
plan.  Batcher: a prefix-cache batcher emits the streams of a cache-off
batcher and of the reference's prefix batcher (at f32 the page store's cast
is the identity, so cached == cold exactly), and the pool partition of
``tests/test_prefix.py`` holds under churn.  The copied ``PrefixCache`` and
the ledger's shared-page discipline get the reference's unit tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import prefix_prefill as jax_prefix_prefill
from repro.models.attention import self_attention as jax_self_attention
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import engine as jeng
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch.configs import get_reduced
from repro_torch.models import prefix_prefill
from repro_torch.models.attention import self_attention
from repro_torch.models.transformer import _index, prefill_kv
from repro_torch.serving import (
    ContinuousBatcher, PagedKVPool, PageQuotaError, PageState, PrefixCache,
    Request, ServeConfig, ServingConfig, SlotState, make_cached_admit_step,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]


def _configs():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# model: self_attention(prefix_kv=) and prefix_prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl",
                         IMPL_PAIRS + [("naive", "naive")])
def test_self_attention_with_prefix_matches_jax(models, impl, jimpl):
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(1)
    B, S, Lp = 2, 5, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pk = rng.standard_normal((B, Lp, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    pv = rng.standard_normal((B, Lp, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    pos = (Lp + np.arange(S, dtype=np.int32))[None, :]
    lp = _index(params["blocks"][0], 0)["attn"]
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"][0])["attn"]
    y, (k, v) = self_attention(lp, _t(x), cfg, positions=_t(pos), impl=impl,
                               prefix_kv=(_t(pk), _t(pv)))
    jy, (jk, jv) = jax_self_attention(
        jlp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), impl=jimpl,
        prefix_kv=(jnp.asarray(pk), jnp.asarray(pv)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **MODEL_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **MODEL_TOL)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefix_prefill_matches_jax_and_cold(models, impl, jimpl):
    """Suffix prefill over the prefix K/V of the first 8 tokens: logits
    equal the reference's and the port's cold prefill; the suffix K/V
    equal the cold prefill's rows [Lp:]."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    B, S, Lp = 2, 13, 8
    toks = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    cold, cold_kv, _ = prefill_kv(params, _t(toks), cfg, impl=impl)
    pkv = {p: (k[:, :, :Lp], v[:, :, :Lp]) for p, (k, v) in cold_kv.items()}
    warm, ys = prefix_prefill(params, _t(toks[:, Lp:]), pkv, cfg,
                              prefix_len=Lp, impl=impl)
    jpkv = {p: (jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
            for p, (k, v) in pkv.items()}
    jwarm, jys = jax_prefix_prefill(jp, jnp.asarray(toks[:, Lp:]), jpkv, jcfg,
                                    prefix_len=Lp, impl=jimpl)
    np.testing.assert_allclose(warm.numpy(), np.asarray(jwarm), **MODEL_TOL)
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), **MODEL_TOL)
    for p, (k, v) in ys.items():
        np.testing.assert_allclose(k.numpy(), np.asarray(jys[p][0]), **MODEL_TOL)
        np.testing.assert_allclose(k.numpy(), cold_kv[p][0][:, :, Lp:].numpy(),
                                   **MODEL_TOL)
        np.testing.assert_allclose(v.numpy(), cold_kv[p][1][:, :, Lp:].numpy(),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# engine: one cached admission
# ---------------------------------------------------------------------------


def test_cached_admit_step_matches_jax(models):
    """Two real rows over 2 cached pages of 4 and a padding row: the
    cached pages are mapped read-only, the suffix gets fresh pages, the pin
    plan is clipped to [k, k + private pages]."""
    from repro.models import init_paged_caches as jax_init_paged_caches
    from repro_torch.models import init_paged_caches

    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(3)
    B, ps, P, maxp, kp = 4, 4, 12, 5, 2
    port = init_paged_caches(cfg, B, P, ps, device="cpu")
    jc = jax_init_paged_caches(jcfg, B, P, ps)
    jkv = {}
    for p, view in port.kv.items():
        k = rng.standard_normal(tuple(view.k.shape)).astype(np.float32)
        v = rng.standard_normal(tuple(view.v.shape)).astype(np.float32)
        view.k.copy_(_t(k))
        view.v.copy_(_t(v))
        jkv[p] = type(jc.kv[p])(k=jnp.asarray(k), v=jnp.asarray(v))
    jc = jc._replace(kv=jkv)
    toks = rng.integers(1, cfg.vocab, size=(4, 5)).astype(np.int32)  # suffix
    toks[2:] = toks[0]
    args = dict(slots=np.asarray([1, 3, 1, 1], np.int32),
                pos0=np.full((4,), 13, np.int32),
                budget=np.asarray([4, 6, 4, 4], np.int32),
                eos=np.full((4,), -1, np.int32),
                real=np.asarray([True, True, False, False]),
                prefix_pids=np.asarray([[7, 2], [7, 2], [7, 2], [7, 2]], np.int32),
                pin=np.asarray([3, 9, 3, 3], np.int32))
    free = np.full((P + 1,), -1, np.int32)
    rest = [i for i in range(P) if i not in (7, 2)]
    free[:len(rest)] = rest
    pages = dict(table=np.full((B, maxp), -1, np.int32), free=free,
                 free_top=np.int32(len(rest)), quota=np.int32(P),
                 pinned=np.zeros((B,), np.int32))
    state = dict(tokens=np.zeros((B,), np.int32),
                 cur_pos=np.zeros((B,), np.int32),
                 active=np.zeros((B,), bool),
                 remaining=np.zeros((B,), np.int32),
                 eos=np.full((B,), -1, np.int32))
    names = ("slots", "pos0", "budget", "eos", "real", "prefix_pids", "pin")
    st = SlotState(**{k: _t(v.copy()) for k, v in state.items()})
    nxt, port, st, pg, rows = make_cached_admit_step(
        cfg, ServeConfig(max_len=20), kp)(
        params, {"tokens": _t(toks)}, port, st,
        PageState(**{k: _t(v) for k, v in pages.items()}),
        *(_t(args[k]) for k in names))
    jnxt, jc, jst, jpg, jrows = jeng.make_cached_admit_step(
        jcfg, jeng.ServeConfig(max_len=20), kp)(
        jp, {"tokens": jnp.asarray(toks)}, jc,
        jeng.SlotState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jeng.PageState(**{k: jnp.asarray(v) for k, v in pages.items()}),
        *(jnp.asarray(args[k]) for k in names))
    for a, b in [(nxt[:2], jnxt[:2]), (rows[:2], jrows[:2]),
                 (pg.table, jpg.table), (pg.free_top, jpg.free_top),
                 (pg.pinned, jpg.pinned)] + list(zip(st, jst)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert pg.table[1, :2].tolist() == [7, 2] and pg.pinned.tolist() == [0, 3, 0, 4]
    for p, view in port.kv.items():
        for a, b in zip(view, jc.kv[p]):
            np.testing.assert_allclose(_np(a)[:, :-1], np.asarray(b)[:, :-1],
                                       rtol=1e-5, atol=1e-5)


def test_cached_admit_step_needs_a_cached_page():
    with pytest.raises(ValueError, match="zero cached pages"):
        make_cached_admit_step(_configs()[1], ServeConfig(max_len=8), 0)


# ---------------------------------------------------------------------------
# batcher: cached admission == cold prefill (tests/test_prefix.py)
# ---------------------------------------------------------------------------


BASE = dict(slots=4, prompt_len=32, max_len=64, chunk=4, paged=True,
            page_size=8)


def _port(params, cfg, **kw):
    kw = dict(BASE, **kw)
    kw.setdefault("attn_impl", "torch")
    return ContinuousBatcher(params, cfg, ServingConfig(**kw), device="cpu")


def _jax(params, cfg, **kw):
    kw = dict(BASE, **kw)
    kw.setdefault("attn_impl", "xla")
    return JaxBatcher(params, cfg, JaxServingConfig(**kw))


def _run(b, reqs, max_steps=4000):
    for r in reqs:
        b.submit(r)
    b.run(max_steps=max_steps)
    return b


def _shared_prompts(cfg, n, *, prefix_len=28, tail=4, seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab, size=prefix_len).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, cfg.vocab, size=tail)
                            .astype(np.int32)]) for _ in range(n)]


def _reqs(Req, prompts, max_new, eos_map=None):
    return [Req(rid=i, prompt=p,
                max_new=max_new(i) if callable(max_new) else max_new,
                eos=(eos_map or {}).get(i), namespace="s")
            for i, p in enumerate(prompts)]


def _assert_conservation(b):
    """free + privately mapped + cache-shared partitions the pool; a page is
    multi-mapped only if the cache owns it; ledger and tree agree."""
    tab = b.pages.table.numpy()
    free = b.pages.free[: int(b.pages.free_top)].tolist()
    mapped = tab[tab >= 0].tolist()
    shared = set(b.kv_pool.shared_ids())
    counts = {}
    for pid in mapped:
        counts[pid] = counts.get(pid, 0) + 1
    for pid, c in counts.items():
        if c > 1:
            assert pid in shared, f"page {pid} multi-mapped but not shared"
        assert pid not in free, f"page {pid} both mapped and free"
    for pid in shared:
        assert pid not in free, f"shared page {pid} on the free stack"
    assert sorted(set(mapped) | set(free) | shared) == \
        list(range(b.n_pages)), "pool partition violated"
    assert b.kv_pool.used <= b._page_limit or b.kv_pool.shared > 0
    b.kv_pool.check()
    if b.prefix is not None:
        b.prefix.check()
        assert b.prefix.n_pages == b.kv_pool.shared


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_warm_wave_matches_cold_and_jax(models, impl, jimpl):
    """Shared-prefix requests through a prefix batcher emit the streams of
    a cache-off batcher and of the reference's prefix batcher, with the
    reference's counters; later admissions really hit."""
    jp, params = models
    jcfg, cfg = _configs()
    prompts = _shared_prompts(cfg, 8, seed=1)
    max_new = lambda i: 6 + i % 3          # noqa: E731
    cold = _reqs(Request, prompts, max_new)
    _run(_port(params, cfg, attn_impl=impl), cold)
    warm = _reqs(Request, prompts, max_new)
    b = _run(_port(params, cfg, attn_impl=impl, prefix_cache=True), warm)
    want = _reqs(JaxRequest, prompts, max_new)
    jb = _run(_jax(jp, jcfg, attn_impl=jimpl, prefix_cache=True), want)
    assert [r.out for r in warm] == [r.out for r in cold]
    assert [r.out for r in warm] == [r.out for r in want]
    assert all(r.done for r in warm)
    assert b.stats.prefix_hits > 0 and b.stats.prefill_tokens_skipped > 0
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    _assert_conservation(b)


def test_cow_divergence_mid_page(models):
    """Prompts that diverge mid-page: the divergent page is never shared
    and the streams match cold."""
    _, params = models
    _, cfg = _configs()
    rng = np.random.default_rng(3)
    head = rng.integers(1, cfg.vocab, size=20).astype(np.int32)   # 2.5 pages
    prompts = [np.concatenate([head, np.full((8,), 5 + i, np.int32)])
               for i in range(6)]
    cold = _reqs(Request, prompts, 6)
    _run(_port(params, cfg), cold)
    warm = _reqs(Request, prompts, 6)
    b = _run(_port(params, cfg, prefix_cache=True), warm)
    assert [r.out for r in warm] == [r.out for r in cold]
    # prompt_len 32, prompts of 28: the divergent tokens live in padded
    # positions 24..31, so pages 0..2 are shareable and page 3 private
    assert b.prefix.n_pages <= 3
    _assert_conservation(b)


def test_identical_prompts_keep_the_last_page_private(models):
    _, params = models
    _, cfg = _configs()
    p = np.random.default_rng(5).integers(1, cfg.vocab, size=32).astype(np.int32)
    prompts = [p.copy() for _ in range(6)]
    cold = _reqs(Request, prompts, 5)
    _run(_port(params, cfg), cold)
    warm = _reqs(Request, prompts, 5)
    b = _run(_port(params, cfg, prefix_cache=True), warm)
    assert [r.out for r in warm] == [r.out for r in cold]
    assert b.prefix.n_pages <= b.prefix.max_shareable(32) == 3
    assert 0 < b.stats.prefix_tokens_saved <= (len(prompts) - 1) * 3 * 8
    _assert_conservation(b)


def test_eos_mid_chunk_with_hits(models):
    _, params = models
    _, cfg = _configs()
    prompts = _shared_prompts(cfg, 6, seed=7)
    probe = _reqs(Request, prompts, 8)
    _run(_port(params, cfg), probe)
    eos_map = {2: probe[2].out[3]}
    cold = _reqs(Request, prompts, 8, eos_map)
    _run(_port(params, cfg), cold)
    warm = _reqs(Request, prompts, 8, eos_map)
    b = _run(_port(params, cfg, prefix_cache=True), warm)
    assert [r.out for r in warm] == [r.out for r in cold]
    assert warm[2].out[-1] == eos_map[2] and len(warm[2].out) < 8
    assert b.stats.prefix_hits > 0
    _assert_conservation(b)


def test_chunk_one_matches_chunk_eight(models):
    _, params = models
    _, cfg = _configs()
    prompts = _shared_prompts(cfg, 6, seed=11)
    one = _reqs(Request, prompts, 7)
    _run(_port(params, cfg, chunk=1, prefix_cache=True), one)
    eight = _reqs(Request, prompts, 7)
    _run(_port(params, cfg, chunk=8, prefix_cache=True), eight)
    assert [r.out for r in one] == [r.out for r in eight]


def test_prefix_cache_rules():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="paged"):
        ServingConfig(slots=2, prompt_len=8, max_len=32, prefix_cache=True)
    windowed = dataclasses.replace(cfg, sliding_window=8)
    from repro_torch.models import init_params

    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        ContinuousBatcher(params, windowed, ServingConfig(
            slots=2, prompt_len=8, max_len=32, paged=True, prefix_cache=True),
            device="cpu")


# ---------------------------------------------------------------------------
# conservation with refcounted shares under churn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_admit_finish_evict_oom(models, seed):
    """Random shared-prefix traffic over a small over-subscribed pool
    (reservations off, so denied faults requeue; a lease shrink mid-run
    evicts cache pages).  The pool partition holds every few rounds."""
    _, params = models
    _, cfg = _configs()
    rng = np.random.default_rng(100 + seed)
    heads = [rng.integers(1, cfg.vocab, size=24).astype(np.int32)
             for _ in range(2)]
    prompts = [np.concatenate([heads[rng.integers(0, 2)],
                               rng.integers(1, cfg.vocab, size=4)
                               .astype(np.int32)])
               for _ in range(12)]
    b = _port(params, cfg, n_pages=12, reserve_pages=False, prefix_cache=True)
    reqs = [Request(rid=i, prompt=p, max_new=int(rng.integers(2, 9)),
                    namespace="s") for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    step = 0
    while (b.queue or any(r is not None for r in b.slot_req)) \
            and b.stats.steps < 4000:
        b.step()
        step += 1
        if step == 6:
            b.set_page_limit(8)
        if step == 12:
            b.set_page_limit(12)
        if step % 3 == 0:
            _assert_conservation(b)
        if b._stalled >= 8:
            break
    assert all(r.done for r in reqs)
    _assert_conservation(b)


def test_completion_releases_refcounts(models):
    _, params = models
    _, cfg = _configs()
    b = _run(_port(params, cfg, prefix_cache=True),
             _reqs(Request, _shared_prompts(cfg, 6, seed=13), 5))
    assert b.stats.prefix_hits > 0
    assert b.kv_pool.pinned_shared() == 0
    assert all(n.refcount == 0 for n in b.prefix._leaves())
    _assert_conservation(b)


def test_lease_shrink_evicts_unpinned_cache_entries(models):
    _, params = models
    _, cfg = _configs()
    prompts = _shared_prompts(cfg, 4, seed=17)
    b = _run(_port(params, cfg, n_pages=16, prefix_cache=True),
             _reqs(Request, prompts, 3))
    assert b.kv_pool.shared > 0
    before, shared_before = b.stats.prefix_evictions, b.kv_pool.shared
    pushes = b.page_pushes
    b.set_page_limit(2)                         # below the shared set
    assert b.stats.prefix_evictions > before
    assert b.kv_pool.shared < shared_before
    assert b.page_pushes == pushes + 1          # one push dispatch
    assert b.stats.pages_in_use + b._admitted_pages_since_sync <= 2
    _assert_conservation(b)
    b.set_page_limit(16)
    tail = [Request(rid=100 + i, prompt=p, max_new=3, namespace="s")
            for i, p in enumerate(prompts)]
    _run(b, tail)
    assert all(r.done for r in tail)
    _assert_conservation(b)


def test_requeue_resumes_from_prompt_plus_output(models):
    """Over-subscribed pool without a cache: denied faults requeue, and
    requests whose prompt+output still fit the bucket keep their tokens."""
    _, params = models
    _, cfg = _configs()
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, cfg.vocab, size=12).astype(np.int32)
               for _ in range(8)]
    reqs = _reqs(Request, prompts, 10)
    b = _run(_port(params, cfg, n_pages=16, reserve_pages=False), reqs,
             max_steps=8000)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert b.stats.oom_requeues > 0 and b.stats.oom_resumed > 0
    assert b.stats.resumed_tokens_kept > 0


def test_resume_with_prefix_cache_matches_jax(models):
    """OOM requeues under a prefix-cache batcher: the reference's tokens
    and counters, and every invariant."""
    jp, params = models
    jcfg, cfg = _configs()
    prompts = _shared_prompts(cfg, 8, prefix_len=20, tail=2, seed=23)
    kw = dict(n_pages=14, reserve_pages=False, prefix_cache=True)
    reqs = _reqs(Request, prompts, 8)
    b = _run(_port(params, cfg, **kw), reqs, max_steps=8000)
    want = _reqs(JaxRequest, prompts, 8)
    jb = _run(_jax(jp, jcfg, **kw), want, max_steps=8000)
    assert [r.out for r in reqs] == [r.out for r in want]
    assert all(r.done for r in reqs)
    assert b.stats.prefix_hits > 0 and b.stats.oom_requeues > 0
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    _assert_conservation(b)


# ---------------------------------------------------------------------------
# the copied radix tree and the ledger's shared pages
# ---------------------------------------------------------------------------


class TestPrefixCacheUnit:
    def test_lookup_insert_roundtrip(self):
        c = PrefixCache(4)
        toks = list(range(100, 112))                  # 3 full pages
        assert c.lookup("ns", toks) == []
        c.insert("ns", toks, [7, 8], start_page=0)
        assert [n.page_id for n in c.lookup("ns", toks)] == [7, 8]
        c.insert("ns", toks, [9], start_page=2)
        assert [n.page_id for n in c.lookup("ns", toks, max_pages=3)] == \
            [7, 8, 9]
        c.check()

    def test_namespace_isolation(self):
        c = PrefixCache(4)
        toks = list(range(8))
        c.insert("a", toks, [1], start_page=0)
        assert c.lookup("b", toks) == []
        assert [n.page_id for n in c.lookup("a", toks)] == [1]

    def test_last_page_never_shareable(self):
        c = PrefixCache(8)
        assert c.max_shareable(32) == 3
        assert c.max_shareable(33) == 4
        assert c.max_shareable(8) == 0
        toks = list(range(32))
        c.insert("ns", toks, [0, 1, 2], start_page=0)
        assert len(c.lookup("ns", toks)) == 3

    def test_divergent_tail_splits_path(self):
        c = PrefixCache(4)
        a = [1, 2, 3, 4, 5, 6, 7, 8, 9]
        b = [1, 2, 3, 4, 5, 6, 9, 9, 9]
        c.insert("ns", a, [0, 1], start_page=0)
        assert [n.page_id for n in c.lookup("ns", b)] == [0]
        c.insert("ns", b, [2], start_page=1)
        assert [n.page_id for n in c.lookup("ns", b)] == [0, 2]
        assert [n.page_id for n in c.lookup("ns", a)] == [0, 1]
        c.check()

    def test_refcount_pins_against_eviction(self):
        c = PrefixCache(4)
        toks = list(range(12))
        c.insert("ns", toks, [0, 1, 2], start_page=0)
        path = c.lookup("ns", toks, max_pages=3)
        c.acquire(path)
        assert c.evict(3) == []
        c.release(path)
        assert c.evict(3) == [2, 1, 0]              # leaf first
        assert c.n_pages == 0

    def test_lru_eviction_order(self):
        c = PrefixCache(4)
        c.insert("ns", [1] * 4, [0], start_page=0)
        c.insert("ns", [2] * 4, [1], start_page=0)
        c.lookup("ns", [1] * 4, max_pages=1)        # refresh the older one
        assert c.evict(1) == [1]

    def test_interior_node_not_evicted_before_child(self):
        c = PrefixCache(4)
        toks = list(range(8))
        c.insert("ns", toks, [0, 1], start_page=0)
        child = c.lookup("ns", toks, max_pages=2)[1]
        c.acquire([child])
        assert c.evict(2) == []
        c.release([child])

    def test_ghost_index_counts_recurrence(self):
        c = PrefixCache(4)
        toks = np.arange(1, 13, dtype=np.int32)
        assert c.note_seen("ns", toks) == 0
        assert c.note_seen("ns", toks) == 2         # max_shareable(12) == 2
        assert c.note_seen("other", toks) == 0


class TestLedgerShares:
    def test_share_acquire_release_drop(self):
        pool = PagedKVPool(10, 8)
        pool.alloc("r1", 4)
        pool.share("r1", "ns", [0, 1])
        assert pool.held_by("r1") == 2 and pool.shared == 2
        assert pool.used == 4
        pool.acquire([0, 1])
        with pytest.raises(PageQuotaError):
            pool.drop_shared([0])
        pool.release([0, 1])
        assert pool.drop_shared([0, 1]) == 2
        assert pool.used == 2
        pool.check()

    def test_share_more_than_held_rejected(self):
        pool = PagedKVPool(10, 8)
        pool.alloc("r1", 1)
        with pytest.raises(PageQuotaError):
            pool.share("r1", "ns", [0, 1])

    def test_double_share_rejected(self):
        pool = PagedKVPool(10, 8)
        pool.alloc("r1", 2)
        pool.share("r1", "ns", [3])
        with pytest.raises(PageQuotaError):
            pool.share("r1", "ns", [3])

    def test_release_without_users_rejected(self):
        pool = PagedKVPool(10, 8)
        pool.alloc("r1", 1)
        pool.share("r1", "ns", [0])
        with pytest.raises(PageQuotaError):
            pool.release([0])
