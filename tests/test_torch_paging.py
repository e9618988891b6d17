"""The port's paged KV pool on the CPU, against the JAX package at f32.

Model: ``decode_step(page_table=)`` logits within 1e-4 of the reference's
(rounding grows through the layers).  Engine: one paged decode chunk and one
paged admission equal the reference's exactly in tokens, table, free stack,
``free_top`` and counters; the pool contents agree within 1e-5 outside the
trash page, which duplicate writes may leave in either order.  Batcher: the
paged streams equal the reference's paged streams and the port's dense
streams, and the page-pool invariants of ``tests/test_paging.py`` hold.
Weights come from ``repro.models.init_params`` through
``weights.params_from_jax``; inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import init_paged_caches as jax_init_paged_caches
from repro.models import init_params as jax_init_params
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch.configs import get_reduced
from repro_torch.models import decode_step, init_paged_caches
from repro_torch.models.attention import ATTN_CAPABILITIES, check_attn_impl
from repro_torch.serving import (
    ContinuousBatcher, PagedKVPool, PageQuotaError, PageState, Request,
    ServeConfig, ServingConfig, SlotState, make_paged_admit_step,
    make_paged_decode_chunk, make_page_push, page_bytes,
    paged_kv_cache_bytes, pages_for,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.serving.engine import _free_finished_pages
from repro_torch.weights import params_from_jax

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
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


def _fill_pools(rng, cfg, n_pages, ps):
    """Matching paged caches for both packages, filled with the same random
    K/V (one attention position per period in the reduced qwen3)."""
    port = init_paged_caches(cfg, 1, n_pages, ps, device="cpu")
    jax_c = jax_init_paged_caches(cfg, 1, n_pages, ps)
    kv = {}
    for p, view in port.kv.items():
        k = rng.standard_normal(tuple(view.k.shape)).astype(np.float32)
        v = rng.standard_normal(tuple(view.v.shape)).astype(np.float32)
        view.k.copy_(_t(k))
        view.v.copy_(_t(v))
        kv[p] = type(jax_c.kv[p])(k=jnp.asarray(k), v=jnp.asarray(v))
    return port, jax_c._replace(kv=kv)


def _assert_pools_equal(port, jax_c, **tol):
    """Pools agree outside the trash page (the last page), which duplicate
    writes may leave in either order."""
    for p, view in port.kv.items():
        for a, b in zip(view, jax_c.kv[p]):
            np.testing.assert_allclose(_np(a)[:, :-1], np.asarray(b)[:, :-1],
                                       **tol)


# ---------------------------------------------------------------------------
# model: decode_step(page_table=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_paged_decode_step_matches_jax(models, impl, jimpl):
    """A shuffled table with holes and an unmapped slot; the new tokens'
    K/V land at the same pool rows and the logits agree."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(1)
    ps, P = 4, 12
    port, jc = _fill_pools(rng, cfg, P, ps)
    table = np.asarray([[3, 7, 1, -1], [0, -1, 5, 9], [-1, -1, -1, -1]],
                       np.int32)
    cur = np.asarray([9, 10, 2], np.int32)
    toks = rng.integers(1, cfg.vocab, size=3).astype(np.int32)
    logits, port = decode_step(params, _t(toks), port, _t(cur), cfg,
                               impl=impl, page_table=_t(table))
    jlogits, jc = jax_decode_step(jp, jnp.asarray(toks), jc, jnp.asarray(cur),
                                  jcfg, impl=jimpl,
                                  page_table=jnp.asarray(table))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    _assert_pools_equal(port, jc, **POOL_TOL)


def test_paged_write_past_the_table_lands_on_trash():
    """A slot stopped at ``cur_pos == max_len`` with ``max_len % page_size
    == 0`` indexes one past its table: the write goes to the trash page,
    where JAX's gather fill sends it, instead of raising."""
    from repro_torch.models.attention import paged_write_target

    table = torch.tensor([[2, 0], [1, -1]], dtype=torch.int32)
    dest, off = paged_write_target(table, torch.tensor([8, 5], dtype=torch.int32),
                                   4, 3)
    assert dest.tolist() == [3, 3] and off.tolist() == [0, 1]
    dest, off = paged_write_target(table, torch.tensor([7, 2], dtype=torch.int32),
                                   4, 3)
    assert dest.tolist() == [0, 1] and off.tolist() == [3, 2]


# ---------------------------------------------------------------------------
# engine: one paged chunk, one paged admission, the free-stack helpers
# ---------------------------------------------------------------------------


def _chunk_case(rng, cfg):
    """4 slots, page size 4, 12 pages, 4 pages a slot (max_len 16), a
    lease of 5 pages with 5 allocated: at step 1 slots 1 and 3 both cross
    into an unmapped page and are denied, and their private pages go back
    on the stack (slot 3's pinned first page, owned by the prefix cache,
    stays off it); at step 2 slot 0 crosses and is granted a freed page;
    slot 2 is stopped at cur_pos == max_len with an empty row."""
    B, maxp = 4, 4
    table = np.full((B, maxp), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, 0] = 1
    table[3, :2] = [0, 5]
    used = {3, 7, 1, 0, 5}
    free = np.full((13,), -1, np.int32)
    rest = [i for i in range(12) if i not in used]
    free[:len(rest)] = rest
    pages = dict(table=table, free=free, free_top=np.int32(len(rest)),
                 quota=np.int32(5), pinned=np.asarray([0, 0, 0, 1], np.int32))
    state = dict(tokens=rng.integers(1, cfg.vocab, size=B).astype(np.int32),
                 cur_pos=np.asarray([6, 3, 16, 7], np.int32),
                 active=np.asarray([True, True, False, True]),
                 remaining=np.asarray([5, 2, 0, 6], np.int32),
                 eos=np.full((B,), -1, np.int32))
    return pages, state


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_paged_decode_chunk_matches_jax(models, impl, jimpl):
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    pages, state = _chunk_case(rng, cfg)
    port, jc = _fill_pools(rng, cfg, 12, 4)
    scfg = ServeConfig(max_len=16, attn_impl=impl)
    out = make_paged_decode_chunk(cfg, scfg, 4, 4)(
        params, port, SlotState(**{k: _t(v) for k, v in state.items()}),
        PageState(**{k: _t(v) for k, v in pages.items()}))
    jscfg = jeng.ServeConfig(max_len=16, attn_impl=jimpl)
    jout = jeng.make_paged_decode_chunk(jcfg, jscfg, 4, 4)(
        jp, jc, jeng.SlotState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jeng.PageState(**{k: jnp.asarray(v) for k, v in pages.items()}),
        jax.random.PRNGKey(0))
    port, st, pg, toks, emitted, poisoned, ctr = out
    jc, jst, jpg, jtoks, jemitted, jpoisoned, jctr = jout
    for a, b in [(toks, jtoks), (emitted, jemitted), (poisoned, jpoisoned),
                 (ctr, jctr), (pg.table, jpg.table), (pg.free_top, jpg.free_top),
                 (pg.pinned, jpg.pinned)] + list(zip(st, jst)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    top = int(pg.free_top)
    np.testing.assert_array_equal(_np(pg.free)[:top], np.asarray(jpg.free)[:top])
    # the case does what it says: one grant, two pushes, two denials
    assert _np(ctr).tolist() == [1, 2, 2, 0]
    assert st.active.tolist() == [True, False, False, False]
    _assert_pools_equal(port, jc, **POOL_TOL)


def test_paged_admit_step_matches_jax(models):
    """A bucket of 4 with one padding row (duplicating row 0), a row with a
    budget of 1 (never activates, maps nothing) and a quota that denies the
    last asking row."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(3)
    B, ps, P, maxp = 4, 4, 10, 4
    port, jc = _fill_pools(rng, cfg, P, ps)
    toks = rng.integers(1, cfg.vocab, size=(4, 6)).astype(np.int32)
    toks[3] = toks[0]
    args = dict(slots=np.asarray([2, 0, 3, 2], np.int32),
                pos0=np.full((4,), 6, np.int32),
                budget=np.asarray([5, 1, 4, 5], np.int32),
                eos=np.full((4,), -1, np.int32),
                real=np.asarray([True, True, True, False]),
                pin=np.asarray([1, 0, 0, 1], np.int32))
    free = np.full((P + 1,), -1, np.int32)
    free[:P] = np.arange(P)
    pages = dict(table=np.full((B, maxp), -1, np.int32), free=free,
                 free_top=np.int32(P), quota=np.int32(3),
                 pinned=np.zeros((B,), np.int32))
    state = dict(tokens=np.zeros((B,), np.int32),
                 cur_pos=np.zeros((B,), np.int32),
                 active=np.zeros((B,), bool),
                 remaining=np.zeros((B,), np.int32),
                 eos=np.full((B,), -1, np.int32))
    st = SlotState(**{k: _t(v.copy()) for k, v in state.items()})
    nxt, port, st, pg, rows = make_paged_admit_step(cfg, ServeConfig(max_len=16))(
        params, {"tokens": _t(toks)}, port, st,
        PageState(**{k: _t(v) for k, v in pages.items()}),
        *(_t(args[k]) for k in ("slots", "pos0", "budget", "eos", "real",
                                "pin")))
    jnxt, jc, jst, jpg, jrows = jeng.make_paged_admit_step(
        jcfg, jeng.ServeConfig(max_len=16))(
        jp, {"tokens": jnp.asarray(toks)}, jc,
        jeng.SlotState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jeng.PageState(**{k: jnp.asarray(v) for k, v in pages.items()}),
        *(jnp.asarray(args[k]) for k in ("slots", "pos0", "budget", "eos",
                                         "real", "pin")))
    for a, b in [(nxt[:3], jnxt[:3]), (rows[:3], jrows[:3]),
                 (pg.table, jpg.table), (pg.free_top, jpg.free_top),
                 (pg.pinned, jpg.pinned)] + list(zip(st, jst)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # row 0 got 2 pages (slot 2), row 1 activates nothing, row 2 is denied
    assert int(pg.free_top) == P - 2
    assert st.active.tolist() == [False, False, True, False]
    _assert_pools_equal(port, jc, **POOL_TOL)


def test_free_finished_pages_and_page_push_match_jax():
    """Masked pushes land on the scratch element; pinned leading pages stay
    off the stack; padding pids (< 0) are no-ops."""
    table = np.asarray([[4, 2, -1], [0, 6, 5], [1, -1, -1]], np.int32)
    free = np.asarray([3, 7, -1, -1, -1, -1, -1, -1, -1], np.int32)
    finished = np.asarray([True, True, False])
    pinned = np.asarray([0, 1, 0], np.int32)
    got = _free_finished_pages(_t(table), _t(free), _t(np.int32(2)),
                               _t(finished), _t(pinned))
    want = jeng._free_finished_pages(
        jnp.asarray(table), jnp.asarray(free), jnp.int32(2),
        jnp.asarray(finished), jnp.asarray(pinned))
    top = int(got[2])
    assert top == 6 == int(want[2])
    np.testing.assert_array_equal(_np(got[1])[:top], np.asarray(want[1])[:top])
    for a, b in ((got[0], want[0]), (got[3], want[3])):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    pages = dict(table=table, free=_np(got[1]), free_top=np.int32(top),
                 quota=np.int32(8), pinned=pinned)
    pids = np.asarray([0, -1, 3, -1], np.int32)
    pushed = make_page_push()(PageState(**{k: _t(v) for k, v in pages.items()}),
                              _t(pids))
    jpushed = jeng.make_page_push()(
        jeng.PageState(**{k: jnp.asarray(v) for k, v in pages.items()}),
        jnp.asarray(pids))
    assert int(pushed.free_top) == int(jpushed.free_top) == top + 2
    np.testing.assert_array_equal(_np(pushed.free)[:top + 2],
                                  np.asarray(jpushed.free)[:top + 2])


# ---------------------------------------------------------------------------
# batcher: token identity and pool invariants (tests/test_paging.py)
# ---------------------------------------------------------------------------


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=1 + i % 6).astype(np.int32)
            for i in range(n)]


def _run(make, Req, params, cfg, prompts, *, eos_map=None, max_new=10,
         chunk=8, **kw):
    b = make(params, cfg, slots=4, prompt_len=8, max_len=64, chunk=chunk, **kw)
    reqs = [Req(rid=i, prompt=p, max_new=max_new + i % 4,
                eos=(eos_map or {}).get(i))
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.run(max_steps=4000)
    return b, reqs


def _port(params, cfg, **kw):
    kw.setdefault("attn_impl", "torch")
    return ContinuousBatcher(params, cfg, ServingConfig(**kw), device="cpu")


def _jax(params, cfg, **kw):
    kw.setdefault("attn_impl", "xla")
    return JaxBatcher(params, cfg, JaxServingConfig(**kw))


def _assert_pool_invariants(b):
    """No page mapped twice, mapped + free partitions the pool, the ledger
    stays under the lease cap and balances."""
    tab = b.pages.table.numpy()
    top = int(b.pages.free_top)
    mapped = tab[tab >= 0].tolist()
    assert len(mapped) == len(set(mapped)), "page mapped to two slots"
    assert sorted(set(mapped) | set(b.pages.free[:top].tolist())) == \
        list(range(b.n_pages)), "free-list conservation violated"
    assert b.kv_pool.used <= b._page_limit
    b.kv_pool.check()


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_paged_batcher_matches_jax_and_dense(models, impl, jimpl):
    jp, params = models
    jcfg, cfg = _configs()
    prompts = _prompts(cfg, 8)
    _, want = _run(_jax, JaxRequest, jp, jcfg, prompts, paged=True,
                   page_size=8, attn_impl=jimpl)
    _, dense = _run(_port, Request, params, cfg, prompts, attn_impl=impl)
    b, got = _run(_port, Request, params, cfg, prompts, paged=True,
                  page_size=8, attn_impl=impl)
    assert [r.out for r in got] == [r.out for r in want]
    assert [r.out for r in got] == [r.out for r in dense]
    assert all(r.done for r in got)
    assert int(b.pages.free_top) == b.n_pages       # every page came back
    _assert_pool_invariants(b)


def test_page_boundary_crossing_matches_jax(models):
    """page_size=4: the prompt bucket is 2 pages and decode crosses into
    pages 2..5."""
    jp, params = models
    jcfg, cfg = _configs()
    prompts = _prompts(cfg, 6, seed=5)
    jb, want = _run(_jax, JaxRequest, jp, jcfg, prompts, max_new=14,
                    paged=True, page_size=4)
    b, got = _run(_port, Request, params, cfg, prompts, max_new=14,
                  paged=True, page_size=4)
    assert [r.out for r in got] == [r.out for r in want]
    assert b.stats.peak_pages_in_use == jb.stats.peak_pages_in_use > \
        pages_for(8, 4)
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    _assert_pool_invariants(b)


def test_eos_mid_chunk_frees_pages(models):
    _, params = models
    _, cfg = _configs()
    prompts = _prompts(cfg, 6, seed=7)
    _, probe = _run(_port, Request, params, cfg, prompts)
    eos_map = {0: probe[0].out[3]}
    _, dense = _run(_port, Request, params, cfg, prompts, eos_map=eos_map)
    b, paged = _run(_port, Request, params, cfg, prompts, eos_map=eos_map,
                    paged=True, page_size=8)
    assert [r.out for r in paged] == [r.out for r in dense]
    assert paged[0].out[-1] == eos_map[0] and len(paged[0].out) < 10
    assert int(b.pages.free_top) == b.n_pages
    _assert_pool_invariants(b)


def test_chunk_one_matches_chunk_eight(models):
    _, params = models
    _, cfg = _configs()
    prompts = _prompts(cfg, 6, seed=11)
    _, one = _run(_port, Request, params, cfg, prompts, chunk=1, paged=True,
                  page_size=8)
    _, eight = _run(_port, Request, params, cfg, prompts, chunk=8, paged=True,
                    page_size=8)
    assert [r.out for r in one] == [r.out for r in eight]


def test_slot_stopping_at_max_len_runs(models):
    """max_len % page_size == 0 and a request whose last decode write is
    position max_len - 1: its slot stops at cur_pos == max_len and keeps
    stepping (frozen) beside a longer one — same tokens as the reference."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab, size=8).astype(np.int32)
               for _ in range(2)]

    def run(make, Req, p, c):
        # request 1 ends early; request 2 takes its slot and is still
        # decoding when request 0's slot stops at position 16
        b = make(p, c, slots=2, prompt_len=8, max_len=16, chunk=8,
                 paged=True, page_size=4, n_pages=10)
        reqs = [Req(rid=0, prompt=prompts[0], max_new=9),
                Req(rid=1, prompt=prompts[1], max_new=2),
                Req(rid=2, prompt=prompts[1][::-1].copy(), max_new=9)]
        for r in reqs:
            b.submit(r)
        b.run()
        return b, reqs

    b, got = run(_port, Request, params, cfg)
    _, want = run(_jax, JaxRequest, jp, jcfg)
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [9, 2, 9]
    assert int(b.state.cur_pos[0]) == 16
    _assert_pool_invariants(b)


def test_conservation_across_churn(models):
    _, params = models
    _, cfg = _configs()
    b, reqs = _run(_port, Request, params, cfg, _prompts(cfg, 10, seed=13),
                   paged=True, page_size=8, n_pages=6)
    assert all(r.done for r in reqs)
    assert b.stats.peak_pages_in_use <= 6
    _assert_pool_invariants(b)


def test_quota_oversubscription_matches_jax(models):
    """A lease below the pool with reservations off: denied faults requeue
    (keeping their tokens where they fit) and everything completes, with
    the reference's counters."""
    jp, params = models
    jcfg, cfg = _configs()
    prompts = _prompts(cfg, 8, seed=17)
    kw = dict(paged=True, page_size=8, n_pages=16, page_quota=5,
              reserve_pages=False)
    jb, want = _run(_jax, JaxRequest, jp, jcfg, prompts, **kw)
    b, got = _run(_port, Request, params, cfg, prompts, **kw)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert b.stats.peak_pages_in_use <= 5
    assert b.stats.oom_requeues > 0 and b.stats.oom_resumed > 0
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    _assert_pool_invariants(b)


def test_page_limit_resize_cycle(models):
    """Shrinking the lease mid-run throttles allocation (drain, no
    revocation); growing it back restores throughput."""
    _, params = models
    _, cfg = _configs()
    b = _port(params, cfg, slots=4, prompt_len=8, max_len=64, chunk=4,
              paged=True, page_size=8, n_pages=16, reserve_pages=False)
    reqs = [Request(rid=i, prompt=p, max_new=10)
            for i, p in enumerate(_prompts(cfg, 8, seed=19))]
    for r in reqs:
        b.submit(r)
    b.step()
    b.set_page_limit(4)
    for _ in range(4):
        b.step()
        _assert_pool_invariants(b)
    assert int(b.pages.quota) == 4
    b.set_page_limit(16)
    b.run(max_steps=4000)
    assert all(r.done for r in reqs)
    _assert_pool_invariants(b)


def test_admit_only_rounds_do_not_starve_admission(models):
    """Requests that finish at admission pop no device pages; the since-sync
    estimate must not leak and starve an entirely free pool."""
    _, params = models
    _, cfg = _configs()
    b = _port(params, cfg, slots=4, prompt_len=8, max_len=64, chunk=4,
              paged=True, page_size=8, n_pages=4, reserve_pages=False)
    reqs = [Request(rid=i, prompt=p, max_new=1)
            for i, p in enumerate(_prompts(cfg, 12, seed=31))]
    for r in reqs:
        b.submit(r)
    b.run(max_steps=2000)
    assert all(r.done for r in reqs)
    assert b._admitted_pages_since_sync == 0
    _assert_pool_invariants(b)


def test_submit_rejects_impossible_footprint(models):
    _, params = models
    _, cfg = _configs()
    b = _port(params, cfg, slots=2, prompt_len=8, max_len=64, chunk=4,
              paged=True, page_size=8, n_pages=2)
    with pytest.raises(ValueError, match="pages"):
        b.submit(Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                         max_new=40))


def test_paged_stats_contract(models):
    """One dispatch and one host sync per admission and per chunk on the
    paged path too (the fetch carries active, free_top and the counters)."""
    _, params = models
    _, cfg = _configs()
    b, reqs = _run(_port, Request, params, cfg, _prompts(cfg, 8), paged=True,
                   page_size=4)
    s = b.stats
    assert s.dispatches == s.host_syncs == s.prefills + s.chunks
    assert s.device_pages_popped > 0
    assert s.device_pages_pushed == s.device_pages_popped + \
        8 * pages_for(8, 4)            # prompt pages come back too
    assert s.cache_bytes == sum(t.numel() * t.element_size()
                                for t in b.caches.kv["0"])


# ---------------------------------------------------------------------------
# capability table and the ledger's byte accounting
# ---------------------------------------------------------------------------


def test_paged_rejects_naive_at_construction():
    with pytest.raises(ValueError, match="paged"):
        ServingConfig(slots=2, prompt_len=8, max_len=32, paged=True,
                      attn_impl="naive")


def test_capability_table_covers_every_mode():
    from repro.models.attention import ATTN_CAPABILITIES as JAX_CAPS

    names = {"cuda": "pallas", "torch": "xla", "naive": "naive",
             "flash": "flash"}
    for mode, impls in ATTN_CAPABILITIES.items():
        for impl in impls:
            assert check_attn_impl(impl, mode) == impl
        want = {i for i in JAX_CAPS[mode] if i in names.values()}
        if mode == "train":
            # a deliberate difference (ROADMAP.md Queue 3): the reference's
            # "pallas" cannot be differentiated, so the port refuses "cuda"
            want.discard("pallas")
        assert {names[i] for i in impls} == want, mode
    with pytest.raises(ValueError, match="unknown attention mode"):
        check_attn_impl("torch", "teleport")


def test_page_bytes_match_jax():
    jcfg, cfg = _configs()
    for c, jc in ((cfg, jcfg), (dataclasses.replace(cfg, dtype="bfloat16"),
                                dataclasses.replace(jcfg, dtype="bfloat16"))):
        assert page_bytes(c, 16) == jkv.page_bytes(jc, 16)
        assert paged_kv_cache_bytes(c, 40, 8) == jkv.paged_kv_cache_bytes(jc, 40, 8)
        assert PagedKVPool(40, 8).pool_bytes(c) == \
            jkv.PagedKVPool(40, 8).pool_bytes(jc)


class TestLedger:
    """The copied PagedKVPool: counts, quotas, conservation errors."""

    def test_alloc_free_quota(self):
        pool = PagedKVPool(10, 16)
        pool.set_quota("a", 6)
        assert pool.alloc("a", 4) == 4
        assert pool.alloc("b", 5) == 5
        assert pool.available == 1
        with pytest.raises(PageQuotaError):
            pool.alloc("a", 3)                   # quota (4+3 > 6)
        with pytest.raises(PageQuotaError):
            pool.alloc("b", 2)                   # pool (9+2 > 10)
        assert pool.free("a", 2) == 2
        assert pool.held_by("a") == 2
        assert pool.free("b") == 5               # free-all
        assert pool.available == 8
        pool.check()

    def test_oversubscribed_quotas_are_legal(self):
        pool = PagedKVPool(10, 16)
        pool.set_quota("a", 8)
        pool.set_quota("b", 8)
        pool.alloc("a", 6)
        with pytest.raises(PageQuotaError):
            pool.alloc("b", 5)
        pool.alloc("b", 4)
        pool.check()

    def test_pages_for(self):
        assert [pages_for(n, 4) for n in (0, 1, 4, 5, 8)] == [0, 1, 1, 2, 2]
        assert pages_for(-3, 4) == 0
