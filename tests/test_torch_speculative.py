"""The port's speculative decode and admission/decode overlap on the CPU,
against the JAX package at f32 (reduced qwen3-0.6b).

Acceptance algebra and drafter: every output equals the reference's
exactly.  ``verify_step`` and the paged verify attention: logits within
1e-4 of the reference's (rounding grows through the layers), the verify
attention's plain version within the reference kernel tests' 2e-4 of the
Pallas kernel in interpret mode.  One dense and one paged spec chunk equal
the reference's exactly in tokens, emitted masks, slot state, draft state,
table, free stack and counters; pools agree within 1e-5 outside the trash
page, which duplicate writes may leave in either order.  Batcher: tokens
and every ``BatcherStats`` counter equal the reference's, and speculative
tokens equal plain greedy decode.  Weights come from
``repro.models.init_params`` through ``weights.params_from_jax``; inputs
are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention import ref as jpa_ref
from repro.models import init_caches as jax_init_caches
from repro.models import init_paged_caches as jax_init_paged_caches
from repro.models import init_params as jax_init_params
from repro.models.transformer import verify_step as jax_verify_step
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import engine as jeng
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch.configs import get_reduced
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import init_caches, init_paged_caches, verify_step
from repro_torch.serving import (
    ContinuousBatcher, DraftState, PageState, Request, ServeConfig,
    ServingConfig, SlotState, init_draft_state, make_paged_spec_decode_chunk,
    make_spec_decode_chunk,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.serving.engine import (
    _advance_draft, _propose_drafts, _spec_accept,
)
from repro_torch.weights import params_from_jax

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PAGED_TOL = dict(rtol=2e-4, atol=2e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]


def _configs(**kw):
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32", **kw)
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states(d, port_cls, jax_cls):
    """The same numpy fields as a port and a reference NamedTuple."""
    return (port_cls(**{k: _t(v) for k, v in d.items()}),
            jax_cls(**{k: jnp.asarray(v) for k, v in d.items()}))


def _assert_same(pairs):
    for a, b in pairs:
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# acceptance algebra (tests/test_speculative.py TestSpecAccept)
# ---------------------------------------------------------------------------


# q_toks, g, remaining, eos, active -> expected (c, nxt, done)
ACCEPT_CASES = {
    "full accept": ([7, 3, 4, 5], [3, 4, 5, 6], 10, -1, True, (4, 6, False)),
    "first mismatch": ([7, 3, 9, 5], [3, 4, 5, 6], 10, -1, True, (2, 4, False)),
    "full reject": ([7, 9, 9, 9], [3, 4, 5, 6], 10, -1, True, (1, 3, False)),
    "eos inside prefix": ([7, 3, 4, 5], [3, 2, 5, 6], 10, 2, True, (2, 2, True)),
    "eos beyond prefix": ([7, 3, 9, 9], [3, 4, 2, 2], 10, 2, True, (2, 4, False)),
    "budget clamp": ([7, 3, 4, 5], [3, 4, 5, 6], 2, -1, True, (2, 4, True)),
    "inactive slot": ([7, 3, 4, 5], [3, 4, 5, 6], 10, -1, False, (0, 7, False)),
    # EOS twice in the accepted prefix: argmax must take the FIRST maximum
    # (jnp.argmax and torch.argmax both do), else c would be 3
    "eos twice, argmax tie": ([7, 3, 2, 2], [3, 2, 2, 6], 10, 2, True,
                              (2, 2, True)),
}


@pytest.mark.parametrize("case", list(ACCEPT_CASES))
def test_spec_accept_matches_jax(case):
    q, g, rem, eos, act, (c_want, nxt_want, done_want) = ACCEPT_CASES[case]
    st = dict(tokens=np.asarray([7], np.int32), cur_pos=np.zeros(1, np.int32),
              active=np.asarray([act]), remaining=np.asarray([rem], np.int32),
              eos=np.asarray([eos], np.int32))
    pst, jst = _states(st, SlotState, jeng.SlotState)
    q, g = np.asarray([q], np.int32), np.asarray([g], np.int32)
    got = _spec_accept(_t(q), _t(g), pst, pst.active)
    want = jeng._spec_accept(jnp.asarray(q), jnp.asarray(g), jst, jst.active)
    _assert_same(zip(got, want))
    c, nxt, done, emitted = got
    assert (int(c[0]), int(nxt[0]), bool(done[0])) == (c_want, nxt_want,
                                                       done_want)
    assert emitted[0].tolist() == [w < c_want for w in range(4)]
    assert c.dtype == torch.int32 and nxt.dtype == torch.int32


def test_spec_accept_batch_matches_jax():
    """All cases as the rows of one batch, and random windows: the
    acceptance is per slot."""
    rows = list(ACCEPT_CASES.values())
    rng = np.random.default_rng(4)
    q = np.asarray([r[0] for r in rows] + rng.integers(0, 4, (8, 4)).tolist(),
                   np.int32)
    g = np.asarray([r[1] for r in rows] + rng.integers(0, 4, (8, 4)).tolist(),
                   np.int32)
    B = q.shape[0]
    st = dict(tokens=q[:, 0].copy(), cur_pos=np.zeros(B, np.int32),
              active=np.asarray([r[4] for r in rows] + [True] * 8),
              remaining=np.asarray([r[2] for r in rows]
                                   + rng.integers(1, 6, 8).tolist(), np.int32),
              eos=np.asarray([r[3] for r in rows]
                             + rng.integers(-1, 4, 8).tolist(), np.int32))
    pst, jst = _states(st, SlotState, jeng.SlotState)
    _assert_same(zip(_spec_accept(_t(q), _t(g), pst, pst.active),
                     jeng._spec_accept(jnp.asarray(q), jnp.asarray(g), jst,
                                       jst.active)))


# ---------------------------------------------------------------------------
# drafter (tests/test_speculative.py TestDrafter)
# ---------------------------------------------------------------------------


def _drafts(hist_len, toks, c):
    """Advance a fresh history by ``toks``/``c`` in both packages."""
    toks, c = np.asarray(toks, np.int32), np.asarray(c, np.int32)
    B = toks.shape[0]
    d = init_draft_state(B, hist_len, device="cpu")
    jd = jeng.init_draft_state(B, hist_len)
    return (_advance_draft(d, _t(toks), _t(c)),
            jeng._advance_draft(jd, jnp.asarray(toks), jnp.asarray(c)))


def test_drafter_proposes_repeated_ngram_continuation():
    d, jd = _drafts(16, [[1, 2, 5, 6, 9, 5, 6]], [7])
    got = _propose_drafts(d, _t([6]), n_draft=3, ngram=2)
    want = jeng._propose_drafts(jd, jnp.asarray([6], jnp.int32), n_draft=3,
                                ngram=2)
    _assert_same([(got, want), (d.hist, jd.hist), (d.n, jd.n)])
    assert int(got[0, 0]) == 9


def test_drafter_without_match_repeats_the_last_token():
    d, jd = _drafts(16, [[1, 2, 3, 4]], [4])
    got = _propose_drafts(d, _t([4]), n_draft=3, ngram=2)
    want = jeng._propose_drafts(jd, jnp.asarray([4], jnp.int32), n_draft=3,
                                ngram=2)
    _assert_same([(got, want)])
    assert got[0].tolist() == [4, 4, 4]


def test_drafter_history_is_a_shift_register():
    d, jd = _drafts(4, [[1, 2, 3, 0]], [3])
    _assert_same([(d.hist, jd.hist), (d.n, jd.n)])
    assert d.hist[0].tolist() == [-1, 1, 2, 3] and int(d.n[0]) == 3
    d2 = _advance_draft(d, _t([[7, 8, 0, 0]]), _t([2]))
    jd2 = jeng._advance_draft(jd, jnp.asarray([[7, 8, 0, 0]], jnp.int32),
                              jnp.asarray([2], jnp.int32))
    _assert_same([(d2.hist, jd2.hist), (d2.n, jd2.n)])
    assert d2.hist[0].tolist() == [2, 3, 7, 8] and int(d2.n[0]) == 4


def test_drafter_never_reads_uncommitted_window_tokens():
    d, jd = _drafts(4, [[5, 666, 666, 666]], [1])
    _assert_same([(d.hist, jd.hist), (d.n, jd.n)])
    assert 666 not in d.hist[0].tolist()


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_drafter_random_histories_match_jax(ngram):
    """Small-vocabulary histories (many matches, some ending right before
    the trailing n-gram, so the continuation index is clipped to the
    history) at every fill level, then a random advance."""
    rng = np.random.default_rng(ngram)
    B, N, W = 12, 10, 4
    hist = rng.integers(0, 3, (B, N)).astype(np.int32)
    n = np.arange(B, dtype=np.int32) % (N + 1)
    hist[np.arange(N)[None, :] < (N - n)[:, None]] = -1
    last = rng.integers(0, 3, B).astype(np.int32)
    d = DraftState(hist=_t(hist), n=_t(n))
    jd = jeng.DraftState(hist=jnp.asarray(hist), n=jnp.asarray(n))
    got = _propose_drafts(d, _t(last), W - 1, ngram)
    want = jeng._propose_drafts(jd, jnp.asarray(last), W - 1, ngram)
    _assert_same([(got, want)])
    toks = rng.integers(0, 3, (B, W)).astype(np.int32)
    c = rng.integers(0, W + 1, B).astype(np.int32)
    d2 = _advance_draft(d, _t(toks), _t(c))
    jd2 = jeng._advance_draft(jd, jnp.asarray(toks), jnp.asarray(c))
    _assert_same([(d2.hist, jd2.hist), (d2.n, jd2.n)])


# ---------------------------------------------------------------------------
# paged verify attention: the plain version against ref.py and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 1), (8, 8)])
def test_paged_verify_attention_matches_jax(H, Hkv, W):
    """Windows straddling page boundaries and the capacity edge, a hole,
    and the trash page poisoned to 1e4 (tests/test_speculative.py:371)."""
    B, dh, P, ps = 3, 32, 10, 8
    rng = np.random.default_rng(H * 10 + Hkv + W)
    q = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    kp = rng.standard_normal((P + 1, ps, Hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((P + 1, ps, Hkv, dh)).astype(np.float32)
    kp[P] = vp[P] = 1e4
    table = np.asarray([[0, 3, 9, -1], [5, -1, 7, -1], [2, 4, 6, 8]], np.int32)
    cur = np.asarray([6, 14, 32 - W], np.int32)
    before = pa_ops.paged_verify_attention.launches
    got = pa_ops.paged_verify_attention(
        *(_t(a) for a in (q, kp, vp, table, cur))).numpy()
    assert pa_ops.paged_verify_attention.launches == before   # CPU: plain
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, cur))
    pallas = jpa_ops.paged_verify_attention(*args, interpret=True)
    ref = jpa_ref.paged_verify_attention_ref(*args)
    np.testing.assert_allclose(got, np.asarray(pallas), **PAGED_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **PAGED_TOL)


def test_paged_verify_rows_equal_sequential_decode():
    """Row w of the verify attention equals a single-query decode at
    cur_pos + w (the window's causality is the position mask)."""
    B, W, H, Hkv, dh, P, ps = 2, 4, 4, 2, 32, 6, 8
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    kp = rng.standard_normal((P + 1, ps, Hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((P + 1, ps, Hkv, dh)).astype(np.float32)
    table = np.asarray([[1, 4], [3, -1]], np.int32)
    cur = np.asarray([5, 2], np.int32)
    got = pa_ops.paged_verify_attention(*(_t(a) for a in (q, kp, vp, table,
                                                          cur)))
    for w in range(W):
        one = pa_ops.paged_decode_attention(_t(q[:, w]), _t(kp), _t(vp),
                                            _t(table), _t(cur + w))
        np.testing.assert_allclose(got[:, w].numpy(), one.numpy(), **POOL_TOL)


# ---------------------------------------------------------------------------
# verify_step against the reference's, dense (write_limit) and paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_dense_verify_step_matches_jax(models, impl, jimpl):
    """A ring of 16 slots; windows of 4 that overrun their budget near the
    ring's capacity: writes at w >= write_limit keep the old ring contents
    and the old pos (else slot 0's would wrap onto position 0)."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(5)
    B, C, W = 3, 16, 4
    cur = np.asarray([13, 5, 14], np.int32)
    limit = np.asarray([2, 4, 1], np.int32)
    port = init_caches(cfg, B, C, device="cpu")
    jc = jax_init_caches(jcfg, B, C)
    kv = {}
    for p, view in port.kv.items():
        k = rng.standard_normal(tuple(view.k.shape)).astype(np.float32)
        v = rng.standard_normal(tuple(view.v.shape)).astype(np.float32)
        slots = np.arange(C)[None, None, :]
        pos = np.broadcast_to(np.where(slots < cur[None, :, None], slots, -1),
                              tuple(view.pos.shape)).astype(np.int32)
        for t, a in zip(view, (k, v, pos)):
            t.copy_(_t(a))
        kv[p] = type(jc.kv[p])(k=jnp.asarray(k), v=jnp.asarray(v),
                               pos=jnp.asarray(pos))
    jc = jc._replace(kv=kv)
    toks = rng.integers(1, cfg.vocab, (B, W)).astype(np.int32)
    logits, port = verify_step(params, _t(toks), port, _t(cur), cfg, impl=impl,
                               write_limit=_t(limit))
    jlogits, jc = jax_verify_step(jp, jnp.asarray(toks), jc, jnp.asarray(cur),
                                  jcfg, impl=jimpl,
                                  write_limit=jnp.asarray(limit))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    for p, view in port.kv.items():
        _assert_same([(view.pos, jc.kv[p].pos)])
        for a, b in zip(view[:2], jc.kv[p][:2]):
            np.testing.assert_allclose(_np(a), np.asarray(b), **POOL_TOL)
        # slot 0 wrote positions 13 and 14; its writes at 15 and 16 were
        # masked, so ring slot 15 stays empty and ring slot 0 keeps pos 0
        assert view.pos[0, 0, [0, 13, 14, 15]].tolist() == [0, 13, 14, -1]


def _fill_pools(rng, cfg, jcfg, n_pages, ps):
    """Matching paged caches for both packages, filled with the same random
    K/V."""
    port = init_paged_caches(cfg, 1, n_pages, ps, device="cpu")
    jc = jax_init_paged_caches(jcfg, 1, n_pages, ps)
    kv = {}
    for p, view in port.kv.items():
        k = rng.standard_normal(tuple(view.k.shape)).astype(np.float32)
        v = rng.standard_normal(tuple(view.v.shape)).astype(np.float32)
        view.k.copy_(_t(k))
        view.v.copy_(_t(v))
        kv[p] = type(jc.kv[p])(k=jnp.asarray(k), v=jnp.asarray(v))
    return port, jc._replace(kv=kv)


def _assert_pools_equal(port, jc, **tol):
    """Pools agree outside the trash page (the last page), which duplicate
    writes may leave in either order."""
    for p, view in port.kv.items():
        for a, b in zip(view, jc.kv[p]):
            np.testing.assert_allclose(_np(a)[:, :-1], np.asarray(b)[:, :-1],
                                       **tol)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_paged_verify_step_matches_jax(models, impl, jimpl):
    """Three slots whose windows cross pages: slot 0 into an unmapped page,
    slot 1 across an unmapped and a mapped page, slot 2 into an unmapped
    last page and one past the table.  Their unmapped positions all land on
    the trash page at the same offsets (the only duplicate writes)."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(6)
    ps, P, W = 4, 12, 4
    port, jc = _fill_pools(rng, cfg, jcfg, P, ps)
    table = np.asarray([[3, 7, -1, -1], [0, 5, -1, 9], [2, 4, 6, -1]], np.int32)
    cur = np.asarray([5, 9, 13], np.int32)
    toks = rng.integers(1, cfg.vocab, (3, W)).astype(np.int32)
    logits, port = verify_step(params, _t(toks), port, _t(cur), cfg, impl=impl,
                               page_table=_t(table))
    jlogits, jc = jax_verify_step(jp, jnp.asarray(toks), jc, jnp.asarray(cur),
                                  jcfg, impl=jimpl,
                                  page_table=jnp.asarray(table))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    _assert_pools_equal(port, jc, **POOL_TOL)


def test_verify_step_refuses_sliding_window(models):
    _, params = models
    _, cfg = _configs(sliding_window=8)
    caches = init_caches(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        verify_step(params, _t([[1, 2]]), caches, _t([3]), cfg)


# ---------------------------------------------------------------------------
# one dense and one paged spec chunk against the reference's
# ---------------------------------------------------------------------------


def _draft_case(rng, B, N, cfg):
    """Histories that repeat a bigram, so some slots draft from a match."""
    hist = np.full((B, N), -1, np.int32)
    n = np.asarray([N, 9, 5, 0], np.int32)[:B]
    for b in range(B):
        seq = rng.integers(1, cfg.vocab, n[b]).astype(np.int32)
        if n[b] >= 6:
            seq[-2:] = seq[1:3]                   # trailing bigram recurs
        hist[b, N - n[b]:] = seq
    return dict(hist=hist, n=n)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_dense_spec_chunk_matches_jax(models, impl, jimpl):
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    B, C, W, Tw = 4, 32, 4, 3
    port = init_caches(cfg, B, C, device="cpu")
    jc = jax_init_caches(jcfg, B, C)
    cur = np.asarray([6, 9, 28, 0], np.int32)
    kv = {}
    for p, view in port.kv.items():
        k = rng.standard_normal(tuple(view.k.shape)).astype(np.float32)
        v = rng.standard_normal(tuple(view.v.shape)).astype(np.float32)
        slots = np.arange(C)[None, None, :]
        pos = np.broadcast_to(np.where(slots < cur[None, :, None], slots, -1),
                              tuple(view.pos.shape)).astype(np.int32)
        for t, a in zip(view, (k, v, pos)):
            t.copy_(_t(a))
        kv[p] = type(jc.kv[p])(k=jnp.asarray(k), v=jnp.asarray(v),
                               pos=jnp.asarray(pos))
    jc = jc._replace(kv=kv)
    state = dict(tokens=rng.integers(1, cfg.vocab, B).astype(np.int32),
                 cur_pos=cur, active=np.asarray([True, True, True, False]),
                 remaining=np.asarray([10, 2, 3, 0], np.int32),
                 eos=np.full((B,), -1, np.int32))
    draft = _draft_case(rng, B, 12, cfg)
    pst, jst = _states(state, SlotState, jeng.SlotState)
    pdr, jdr = _states(draft, DraftState, jeng.DraftState)
    out = make_spec_decode_chunk(cfg, ServeConfig(max_len=C, attn_impl=impl),
                                 Tw, W, 2)(params, port, pst, pdr)
    jout = jeng.make_spec_decode_chunk(
        jcfg, jeng.ServeConfig(max_len=C, attn_impl=jimpl), Tw, W, 2)(
        jp, jc, jst, jdr, jax.random.PRNGKey(0))
    port, st, dr, toks, emitted, poisoned = out
    jc, jst, jdr, jtoks, jemitted, jpoisoned = jout
    _assert_same([(toks, jtoks), (emitted, jemitted), (poisoned, jpoisoned),
                  (dr.hist, jdr.hist), (dr.n, jdr.n)] + list(zip(st, jst)))
    for p, view in port.kv.items():
        _assert_same([(view.pos, jc.kv[p].pos)])
        for a, b in zip(view[:2], jc.kv[p][:2]):
            np.testing.assert_allclose(_np(a), np.asarray(b), **POOL_TOL)
    # the budgets bound the commits: slot 1 stops after 2, slot 2 after 3
    assert emitted.sum(dim=(0, 2)).tolist()[1:] == [2, 3, 0]


def _paged_spec_case(rng, cfg):
    """4 slots, page size 4, 8 pages a slot (max_len 32), 20 pages, 7
    allocated, a lease of 10.  Windows of 6 span up to 3 pages: slot 0
    needs 1 page, slot 1 (one pinned prefix page) 2, slot 2 1 more, which
    the lease denies; slot 3 is inactive."""
    B, maxp, P = 4, 8, 20
    table = np.full((B, maxp), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, 0] = 1
    table[2, :4] = [0, 5, 8, 9]
    used = {3, 7, 1, 0, 5, 8, 9}
    free = np.full((P + 1,), -1, np.int32)
    rest = [i for i in range(P) if i not in used]
    free[:len(rest)] = rest
    pages = dict(table=table, free=free, free_top=np.int32(len(rest)),
                 quota=np.int32(10), pinned=np.asarray([0, 1, 0, 0], np.int32))
    state = dict(tokens=rng.integers(1, cfg.vocab, B).astype(np.int32),
                 cur_pos=np.asarray([6, 3, 16, 0], np.int32),
                 active=np.asarray([True, True, True, False]),
                 remaining=np.asarray([10, 12, 3, 0], np.int32),
                 eos=np.full((B,), -1, np.int32))
    return pages, state


def _run_paged_spec(models, pages, state, draft, *, impl, jimpl, W, Tw, ps,
                    n_pages, rng):
    jp, params = models
    jcfg, cfg = _configs()
    port, jc = _fill_pools(rng, cfg, jcfg, n_pages, ps)
    max_len = pages["table"].shape[1] * ps
    pst, jst = _states(state, SlotState, jeng.SlotState)
    ppg, jpg = _states(pages, PageState, jeng.PageState)
    pdr, jdr = _states(draft, DraftState, jeng.DraftState)
    out = make_paged_spec_decode_chunk(
        cfg, ServeConfig(max_len=max_len, attn_impl=impl), Tw, W, 2, ps)(
        params, port, pst, ppg, pdr)
    jout = jeng.make_paged_spec_decode_chunk(
        jcfg, jeng.ServeConfig(max_len=max_len, attn_impl=jimpl), Tw, W, 2,
        ps)(jp, jc, jst, jpg, jdr, jax.random.PRNGKey(0))
    port, st, pg, dr, toks, emitted, poisoned, ctr = out
    jc, jst, jpg, jdr, jtoks, jemitted, jpoisoned, jctr = jout
    _assert_same([(toks, jtoks), (emitted, jemitted), (poisoned, jpoisoned),
                  (ctr, jctr), (pg.table, jpg.table),
                  (pg.free_top, jpg.free_top), (pg.pinned, jpg.pinned),
                  (dr.hist, jdr.hist), (dr.n, jdr.n)] + list(zip(st, jst)))
    top = int(pg.free_top)
    np.testing.assert_array_equal(_np(pg.free)[:top], np.asarray(jpg.free)[:top])
    _assert_pools_equal(port, jc, **POOL_TOL)
    return st, pg, emitted, ctr


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_paged_spec_chunk_matches_jax(models, impl, jimpl):
    _, cfg = _configs()
    rng = np.random.default_rng(8)
    pages, state = _paged_spec_case(rng, cfg)
    draft = _draft_case(rng, 4, 12, cfg)
    st, pg, emitted, ctr = _run_paged_spec(
        models, pages, state, draft, impl=impl, jimpl=jimpl, W=6, Tw=3, ps=4,
        n_pages=20, rng=rng)
    # window 0: slots 0 and 1 map their spans (3 pages), slot 2 is denied
    # and its 4 pages go back; slot 1's pinned page stays off the stack
    assert int(ctr[2]) == 1 and int(ctr[0]) >= 3
    assert int(emitted[:, 2].sum()) == 0 and not bool(st.active[2])
    assert pg.table[2].tolist() == [-1] * 8


def test_last_page_probe_matches_jax(models):
    """The reference's last-page table write, kept by the port: a window
    entering the LAST logical page, unmapped, at its start.  Span entry 0
    pops a page into column maxp - 1; span entry 1 is clipped onto the same
    column and writes back the old -1.  The page leaks from the free stack
    (``free_top`` 13 -> 12, ``ctr[0]`` 1), the window's K/V goes to the
    trash page, and the slot still commits a token (ROADMAP.md Queue 3)."""
    _, cfg = _configs()
    rng = np.random.default_rng(12)
    B, maxp, P = 2, 4, 16
    table = np.full((B, maxp), -1, np.int32)
    table[0, :3] = [0, 1, 2]
    free = np.full((P + 1,), -1, np.int32)
    free[:P - 3] = np.arange(3, P)
    pages = dict(table=table, free=free, free_top=np.int32(P - 3),
                 quota=np.int32(P), pinned=np.zeros((B,), np.int32))
    state = dict(tokens=rng.integers(1, cfg.vocab, B).astype(np.int32),
                 cur_pos=np.asarray([12, 0], np.int32),
                 active=np.asarray([True, False]),
                 remaining=np.asarray([4, 0], np.int32),
                 eos=np.full((B,), -1, np.int32))
    draft = dict(hist=np.full((B, 8), -1, np.int32), n=np.zeros(B, np.int32))
    st, pg, emitted, ctr = _run_paged_spec(
        models, pages, state, draft, impl="torch", jimpl="xla", W=4, Tw=1,
        ps=4, n_pages=P, rng=rng)
    assert pg.table[0].tolist() == [0, 1, 2, -1]
    assert int(pg.free_top) == 12 and _np(ctr).tolist()[:3] == [1, 0, 0]
    assert int(emitted[0, 0].sum()) >= 1 and bool(st.active[0])


def test_spec_sentinel_ignores_the_vocab_padding(models):
    """A vocab that is not a multiple of 512 is padded, and the padding gets
    -inf from the logit mask.  The reference's spec chunk checks finiteness
    after that mask and flags every active slot on every window; the port
    checks the raw logits, as both packages' decode chunks do, and decodes
    (ROADMAP.md Queue 3)."""
    jcfg, cfg = _configs(vocab=500)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.device_get(jp), device="cpu")
    B, C, W = 2, 16, 4
    state = dict(tokens=np.asarray([3, 4], np.int32),
                 cur_pos=np.asarray([2, 5], np.int32),
                 active=np.asarray([True, True]),
                 remaining=np.asarray([6, 6], np.int32),
                 eos=np.full((B,), -1, np.int32))
    draft = dict(hist=np.full((B, 8), -1, np.int32), n=np.zeros(B, np.int32))
    pst, jst = _states(state, SlotState, jeng.SlotState)
    pdr, jdr = _states(draft, DraftState, jeng.DraftState)
    out = make_spec_decode_chunk(cfg, ServeConfig(max_len=C, attn_impl="torch"),
                                 1, W, 2)(params, init_caches(cfg, B, C,
                                                              device="cpu"),
                                          pst, pdr)
    jout = jeng.make_spec_decode_chunk(
        jcfg, jeng.ServeConfig(max_len=C, attn_impl="xla"), 1, W, 2)(
        jp, jax_init_caches(jcfg, B, C), jst, jdr, jax.random.PRNGKey(0))
    assert np.asarray(jout[5]).tolist() == [True, True]        # reference
    assert out[5].tolist() == [False, False]                   # port
    assert out[4][0].sum(dim=1).tolist() == [int(c) for c in
                                             (out[1].cur_pos - _t([2, 5]))]
    assert int(out[4][0].sum()) >= 2 and int(out[3].max()) < cfg.vocab


# ---------------------------------------------------------------------------
# batcher: spec == greedy and every counter equals the reference's
# ---------------------------------------------------------------------------


def _mk_requests(Req, cfg, n=6, *, seed=7, plen=6, max_new=24, eos=None,
                 head=0, namespace=None):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab, size=head).astype(np.int32)
    return [Req(rid=i, prompt=np.concatenate(
                [shared, rng.integers(1, cfg.vocab, size=plen - head)
                 .astype(np.int32)]),
                max_new=max_new, eos=eos, namespace=namespace)
            for i in range(n)]


BASE = dict(slots=4, prompt_len=8, max_len=48, chunk=4)
SPEC_CASES = {
    "dense": dict(speculative=True, draft_window=4),
    "paged ps4": dict(paged=True, page_size=4, n_pages=96, speculative=True,
                      draft_window=6),
    "paged prefix cache": dict(paged=True, page_size=4, prefix_cache=True,
                               speculative=True, draft_window=4),
    "eos in draft window": dict(speculative=True, draft_window=4),
    "overlap spec paged": dict(paged=True, page_size=8, n_pages=64,
                               speculative=True, draft_window=4, overlap=True),
    "overlap dense, no spec": dict(overlap=True),
    "overlap spec paged prefix": dict(paged=True, page_size=4,
                                      prefix_cache=True, speculative=True,
                                      draft_window=4, overlap=True),
    "set_page_limit shrink": dict(paged=True, page_size=4, n_pages=64,
                                  speculative=True, draft_window=4, chunk=2),
}


def _eos_from(out_lists):
    """An id that first occurs 3 tokens into some greedy stream, so EOS on
    it fires mid-generation."""
    for out in out_lists:
        if len(out) > 3 and out[3] not in out[:3]:
            return out[3]
    raise AssertionError("no usable EOS id")


def _serve(make, Req, config_cls, params, cfg, extra, *, eos=None, impl,
           shrink=False):
    kw = dict(BASE, **extra, attn_impl=impl)
    # a 4-token head shared by every prompt: one cached page at page size 4
    reqs = _mk_requests(Req, cfg, eos=eos, head=4, namespace="s")
    b = make(params, cfg, config_cls(**kw))
    for r in reqs:
        b.submit(r)
    if shrink:
        for _ in range(3):
            b.step()
        b.set_page_limit(28)              # forces requeues and resumes
    b.run(max_steps=4000)
    return b, reqs


def _port_batcher(params, cfg, config):
    return ContinuousBatcher(params, cfg, config, device="cpu")


@pytest.fixture(scope="module")
def greedy(models):
    """The port's plain greedy streams (dense, no speculation, no
    overlap) of the batcher cases' requests, without and with the EOS of
    the EOS case: {eos: (streams, eos)}."""
    _, params = models
    _, cfg = _configs()
    _, plain = _serve(_port_batcher, Request, ServingConfig, params, cfg, {},
                      impl="torch")
    eos = _eos_from([r.out for r in plain])
    _, with_eos = _serve(_port_batcher, Request, ServingConfig, params, cfg,
                         {}, eos=eos, impl="torch")
    assert any(r.out[-1] == eos and len(r.out) < r.max_new for r in with_eos)
    return {None: [r.out for r in plain], eos: [r.out for r in with_eos]}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_batcher_matches_jax_and_greedy(models, greedy, case):
    jp, params = models
    jcfg, cfg = _configs()
    extra = SPEC_CASES[case]
    eos = next(k for k in greedy if k is not None) \
        if case == "eos in draft window" else None
    shrink = case == "set_page_limit shrink"
    jb, want = _serve(JaxBatcher, JaxRequest, JaxServingConfig, jp, jcfg,
                      extra, eos=eos, impl="xla", shrink=shrink)
    b, got = _serve(_port_batcher, Request, ServingConfig, params, cfg, extra,
                    eos=eos, impl="torch", shrink=shrink)
    assert [r.out for r in got] == [r.out for r in want]
    assert [r.out for r in got] == greedy[eos]
    assert all(r.done for r in got)
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    s = b.stats
    pushes = getattr(b, "page_pushes", 0)
    assert s.dispatches - pushes == s.host_syncs == s.prefills + s.chunks
    if extra.get("speculative"):
        assert s.spec_windows > 0 and s.drafted_tokens >= s.accepted_tokens
        if b.paged:
            assert s.device_draft_accepted == s.accepted_tokens
    if extra.get("overlap") and b.paged:
        assert s.overlap_rounds > 0
    if extra.get("prefix_cache"):
        assert s.prefix_hits > 0
    if shrink:
        assert s.oom_requeues > 0
    if b.paged:
        assert int(b.pages.free_top) + b.kv_pool.shared == b.n_pages
        b.kv_pool.check()


def test_spec_rejects_sliding_window_arch(models):
    _, params = models
    _, cfg = _configs(sliding_window=8)
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(params, cfg, ServingConfig(**BASE, speculative=True,
                                                     attn_impl="torch"),
                          device="cpu")


def test_spec_requires_a_verify_impl():
    with pytest.raises(ValueError, match="verify"):
        ServingConfig(**BASE, speculative=True, attn_impl="naive")
    assert ServingConfig(**BASE, speculative=True).attn_impl == "cuda"
