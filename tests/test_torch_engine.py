"""The port's engine steps on the CPU: ``generate`` against the JAX package's
at f32 (greedy tokens identical), and the chunked decode contract — one
T-step chunk equals T single steps, an EOS inside a chunk freezes its slot,
and admission scatters fresh caches into the resident tree in place.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import generate as jax_generate
from repro_torch.configs import get_reduced
from repro_torch.models import init_caches
from repro_torch.serving import (
    ServeConfig, SlotState, generate, init_slot_state, make_admit_step,
    make_decode_chunk, make_prefill_step, select_token,
)
from repro_torch.weights import params_from_jax


def _configs(window=None):
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32",
                               sliding_window=window)
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32",
                              sliding_window=window)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("window", [None, 8], ids=["full", "window8-ring"])
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"), ("cuda", "pallas")])
def test_generate_matches_jax(models, impl, jimpl, window):
    """Prompt 12, 9 new tokens (one 8-step chunk): with a window of 8 the
    ring wraps during both prefill seeding and decode."""
    jp, params = models
    jcfg, cfg = _configs(window)
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(2, 12)) \
        .astype(np.int32)
    want = np.asarray(jax_generate(
        jp, jcfg, jax.numpy.asarray(prompts), n_new=9,
        scfg=JaxServeConfig(max_len=21, attn_impl=jimpl)))
    got = generate(params, cfg, prompts, n_new=9,
                   scfg=ServeConfig(max_len=21, attn_impl=impl), device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _prefilled(params, cfg, B=2, S=8, max_len=32):
    scfg = ServeConfig(max_len=max_len)
    toks = (torch.arange(B * S, dtype=torch.int32).reshape(B, S) * 3 + 1) % cfg.vocab
    logits, caches = make_prefill_step(cfg, scfg)(params, {"tokens": toks})
    t0 = torch.argmax(logits[..., :cfg.vocab], -1).to(torch.int32)
    return scfg, t0, caches, S


def _state(t0, S, budget, eos):
    B = t0.shape[0]
    return SlotState(tokens=t0.clone(),
                     cur_pos=torch.full((B,), S, dtype=torch.int32),
                     active=torch.ones(B, dtype=torch.bool),
                     remaining=torch.full((B,), budget, dtype=torch.int32),
                     eos=torch.as_tensor(eos, dtype=torch.int32))


def _clone(caches):
    return caches._replace(kv={p: type(v)(*(t.clone() for t in v))
                               for p, v in caches.kv.items()})


def test_decode_chunk_equals_single_steps(models):
    """One 6-step chunk emits the same tokens as six 1-step chunks and
    leaves the same caches."""
    _, params = models
    _, cfg = _configs()
    scfg, t0, caches, S = _prefilled(params, cfg)
    c6, _, toks, emitted, poisoned = make_decode_chunk(cfg, scfg, 6)(
        params, _clone(caches), _state(t0, S, 7, [-1, -1]))
    st, c1, ref = _state(t0, S, 7, [-1, -1]), _clone(caches), []
    step = make_decode_chunk(cfg, scfg, 1)
    for _ in range(6):
        c1, st, tk, _, _ = step(params, c1, st)
        ref.append(tk[0])
    np.testing.assert_array_equal(toks.numpy(), torch.stack(ref).numpy())
    assert bool(emitted.all()) and not bool(poisoned.any())
    for a, b in zip(c6.kv["0"], c1.kv["0"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eos_mid_chunk_freezes_slot(models):
    _, params = models
    _, cfg = _configs()
    scfg, t0, caches, S = _prefilled(params, cfg)
    chunk = make_decode_chunk(cfg, scfg, 6)
    _, _, free, _, _ = chunk(params, _clone(caches), _state(t0, S, 7, [-1, -1]))
    eos0 = int(free[2, 0])
    assert eos0 not in free[:2, 0].tolist()
    _, st, toks, emitted, _ = chunk(params, _clone(caches),
                                    _state(t0, S, 7, [eos0, -1]))
    assert emitted[:3, 0].all() and not emitted[3:, 0].any()
    assert emitted[:, 1].all()
    np.testing.assert_array_equal(toks[:3, 0].numpy(), free[:3, 0].numpy())
    np.testing.assert_array_equal(toks[:, 1].numpy(), free[:, 1].numpy())
    assert not bool(st.active[0]) and bool(st.active[1])
    assert int(st.cur_pos[0]) == S + 3 and int(st.cur_pos[1]) == S + 6


def test_admit_scatters_in_place_with_duplicate_rows(models):
    """A partial bucket padded by repeating row 0 (slots [2, 0, 2, 2]) writes
    identical rows for the duplicates; the resident tensors are updated in
    place and untouched slots keep their contents."""
    _, params = models
    _, cfg = _configs()
    scfg = ServeConfig(max_len=16)
    caches = init_caches(cfg, 4, 16)
    state = init_slot_state(4)
    k_before = caches.kv["0"].k
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(1, cfg.vocab, size=(4, 6)).astype(np.int32))
    rows[2:] = rows[0]
    slots = torch.tensor([2, 0, 2, 2], dtype=torch.int32)
    nxt, caches, state = make_admit_step(cfg, scfg)(
        params, {"tokens": rows}, caches, state, slots,
        torch.full((4,), 6, dtype=torch.int32),
        torch.tensor([5, 3, 5, 5], dtype=torch.int32),
        torch.full((4,), -1, dtype=torch.int32))
    assert caches.kv["0"].k is k_before
    fresh = make_prefill_step(cfg, scfg)(params, {"tokens": rows[:2]})[1]
    for j, slot in enumerate([2, 0]):
        torch.testing.assert_close(caches.kv["0"].k[:, slot],
                                   fresh.kv["0"].k[:, j], rtol=1e-5, atol=1e-5)
    assert (caches.kv["0"].pos[:, [1, 3]] == -1).all()
    assert (caches.kv["0"].k[:, [1, 3]] == 0).all()
    assert state.active.tolist() == [True, False, True, False]
    assert state.cur_pos.tolist() == [6, 0, 6, 0]
    assert state.remaining.tolist() == [2, 0, 4, 0]
    assert state.tokens[2] == nxt[0] and state.tokens[0] == nxt[1]


def test_select_token_masks_padding_greedy_and_sampled():
    """The vocab-padding mask keeps every selection below ``vocab``; greedy
    takes the first maximum."""
    cfg = dataclasses.replace(_configs()[1], vocab=500)     # padded to 512
    logits = torch.zeros(3, cfg.vocab_padded)
    logits[:, cfg.vocab:] = 10.0                 # padding must never win
    logits[0, 5] = logits[0, 9] = 1.0            # tie: the first index wins
    mask = ServeConfig(max_len=8).logit_mask(cfg, "cpu")
    assert mask is not None and mask.shape == (512,)
    greedy = select_token(logits, mask, ServeConfig(max_len=8))
    assert greedy[0] == 5 and (greedy < cfg.vocab).all()
    gen = torch.Generator().manual_seed(0)
    sampled = select_token(logits, mask,
                           ServeConfig(max_len=8, greedy=False, temperature=0.5),
                           gen)
    assert sampled.dtype == torch.int32 and (sampled < cfg.vocab).all()


def test_nan_sentinel_runs_before_the_vocab_mask(models):
    """A slot whose logits go non-finite is flagged and deactivated before a
    token is selected; the check reads the raw logits, so the -inf the vocab
    mask adds to the padding never trips it.  The other slot decodes as
    before."""
    _, params = models
    _, cfg = _configs()
    cfg = dataclasses.replace(cfg, vocab=500)              # mask has -inf
    scfg, t0, caches, S = _prefilled(params, cfg)
    chunk = make_decode_chunk(cfg, scfg, 4)
    _, _, clean, emitted, poisoned = chunk(params, _clone(caches),
                                           _state(t0, S, 5, [-1, -1]))
    assert emitted.all() and not poisoned.any()
    bad = _clone(caches)
    bad.kv["0"].v[:, 0] = float("nan")                     # slot 0's cache
    _, st, toks, emitted, poisoned = chunk(params, bad,
                                           _state(t0, S, 5, [-1, -1]))
    assert poisoned.tolist() == [True, False]
    assert not emitted[:, 0].any() and emitted[:, 1].all()
    assert (toks[:, 0] == t0[0]).all()                    # frozen, not emitted
    np.testing.assert_array_equal(toks[:, 1].numpy(), clean[:, 1].numpy())
    assert not bool(st.active[0]) and int(st.cur_pos[0]) == S
