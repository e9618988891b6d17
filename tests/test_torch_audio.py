"""The port's audio family (whisper: an encoder-decoder over a frame-embedding
stub, sinusoidal positions, cross-attention in every decoder layer) against
the JAX package on the CPU, at f32.

Inputs are made with numpy from a seed and fed to both packages; weights
come from ``repro.models.init_params`` through ``weights.params_from_jax``.
The reference's Pallas route runs in interpret mode.  Tolerances: functions
1e-5 (rtol and atol), the model's logits 1e-4; greedy tokens equal.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import encoder_forward as jax_encoder_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_transformer
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import generate as jax_generate
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import (
    attention, decode_step, encoder_forward, init_caches, prefill, transformer,
)
from repro_torch.serving import ContinuousBatcher, ServingConfig, generate
from repro_torch.serving import kv_cache
from repro_torch.weights import params_from_jax

FN_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-base"
# the port's impl names beside the reference's
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs():
    return (dataclasses.replace(jax_reduced(ARCH), dtype="float32"),
            dataclasses.replace(get_reduced(ARCH), dtype="float32"))


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_programs():
    """Free this file's compiled JAX programs and models when it ends, so
    the rest of the worker's test run does not carry them."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _frames(cfg, B=2, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) * 0.1
            ).astype(np.float32)


def _layer(tree, b=0):
    """Block ``b`` of a stacked (nested) dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, b) for k, v in tree.items()}
    return tree[b]


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_model", [128, 512])
def test_sinusoid_matches_jax(d_model):
    """Every position of the reduced model (encoder frames 0-63, decoder
    positions below 64)."""
    pos = np.arange(128, dtype=np.int32).reshape(2, 64)
    got = transformer._sinusoid(_t(pos), d_model)
    want = jax_transformer._sinusoid(jnp.asarray(pos), d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_sinusoid_far_positions_part_by_the_exp_rounding():
    """At whisper-base's far positions (decoder up to 447, encoder frames up
    to 1499) the two packages part by more than 1e-5: both compute the
    frequencies exp(-ln(1e4) i / (half - 1)) in f32, and XLA's exp and
    PyTorch's round 25 of the 256 differently (1 ulp), which the angle
    pos * freq multiplies by pos.  The gap stays within pos x 1 ulp of the
    largest frequency (1.0)."""
    d_model, half = 512, 256
    freq = transformer._sinusoid(torch.ones((1,), dtype=torch.int32),
                                 d_model)[0, :half]
    jfreq = jax_transformer._sinusoid(jnp.ones((1,), jnp.int32), d_model)[0, :half]
    n_ulp = np.abs(freq.numpy() - np.asarray(jfreq)) / np.spacing(
        np.abs(freq.numpy()))
    assert n_ulp.max() <= 1.0
    for p in (447, 1499):
        pos = np.array([[p]], np.int32)
        got = transformer._sinusoid(_t(pos), d_model).numpy()
        want = np.asarray(jax_transformer._sinusoid(jnp.asarray(pos), d_model))
        assert np.abs(got - want).max() <= p * np.spacing(np.float32(1.0))


def test_sinusoidal_positions_match_jax():
    """The host table of ``layers.sinusoidal_positions`` (numpy on both
    sides): equal."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    np.testing.assert_array_equal(layers.sinusoidal_positions(448, 512),
                                  jax_layers.sinusoidal_positions(448, 512))


def test_encode_cross_kv_matches_jax(models):
    jp, params = models
    jcfg, cfg = _configs()
    enc = _frames(cfg)
    got = attention.encode_cross_kv(_layer(params["blocks"][0]["cross"]),
                                    _t(enc), cfg)
    want = jax_attention.encode_cross_kv(_layer(jp["blocks"][0]["cross"]),
                                         jnp.asarray(enc), jcfg)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (2, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FN_TOL)


@pytest.mark.parametrize("S", [1, 4, 9])
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"), ("cuda", "xla"),
                                        ("naive", "naive")])
def test_cross_attention_matches_jax(models, impl, jimpl, S):
    """Decoder rows (one decode token, a short prompt) over the encoder's
    K/V, non-causal; ``"cuda"`` on a CPU tensor takes the flash kernel's
    plain version, the reference's ``pallas`` route its plain attention."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    enc = _frames(cfg)
    lp, jlp = (_layer(params["blocks"][0]["cross"]),
               _layer(jp["blocks"][0]["cross"]))
    kv = attention.encode_cross_kv(lp, _t(enc), cfg)
    jkv = jax_attention.encode_cross_kv(jlp, jnp.asarray(enc), jcfg)
    got = attention.cross_attention(lp, _t(x), kv, cfg, impl=impl)
    want = jax_attention.cross_attention(jlp, jnp.asarray(x), jkv, jcfg,
                                         impl=jimpl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_encoder_forward_matches_jax(models, impl, jimpl):
    jp, params = models
    jcfg, cfg = _configs()
    fr = _frames(cfg)
    got = encoder_forward(params, _t(fr), cfg, impl=impl)
    want = jax_encoder_forward(jp, jnp.asarray(fr), jcfg, impl=jimpl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefill_and_decode_match_jax(models, impl, jimpl):
    """The encoder's output seeds every decoder layer's cross K/V once;
    logits within 1e-4 and greedy tokens equal over a prefill and four
    decode steps (sinusoidal positions at embed and at decode)."""
    jp, params = models
    jcfg, cfg = _configs()
    fr = _frames(cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, size=(2, 6))
    toks = toks.astype(np.int32)
    enc = encoder_forward(params, _t(fr), cfg, impl=impl)
    jenc = jax_encoder_forward(jp, jnp.asarray(fr), jcfg, impl=jimpl)
    logits, caches = prefill(params, _t(toks), cfg, max_len=12, enc_out=enc,
                             impl=impl)
    jlogits, jcaches = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=12,
                                   enc_out=jenc, impl=jimpl)
    assert set(caches.cross) == set(jcaches.cross) == {"0"}
    for a, b in zip(caches.cross["0"], jcaches.cross["0"]):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
    for step in range(5):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1), np.int32)
        assert (torch.argmax(logits[:, :cfg.vocab], -1).numpy() == tok).all()
        if step == 4:
            break
        cur = np.full((2,), 6 + step, np.int32)
        logits, caches = decode_step(params, _t(tok), caches, _t(cur), cfg,
                                     impl=impl)
        jlogits, jcaches = jax_decode_step(jp, jnp.asarray(tok), jcaches,
                                           jnp.asarray(cur), jcfg, impl=jimpl)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_generate_matches_jax(models, impl, jimpl):
    """``generate(..., extras={"frames": ...})``, the reference's serving
    entry for audio, gives the reference's tokens on both routes."""
    from repro.serving import ServeConfig as JaxServeConfig
    from repro_torch.serving import ServeConfig

    jp, params = models
    jcfg, cfg = _configs()
    fr = _frames(cfg, B=3, seed=8)
    toks = np.random.default_rng(9).integers(1, cfg.vocab, size=(3, 4))
    toks = toks.astype(np.int32)
    got = generate(params, cfg, toks, n_new=13,
                   scfg=ServeConfig(max_len=20, attn_impl=impl),
                   extras={"frames": fr}, device="cpu")
    want = jax_generate(jp, jcfg, jnp.asarray(toks), n_new=13,
                        scfg=JaxServeConfig(max_len=20, attn_impl=jimpl),
                        extras={"frames": jnp.asarray(fr)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_admit_step_merges_cross_kv_as_jax(models):
    """The engine's admit step, called with the frames the batcher does not
    pass: two requests join slots 3 and 1 of four; the cross K/V lands in
    those slots as the reference's ``make_admit_step`` puts it, the other
    slots stay zero, and the first tokens and slot state agree."""
    from repro.serving import ServeConfig as JaxServeConfig
    from repro.serving import engine as jax_engine
    from repro_torch.serving import ServeConfig, engine

    jp, params = models
    jcfg, cfg = _configs()
    fr = _frames(cfg, B=2, seed=6)
    toks = np.random.default_rng(7).integers(1, cfg.vocab, size=(2, 4))
    toks = toks.astype(np.int32)
    slots, pos0 = np.array([3, 1], np.int32), np.full((2,), 4, np.int32)
    budget, eos = np.array([5, 3], np.int32), np.full((2,), -1, np.int32)
    nxt, caches, state = engine.make_admit_step(cfg, ServeConfig(max_len=16))(
        params, {"tokens": _t(toks), "frames": _t(fr)},
        init_caches(cfg, 4, 16, device="cpu"),
        engine.init_slot_state(4, device="cpu"),
        *(_t(a) for a in (slots, pos0, budget, eos)))
    jnxt, jcaches, jstate = jax_engine.make_admit_step(
        jcfg, JaxServeConfig(max_len=16))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
        jax_init_caches(jcfg, 4, 16), jax_engine.init_slot_state(4),
        *(jnp.asarray(a) for a in (slots, pos0, budget, eos)))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    for a, b in zip(caches.cross["0"], jcaches.cross["0"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
        assert (a[:, [0, 2]] == 0).all() and (a[:, [1, 3]] != 0).any()
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# caches and their bytes
# ---------------------------------------------------------------------------


def test_caches_and_bytes_match_jax():
    """``init_caches`` holds the cross K/V per period position with the
    reference's shapes and dtypes, and ``kv_cache_bytes`` counts it as the
    reference does (n_layers x batch x enc_seq x kv_dim x 2 x itemsize
    beside the rings), for the reduced and the full config."""
    jcfg, cfg = (jax_reduced(ARCH), get_reduced(ARCH))
    caches = init_caches(cfg, 3, 40, device="cpu")
    jcaches = jax_init_caches(jcfg, 3, 40)
    assert set(caches.cross) == set(jcaches.cross)
    for a, b in zip(caches.cross["0"], jcaches.cross["0"]):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert kv_cache.kv_cache_bytes(cfg, 3, 40) == \
        jax_kv_cache.kv_cache_bytes(jcfg, 3, 40) == \
        kv_cache.tree_bytes(caches)
    full, jfull = get_config(ARCH), jax_config(ARCH)
    cross = full.n_layers * 8 * full.enc_seq * full.kv_dim * 2 * 2
    assert kv_cache.kv_cache_bytes(full, 8, 448) == \
        jax_kv_cache.kv_cache_bytes(jfull, 8, 448) > cross


# ---------------------------------------------------------------------------
# refusals: the batcher serves token prompts only
# ---------------------------------------------------------------------------


def test_batcher_refuses_audio_where_jax_fails_at_admission(models):
    """The reference's batcher builds and then fails at the first admission
    (its prefill step indexes ``frames``); the port refuses at construction,
    naming ``generate``."""
    jp, params = models
    jcfg, cfg = _configs()
    jb = JaxBatcher(jp, jcfg, JaxServingConfig(slots=2, prompt_len=8,
                                               max_len=16, attn_impl="xla"))
    jb.submit(JaxRequest(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                         max_new=2))
    with pytest.raises(KeyError, match="frames"):
        jb.run()
    for kw in ({}, dict(paged=True, page_size=4)):
        with pytest.raises(ValueError, match="generate"):
            ContinuousBatcher(params, cfg, ServingConfig(
                slots=2, prompt_len=8, max_len=16, attn_impl="torch", **kw),
                device="cpu")


def test_serve_launcher_refuses_audio():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="generate"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
