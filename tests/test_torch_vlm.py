"""The port's VLM family (qwen2-vl: a dense backbone with M-RoPE over a
patch-embedding stub) against the JAX package on the CPU, at f32.

Inputs are made with numpy from a seed and fed to both packages; weights
come from ``repro.models.init_params`` through ``weights.params_from_jax``.
The reference's Pallas route runs in interpret mode, as
``tests/test_kernels.py`` runs it.  The M-RoPE positions put an n x n patch
grid at t = 0 (row and column ids in the h and w streams), then the text at
``n_patches + j`` on all three streams, so the streams differ (with three
equal streams M-RoPE is plain RoPE).  Tolerances: functions 1e-5 (rtol and
atol), the model's logits 1e-4; greedy tokens equal.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import generate as jax_generate
from repro_torch.configs import get_reduced
from repro_torch.models import attention, decode_step, layers, prefill
from repro_torch.serving import ContinuousBatcher, ServingConfig, generate
from repro_torch.weights import params_from_jax

FN_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-vl-72b"
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


def grid_positions(B: int, side: int, n_text: int) -> np.ndarray:
    """(3, B, side**2 + n_text) int32 M-RoPE ids: a side x side patch grid
    at t = 0, then the text at ``side**2 + j`` on all three streams."""
    n_p = side * side
    i = np.arange(n_p)
    patch = np.stack([np.zeros(n_p), i // side, i % side])
    text = np.broadcast_to(n_p + np.arange(n_text), (3, n_text))
    pos = np.concatenate([patch, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B) + pos.shape[1:]))


def _vlm_inputs(cfg, B=2, side=3, n_text=13, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(B, n_text)).astype(np.int32)
    emb = (rng.standard_normal((B, side * side, cfg.d_model)) * 0.02)
    return toks, emb.astype(np.float32), grid_positions(B, side, n_text)


def test_chip_smoke_grid_is_the_grid_held_here():
    """``chip_smoke.py`` drives the card with the M-RoPE ids these tests
    hold against the reference."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_vlm", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.vlm_positions(8, smoke.VLM_SIDE, 5, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  grid_positions(8, smoke.VLM_SIDE, 5))


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_head", [32, 64, 128])
def test_mrope_sections_match_jax(d_head):
    assert layers.mrope_sections(d_head) == jax_layers.mrope_sections(d_head)
    assert sum(layers.mrope_sections(d_head)) == d_head // 2


@pytest.mark.parametrize("d_head,theta", [(32, 1e6), (128, 1e6), (64, 1e4)])
def test_apply_mrope_matches_jax_on_three_different_streams(d_head, theta):
    """Three different streams (an 8 x 8 grid, then text): the port equals
    the reference, and differs from plain RoPE on the temporal stream,
    which the reference's own test (three equal streams) cannot show."""
    rng = np.random.default_rng(1)
    pos = grid_positions(2, 8, 6)
    x = rng.standard_normal((2, pos.shape[-1], 4, d_head)).astype(np.float32)
    got = layers.apply_mrope(_t(x), _t(pos), theta)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    plain = layers.apply_rope(_t(x), _t(pos[0]), theta)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)
    same = np.broadcast_to(pos[0], pos.shape)
    np.testing.assert_allclose(layers.apply_mrope(_t(x), _t(same), theta).numpy(),
                               plain.numpy(), **FN_TOL)


def test_project_qkv_broadcasts_plain_positions_as_jax(models):
    """A (B, S) position tensor is broadcast to the three streams (text
    decode), as the reference broadcasts it; (3, B, S) ids pass as they
    are."""
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    lp = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    jlp = {k: v[0] for k, v in jp["blocks"][0]["attn"].items()}
    for pos in (np.arange(7, 12, dtype=np.int32)[None].repeat(2, 0),
                grid_positions(2, 2, 1)):
        got = attention._project_qkv(lp, _t(x), cfg, positions=_t(pos))
        want = jax_attention._project_qkv(jlp, jnp.asarray(x), jcfg,
                                          positions=jnp.asarray(pos))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefill_and_decode_match_jax(models, impl, jimpl):
    """Patch embeddings before the text at grid positions: logits within
    1e-4 and greedy tokens equal over a prefill and four decode steps
    (decode at S_text + n_patches onwards, plain positions)."""
    jp, params = models
    jcfg, cfg = _configs()
    toks, emb, pos = _vlm_inputs(cfg)
    S = pos.shape[-1]
    logits, caches = prefill(params, _t(toks), cfg, max_len=S + 8,
                             positions=_t(pos), extra_embeds=_t(emb), impl=impl)
    jlogits, jcaches = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=S + 8,
                                   positions=jnp.asarray(pos),
                                   extra_embeds=jnp.asarray(emb), impl=jimpl)
    assert caches.cross is None and not caches.ssm
    for step in range(5):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1), np.int32)
        assert (torch.argmax(logits[:, :cfg.vocab], -1).numpy() == tok).all()
        if step == 4:
            break
        cur = np.full((2,), S + step, np.int32)
        logits, caches = decode_step(params, _t(tok), caches, _t(cur), cfg,
                                     impl=impl)
        jlogits, jcaches = jax_decode_step(jp, jnp.asarray(tok), jcaches,
                                           jnp.asarray(cur), jcfg, impl=jimpl)
    for p in caches.kv:
        for a, b in zip(caches.kv[p], jcaches.kv[p]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_generate_matches_jax(models, impl, jimpl):
    """``generate(..., extras=...)``, the reference's serving entry for the
    VLM, gives the reference's tokens on both routes."""
    from repro.serving import ServeConfig as JaxServeConfig
    from repro_torch.serving import ServeConfig

    jp, params = models
    jcfg, cfg = _configs()
    toks, emb, pos = _vlm_inputs(cfg, B=3, side=4, n_text=10, seed=6)
    max_len = pos.shape[-1] + 12
    got = generate(params, cfg, toks, n_new=12,
                   scfg=ServeConfig(max_len=max_len, attn_impl=impl),
                   extras={"extra_embeds": emb, "positions": pos},
                   device="cpu")
    want = jax_generate(jp, jcfg, jnp.asarray(toks), n_new=12,
                        scfg=JaxServeConfig(max_len=max_len, attn_impl=jimpl),
                        extras={"extra_embeds": jnp.asarray(emb),
                                "positions": jnp.asarray(pos)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# refusals: the batcher serves token prompts only
# ---------------------------------------------------------------------------


def test_batcher_refuses_vlm_where_jax_fails_at_admission(models):
    """The reference's batcher builds and then fails at the first admission
    (its prefill step indexes ``extra_embeds``, which a token request does
    not carry); the port refuses at construction, naming ``generate``."""
    jp, params = models
    jcfg, cfg = _configs()
    jb = JaxBatcher(jp, jcfg, JaxServingConfig(slots=2, prompt_len=8,
                                               max_len=16, attn_impl="xla"))
    jb.submit(JaxRequest(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                         max_new=2))
    with pytest.raises(KeyError, match="extra_embeds"):
        jb.run()
    with pytest.raises(ValueError, match="generate"):
        ContinuousBatcher(params, cfg, ServingConfig(
            slots=2, prompt_len=8, max_len=16, attn_impl="torch"),
            device="cpu")


def test_serve_launcher_refuses_vlm():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="generate"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
