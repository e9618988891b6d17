"""The port's layers, model and weight bridge against the JAX package on the
CPU, at f32.

Weights are made by ``repro.models.init_params`` and moved across with
``repro_torch.weights.params_from_jax``; inputs are made with numpy from a
seed.  Layer tolerance 1e-5; model logits 1e-4, because rounding
differences grow through the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs import get_reduced
from repro_torch.models import decode_step, init_params, layers, prefill
from repro_torch.serving import kv_cache
from repro_torch.weights import params_from_jax, params_to_jax

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-6), ((3, 4, 2, 32), 1e-5)])
def test_rmsnorm_matches_jax(shape, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1:]).astype(np.float32)
    got = layers.rmsnorm({"scale": _t(scale)}, _t(x), eps=eps).numpy()
    want = jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), eps=eps)
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(1)
    d, d_ff = 48, 96
    wi = (rng.standard_normal((d, 2 * d_ff if kind == "swiglu" else d_ff))
          / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((d_ff, d)) / np.sqrt(d_ff)).astype(np.float32)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    got = layers.mlp({"wi": _t(wi), "wo": _t(wo)}, _t(x), kind=kind).numpy()
    want = jax_layers.mlp({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                          jnp.asarray(x), kind=kind)
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("theta,d_head", [(1e6, 32), (1e4, 128)])
def test_apply_rope_matches_jax(theta, d_head):
    """RoPE frequencies come from float64 numpy in both packages, so the
    f32 angles agree; positions reach into the thousands."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, d_head)).astype(np.float32)
    positions = rng.integers(0, 4096, size=(2, 6)).astype(np.int32)
    got = layers.apply_rope(_t(x), _t(positions), theta).numpy()
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)
    np.testing.assert_array_equal(
        layers._inv_freq(d_head, theta, torch.device("cpu")).numpy(),
        np.asarray(jnp.asarray(jax_layers.rope_freqs(d_head, theta),
                               dtype=jnp.float32)))


# ---------------------------------------------------------------------------
# model: prefill + decode_step logits
# ---------------------------------------------------------------------------


def _configs(window=None):
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32",
                               sliding_window=window)
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32",
                              sliding_window=window)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax_init_params(jcfg, jax.random.PRNGKey(0))


# (port impl, JAX impl); the JAX "pallas" path runs its kernels in interpret
# mode, the port's "cuda" path takes the kernels' plain versions on the CPU
IMPLS = [("cuda", "pallas"), ("torch", "xla"), ("naive", "xla")]


@pytest.mark.parametrize("window", [None, 8], ids=["full", "window8-ring"])
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_prefill_and_decode_logits_match_jax(jax_params, impl, jimpl, window):
    """Prompt of 12 with max_len 24: with a window of 8 the ring (C=8) is
    seeded with the last 8 prompt positions and wraps while decoding."""
    jcfg, cfg = _configs(window)
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 12, 24
    toks = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    jl, jc = jax_prefill(jax_params, jnp.asarray(toks), jcfg, max_len=max_len,
                         impl=jimpl)
    tl, tc = prefill(params, _t(toks), cfg, max_len=max_len, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    cur = np.full((B,), S, np.int32)
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1).astype(np.int32)
        jl, jc = jax_decode_step(jax_params, jnp.asarray(nxt), jc,
                                 jnp.asarray(cur), jcfg, impl=jimpl)
        tl, tc = decode_step(params, _t(nxt), tc, _t(cur), cfg, impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        cur = cur + 1
    # the in-place caches hold what the reference's returned caches hold
    np.testing.assert_array_equal(tc.kv["0"].pos.numpy(),
                                  np.asarray(jc.kv["0"].pos))
    np.testing.assert_allclose(tc.kv["0"].k.numpy(), np.asarray(jc.kv["0"].k),
                               **MODEL_TOL)


def test_init_params_tree_matches_jax(jax_params):
    """Same nested layout, shapes and dtypes (values come from a torch
    Generator, so only the structure is compared)."""
    _, cfg = _configs()
    ours = init_params(cfg, 0, device="cpu")
    flat_j, tree_j = jax.tree_util.tree_flatten(jax.device_get(jax_params))
    flat_t, tree_t = jax.tree_util.tree_flatten(ours)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def test_init_params_seeded():
    _, cfg = _configs()
    a = init_params(cfg, 7, device="cpu")
    b = init_params(cfg, 7, device="cpu")
    c = init_params(cfg, 8, device="cpu")
    assert torch.equal(a["blocks"][0]["attn"]["wq"], b["blocks"][0]["attn"]["wq"])
    assert not torch.equal(a["blocks"][0]["attn"]["wq"], c["blocks"][0]["attn"]["wq"])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_unported_families_raise(arch):
    """jamba (hybrid, with MoE layers), whisper and qwen2-vl still raise."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(get_reduced(arch), 0, device="cpu")


def test_moe_family_builds_mixtral():
    """mixtral-8x22b, refused before the MoE family was ported, builds its
    ``moe`` tree (no shared experts) in every block."""
    cfg = get_reduced("mixtral-8x22b")
    lp = init_params(cfg, 0, device="cpu")["blocks"][0]
    m = cfg.moe
    assert "mlp" not in lp and "shared" not in lp["moe"]
    assert tuple(lp["moe"]["wi"].shape) == (cfg.n_layers, m.n_experts,
                                            cfg.d_model, 2 * m.expert_d_ff)
    assert tuple(lp["moe"]["wo"].shape) == (cfg.n_layers, m.n_experts,
                                            m.expert_d_ff, cfg.d_model)
    assert lp["moe"]["router"].dtype == torch.float32


def _init_params_by_stacking(cfg, seed):
    """init_params as it was before the in-place fill: every block built
    from the same generator in the same order, then ``torch.stack``ed."""
    from repro_torch.models import transformer as tr

    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees, dim=0)

    params = {"embed": layers.init_embedding(gen, cfg.vocab_padded,
                                             cfg.d_model, cfg.dtype,
                                             device=dev),
              "final_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype,
                                                device=dev)}
    params["blocks"] = [
        stack([tr._init_one_layer(gen, cfg, spec, dev)
               for _ in range(tr.n_blocks(cfg))])
        for spec in tr.period_structure(cfg)]
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_embedding(
            gen, cfg.vocab_padded, cfg.d_model, cfg.dtype, device=dev)
    return params


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m",
                                  "deepseek-moe-16b", "mixtral-8x22b"])
def test_init_params_fills_in_place_as_stacking_did(arch):
    """The stacked leaves filled block by block hold the same tree, dtypes
    and seeded values as stacking a list of blocks, for every ported
    family."""
    cfg = get_reduced(arch)
    got = init_params(cfg, 5, device="cpu")
    want = _init_params_by_stacking(cfg, 5)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip_bit_exact(dtype):
    """bf16 leaves cross as int16 bit patterns (``torch.from_numpy`` refuses
    ``ml_dtypes.bfloat16``); both directions keep every bit."""
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype=dtype)
    host = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(1)))
    ours = params_from_jax(host, device="cpu")
    assert ours["blocks"][0]["attn"]["wq"].dtype == getattr(torch, dtype)
    back = params_to_jax(ours)
    flat_a, tree_a = jax.tree_util.tree_flatten(host)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


# ---------------------------------------------------------------------------
# KV cache seeding and byte accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,window", [(6, None), (12, 8), (5, 8)])
def test_seed_kv_cache_matches_jax(S, window):
    jcfg, cfg = _configs(window)
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 3, S, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 3, S, 2, 32)).astype(np.float32)
    want = jax_kv_cache.seed_kv_cache(jcfg, jnp.asarray(k), jnp.asarray(v),
                                      max_len=16)
    got = kv_cache.seed_kv_cache(cfg, _t(k), _t(v), max_len=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert kv_cache.kv_cache_bytes(cfg, 3, 16) == \
        jax_kv_cache.kv_cache_bytes(jcfg, 3, 16)


# ---------------------------------------------------------------------------
# places where the port could drift from the reference
# ---------------------------------------------------------------------------


def test_decode_score_scaling_follows_the_reference():
    """``_decode_attn_xla`` scales q by 1/sqrt(dh) in q's dtype *before* the
    dot product; the port's ``_decode_attn_torch`` keeps that form (the
    kernels and ``ref.py`` scale the f32 scores instead).  In bf16 the two
    forms round differently, so this compares like with like."""
    from repro.models.attention import _decode_attn_xla
    from repro_torch.models.attention import _decode_attn_torch

    jcfg, cfg = _configs()
    rng = np.random.default_rng(6)
    B, C, H, Hkv, dh = 2, 10, 4, 2, 32
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32) * 3
    k = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    cur = np.array([C - 1, C - 3], np.int32)
    got = _decode_attn_torch(
        *(_t(a).to(torch.bfloat16) for a in (q, k, v)), _t(pos), _t(cur),
        cfg).float().numpy()
    want = np.asarray(_decode_attn_xla(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(cur), jcfg), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.6e-2)   # 2 bf16 ulps


def test_decode_writes_new_kv_in_cache_dtype():
    """The new token's K/V are cast to the cache dtype before the slot write
    (attention.py:503–508): an f32 activation into a bf16 ring keeps the
    ring bf16 and stores the rounded values at ``cur_pos % C``."""
    from repro_torch.models.attention import (
        _project_qkv, decode_attention, init_kv_cache)
    from repro_torch.models.transformer import _index

    _, cfg = _configs(window=4)
    params = init_params(cfg, 0, device="cpu")
    lp = _index(params["blocks"][0], 0)["attn"]         # block 0's attention
    cache = init_kv_cache(cfg, 2, 12, dtype="bfloat16", device="cpu")
    x = torch.randn(2, 1, cfg.d_model)
    cur = torch.tensor([6, 9], dtype=torch.int32)
    decode_attention(lp, x, cache, cur, cfg, impl="torch")
    assert cache.k.dtype == torch.bfloat16 and cache.k.shape[1] == 4
    _, k_new, _ = _project_qkv(lp, x, cfg, positions=cur[:, None])
    for b, c in enumerate([6 % 4, 9 % 4]):
        assert torch.equal(cache.k[b, c], k_new[b, 0].to(torch.bfloat16))
        assert int(cache.pos[b, c]) == int(cur[b])
