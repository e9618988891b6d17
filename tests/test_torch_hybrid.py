"""The port's hybrid family (jamba: Mamba-2 layers with attention every
``attn_every`` layers and MoE every ``moe.every``) against the JAX package on
the CPU, at f32.

Inputs are made with numpy from a seed and fed to both packages; weights
come from ``repro.models.init_params`` through ``weights.params_from_jax``.
The reference's Pallas route runs in interpret mode.  Tolerances: the SSD
scan at jamba's head widths 1e-4 (rtol and atol) against JAX's
``ssd_chunked``: the same sums in another order, but at 16 heads of 128
PyTorch's CPU ``exp`` of the (B, nh, L, L) decay matrix, run in parallel,
returns one head's block up to 1e-4 apart (relative) in some processes
and not in others (seen in 2 of 14 processes on identical inputs), which
moves y by up to 3.5e-5; the model's logits 1e-4; greedy tokens, batcher
tokens and every ``BatcherStats`` counter equal.
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
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import generate as jax_generate
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_passes_ref
from repro_torch.models import (
    decode_step, init_caches, init_paged_caches, prefill, transformer,
)
from repro_torch.models.transformer import prefill_kv
from repro_torch.serving import (
    ContinuousBatcher, Request, ServingConfig, generate, kv_cache,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-1.5-large-398b"
# the port's impl names beside the reference's
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]
# the reference's steps compiled once (eager, each call retraces its scan)
_jax_prefill = jax.jit(jax_prefill, static_argnames=("cfg", "max_len", "impl"))
_jax_decode_step = jax.jit(jax_decode_step, static_argnames=("cfg", "impl"))


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
    # compiled once: half the time of eager init, which dispatches each op
    jp = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# periods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_period_structure_matches_jax(which):
    """jamba's period: 7 Mamba layers and one attention layer (full; 3 and 1
    reduced), MoE on every second layer; an SSM layer carries a MoE FFN on
    a MoE position and no FFN elsewhere."""
    get, jget = ((get_config, jax_config) if which == "full"
                 else (get_reduced, jax_reduced))
    cfg, jcfg = get(ARCH), jget(ARCH)
    got = [(s.mixer, s.mlp) for s in transformer.period_structure(cfg)]
    want = [(s.mixer, s.mlp) for s in jax_transformer.period_structure(jcfg)]
    assert got == want
    assert transformer.period_len(cfg) == jax_transformer.period_len(jcfg)
    assert transformer.n_blocks(cfg) == jax_transformer.n_blocks(jcfg)
    P = cfg.attn_every
    assert got == [("ssm", None), ("ssm", "moe")] * (P // 2 - 1) + [
        ("ssm", None), ("attn", "moe")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_period_keeps_the_published_widths(dtype):
    """``chip_smoke.py`` serves one whole jamba period on the card: every
    field of the published config but the depth, the experts held (a share
    of the 16) and the dtype, and the published period's layer kinds."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_hybrid", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    full, cfg = get_config(ARCH), smoke.hybrid_period(dtype)
    assert cfg.n_layers == transformer.period_len(full) == 8
    assert transformer.period_structure(cfg) == \
        transformer.period_structure(full)
    held = cfg.moe.n_experts
    assert full.moe.n_experts % held == 0 and held >= cfg.moe.top_k
    assert dataclasses.replace(cfg, n_layers=full.n_layers, dtype=full.dtype,
                               moe=dataclasses.replace(
                                   cfg.moe, n_experts=16)) == full


# ---------------------------------------------------------------------------
# the SSD scan at jamba's head widths
# ---------------------------------------------------------------------------


def _scan_inputs(seed, B, S, nh, hd, G, N, dt_range=(1e-3, 1e-1)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    lo, hi = dt_range
    dt = np.exp(rng.uniform(np.log(lo), np.log(hi), size=(B, S, nh)))
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt.astype(np.float32), A, Bm, Cm


@pytest.mark.parametrize("B,S,nh,hd,G,N,chunk", [
    (1, 128, 16, 128, 8, 128, 64),     # jamba's hd, G and N, 2 heads a group
    (2, 96, 8, 128, 8, 16, 32),        # hd 128 at N 16, one head a group
    (1, 100, 16, 128, 8, 128, 32),     # a ragged tail, padded with dt = 0
])
def test_ssd_ops_at_jamba_widths_match_jax(B, S, nh, hd, G, N, chunk):
    """``ops.ssd`` (the plain version on a CPU tensor) and the kernel's
    bf16 route in plain PyTorch (``ssd_passes_ref``) at hd 128 and G 8,
    with slow decay (the carried state matters), against JAX's
    ``ssd_chunked``."""
    x, dt, A, Bm, Cm = _scan_inputs(3, B, S, nh, hd, G, N)
    targs = [_t(a) for a in (x, dt, A, Bm, Cm)]
    jy, jst = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                  chunk=chunk, return_state=True)
    for fn in (ssd_ops.ssd, ssd_passes_ref):
        y, st = fn(*targs, chunk=chunk, return_state=True) \
            if fn is ssd_ops.ssd else fn(*targs, chunk=chunk)
        assert tuple(y.shape) == (B, S, nh, hd)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)


def test_ssd_kernel_takes_jamba_head_dim():
    from repro_torch.kernels.ssd_scan import kernel

    assert get_config(ARCH).ssm.head_dim in kernel.HEAD_DIMS
    assert get_config(ARCH).ssm.d_state in kernel.STATE_DIMS


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefill_and_decode_match_jax(models, impl, jimpl):
    """Mixed periods (SSM layers with and without MoE, an attention layer
    with MoE): logits within 1e-4, greedy tokens and both kinds of cache
    equal over a prefill of 64 (two SSD chunks) and four decode steps."""
    jp, params = models
    jcfg, cfg = _configs()
    S = 64
    toks = np.random.default_rng(7).integers(1, cfg.vocab, size=(2, S))
    toks = toks.astype(np.int32)
    logits, caches = prefill(params, _t(toks), cfg, max_len=S + 8, impl=impl)
    jlogits, jcaches = _jax_prefill(jp, jnp.asarray(toks), jcfg,
                                    max_len=S + 8, impl=jimpl)
    assert set(caches.kv) == set(jcaches.kv) == {"3"}
    assert set(caches.ssm) == set(jcaches.ssm) == {"0", "1", "2"}
    for step in range(5):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1), np.int32)
        assert (torch.argmax(logits[:, :cfg.vocab], -1).numpy() == tok).all()
        for p in caches.ssm:
            for a, b in zip(caches.ssm[p], jcaches.ssm[p]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **MODEL_TOL)
        if step == 4:
            break
        cur = np.full((2,), S + step, np.int32)
        logits, caches = decode_step(params, _t(tok), caches, _t(cur), cfg,
                                     impl=impl)
        jlogits, jcaches = _jax_decode_step(jp, jnp.asarray(tok), jcaches,
                                            jnp.asarray(cur), jcfg, impl=jimpl)


def test_prefill_kv_returns_the_ssm_states_of_prefill(models):
    """``prefill_kv`` (paged admission's prefill) returns the attention
    K/V in position order and the SSM states ``prefill`` seeds: the same
    computation, so they agree to 1e-6 (a CPU GEMM's thread split may
    reorder a sum between two calls)."""
    _, params = models
    _, cfg = _configs()
    toks = _t(np.random.default_rng(8).integers(1, cfg.vocab, size=(2, 40))
              .astype(np.int32))
    logits, kv, ssm = prefill_kv(params, toks, cfg, impl="torch")
    plogits, caches = prefill(params, toks, cfg, max_len=40, impl="torch")
    same = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(logits, plogits, **same)
    assert set(ssm) == set(caches.ssm)
    for p in ssm:
        for a, b in zip(ssm[p], caches.ssm[p]):
            torch.testing.assert_close(a, b, **same)
    torch.testing.assert_close(kv["3"][0], caches.kv["3"].k, **same)


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_generate_matches_jax(models, impl, jimpl):
    from repro.serving import ServeConfig as JaxServeConfig
    from repro_torch.serving import ServeConfig

    jp, params = models
    jcfg, cfg = _configs()
    prompts = np.random.default_rng(8).integers(1, cfg.vocab, size=(2, 32))
    prompts = prompts.astype(np.int32)
    got = generate(params, cfg, prompts, n_new=9,
                   scfg=ServeConfig(max_len=41, attn_impl=impl), device="cpu")
    want = jax_generate(jp, jcfg, jnp.asarray(prompts), n_new=9,
                        scfg=JaxServeConfig(max_len=41, attn_impl=jimpl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_caches_and_bytes_match_jax():
    """Dense and paged caches hold the rings (or the pool) beside the dense
    per-slot SSM states, with the reference's shapes and dtypes, and
    ``kv_cache_bytes`` counts them as the reference does."""
    from repro.models import init_caches as jax_init_caches
    from repro.models import init_paged_caches as jax_init_paged_caches

    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    for caches, jcaches in (
            (init_caches(cfg, 3, 40, device="cpu"), jax_init_caches(jcfg, 3, 40)),
            (init_paged_caches(cfg, 3, 10, 8, device="cpu"),
             jax_init_paged_caches(jcfg, 3, 10, 8))):
        assert caches.cross is None is jcaches.cross
        for mine, theirs in ((caches.kv, jcaches.kv), (caches.ssm, jcaches.ssm)):
            assert set(mine) == set(theirs)
            for p in mine:
                for a, b in zip(mine[p], theirs[p]):
                    assert tuple(a.shape) == b.shape
                    assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert kv_cache.kv_cache_bytes(cfg, 3, 40) == \
        jax_kv_cache.kv_cache_bytes(jcfg, 3, 40) == \
        kv_cache.tree_bytes(init_caches(cfg, 3, 40, device="cpu"))


# ---------------------------------------------------------------------------
# the continuous batcher
# ---------------------------------------------------------------------------


PROMPTS = [np.random.default_rng(3 + i).integers(1, 512, size=1 + 7 * i % 32)
           .astype(np.int32) for i in range(9)]
# mode -> (the port's impl, ServingConfig options), each against the
# reference's xla route: the dense and paged legs on the plain route, the
# overlap and audit legs on the kernels' route (their plain versions on the
# CPU); the reference compiles its dense and paged programs once each
MODES = {
    "dense": ("torch", {}),
    "paged": ("torch", dict(paged=True, page_size=8)),
    "overlap": ("cuda", dict(overlap=True)),
    "paged-audit": ("cuda", dict(paged=True, page_size=8, audit=True)),
}


def _serve(make, Req, config_cls, params, cfg, eos_map, impl, **extra):
    """Nine requests on four slots (prompt lengths 1-29, left-padded to 32,
    one SSD chunk), ``max_new`` 6-10, chunks of 8."""
    b = make(params, cfg, config_cls(slots=4, prompt_len=32, max_len=48,
                                     chunk=8, attn_impl=impl, **extra))
    reqs = [Req(rid=i, prompt=p, max_new=6 + i % 5, eos=eos_map.get(i))
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def _port(params, cfg, config):
    return ContinuousBatcher(params, cfg, config, device="cpu")


def _mid_chunk_eos(out):
    for i in range(2, len(out) - 1):
        if out[i] not in out[:i]:
            return out[i]
    raise AssertionError(f"no usable EOS token in {out}")


@pytest.fixture(scope="module")
def eos_map(models):
    """EOS tokens for requests 0 and 5 from an unstopped run of the port's
    dense batcher (each test then checks that the reference stops there)."""
    _, params = models
    _, cfg = _configs()
    _, probe = _serve(_port, Request, ServingConfig, params, cfg, {}, "torch")
    return {i: _mid_chunk_eos(probe[i].out) for i in (0, 5)}


@pytest.mark.parametrize("mode", list(MODES))
def test_batcher_matches_jax(models, eos_map, mode):
    """Reduced jamba behind the batcher: dense rings, the paged pool
    (attention layers paged, SSM state dense per slot), overlap, and the
    paged pool with the page-table audit; ragged prompts left-padded to 32,
    more requests than slots, an EOS that fires mid-chunk; the tokens and
    every ``BatcherStats`` counter equal the JAX batcher's."""
    jp, params = models
    jcfg, cfg = _configs()
    impl, kw = MODES[mode]
    jb, want = _serve(JaxBatcher, JaxRequest, JaxServingConfig, jp, jcfg,
                      eos_map, "xla", **kw)
    b, got = _serve(_port, Request, ServingConfig, params, cfg, eos_map, impl,
                    **kw)
    for i in (0, 5):
        assert want[i].out[-1] == eos_map[i] and len(want[i].out) < 6 + i % 5
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    assert (b.stats.overlap_rounds > 0) == (mode == "overlap")
    if b.paged:
        b.kv_pool.check()
        assert b.kv_pool.used == 0


@pytest.mark.parametrize("mode,match", [
    ("prefix", "prefix caching requires a pure-attention"),
    ("speculative", "speculative decode requires a pure-attention"),
])
def test_unsupported_modes_refuse_as_jax(models, mode, match):
    jp, params = models
    jcfg, cfg = _configs()
    kw = {"prefix": dict(paged=True, page_size=8, prefix_cache=True),
          "speculative": dict(speculative=True)}[mode]
    for make, config_cls, p, c, impl in (
            (JaxBatcher, JaxServingConfig, jp, jcfg, "xla"),
            (_port, ServingConfig, params, cfg, "torch")):
        with pytest.raises(ValueError, match=match):
            make(p, c, config_cls(slots=2, prompt_len=8, max_len=16,
                                  attn_impl=impl, **kw))


def test_serve_launcher_jamba_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--reduced", "--tenants", "1",
                       "--requests", "5", "--max-new", "4", "--prompt-len",
                       "12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=jamba-1.5-large-398b-reduced" in out and "completed=5/5" in out
