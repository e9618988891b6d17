"""The port's Mixture-of-Experts family against the JAX package on the CPU,
at f32.

Weights come from ``repro.models.init_params`` through
``weights.params_from_jax``; inputs are made with numpy from a seed.  Each
function of ``repro_torch.models.moe`` against ``repro.models.moe``
(tolerance 1e-5: only the summation order differs), the reference's four
MoE properties (``tests/test_ssm_moe.py::TestMoE``) on the port, both
``REDUCED`` MoE models (logits 1e-4, greedy tokens exact), and whole
batcher runs against the reference's (tokens and every ``BatcherStats``
counter equal).  The router runs in f32, where a tie in the top-k is
improbable: ``jax.lax.top_k`` puts the lower index first on a tie and
``torch.topk`` promises no order, so the expert ids are compared exactly
only because no tie occurs in these inputs.
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
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models import verify_step as jax_verify_step
from repro.models.transformer import prefix_prefill as jax_prefix_prefill
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro_torch.configs import get_reduced
from repro_torch.models import (
    decode_step, init_params, moe, period_structure, prefill, prefix_prefill,
    verify_step,
)
from repro_torch.models.transformer import prefill_kv
from repro_torch.serving import ContinuousBatcher, Request, ServingConfig
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax, params_to_jax

# the reference's functions under jit (cfg static): one compile per shape
# instead of one per operation
J_ROUTER = jax.jit(jax_moe.router_probs, static_argnums=2)
J_GROUPED = jax.jit(jax_moe.moe_grouped, static_argnums=2)
J_DENSE = jax.jit(jax_moe.moe_dense_decode, static_argnums=2)
J_APPLY = jax.jit(jax_moe.moe_apply, static_argnums=2,
                  static_argnames="decode")
J_PREFILL = jax.jit(jax_prefill, static_argnums=2, static_argnames="max_len")
J_DECODE = jax.jit(jax_decode_step, static_argnums=4)
J_VERIFY = jax.jit(jax_verify_step, static_argnums=4)
J_PREFIX = jax.jit(jax_prefix_prefill, static_argnums=3,
                   static_argnames="prefix_len")
FN_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]


def _configs(arch, **moe_kw):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    """(arch, JAX params, the port's copy) of each reduced MoE config, made
    once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        jp = jax.jit(jax_init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        out[arch] = (arch, jp, params_from_jax(jax.device_get(jp),
                                               device="cpu"))
    return out


@pytest.fixture(params=ARCHS)
def model(request, weights):
    return weights[request.param]


def _layer(model):
    """Block 0's ``moe`` subtree in both packages."""
    _, jp, params = model
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0])["moe"]
    return jl, {k: (v[0] if not isinstance(v, dict)
                    else {kk: vv[0] for kk, vv in v.items()})
                for k, v in params["blocks"][0]["moe"].items()}


def _x(cfg, B, S, seed=0, *, clusters=0):
    """(B, S, d) f32 at scale 0.3; with ``clusters`` every token is one of
    that many vectors plus a little noise, so the router sends most tokens
    to a few experts (as repeated tokens do) and capacity overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model))
    if clusters:
        base = rng.standard_normal((clusters, cfg.d_model))
        x = base[rng.integers(0, clusters, size=(B, S))] + 0.05 * x
    return (x * 0.3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# functions against repro.models.moe
# ---------------------------------------------------------------------------


def test_init_moe_tree(model):
    """init_moe's leaves: the router in f32, experts and shared MLP in the
    config's dtype, the reference's shapes."""
    arch, _, _ = model
    jcfg, cfg = _configs(arch)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    ours = moe.init_moe(gen, cfg, device="cpu")
    want = jax.eval_shape(lambda k: jax_moe.init_moe(k, dataclasses.replace(
        jcfg, dtype="bfloat16")), jax.random.PRNGKey(0))
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_o, tree_o = jax.tree_util.tree_flatten(ours)
    assert tree_w == tree_o
    for a, b in zip(flat_w, flat_o):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert ours["router"].dtype == torch.float32


def test_router_probs_match_jax(model):
    arch, _, _ = model
    jcfg, cfg = _configs(arch)
    jl, tl = _layer(model)
    x = _x(cfg, 1, 40, seed=1)[0]
    jp, ji, jprobs = J_ROUTER(jl, jnp.asarray(x), jcfg)
    tp, ti, tprobs = moe.router_probs(tl, _t(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **FN_TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **FN_TOL)


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(2)
    E, T, k = 8, 50, 2
    probs = rng.dirichlet(np.ones(E), size=T).astype(np.float32)
    top_i = np.argsort(-probs, axis=1)[:, :k].astype(np.int64)
    want = jax_moe.load_balance_loss(jnp.asarray(probs),
                                     jnp.asarray(top_i.astype(np.int32)), E)
    got = moe.load_balance_loss(_t(probs), _t(top_i), E)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _capacity(cfg, S):
    m = cfg.moe
    return min(max(1, int(S * m.top_k / m.n_experts * m.capacity_factor)),
               S * m.top_k)


@pytest.mark.parametrize("B,S,cf", [(2, 8, None), (2, 48, 1.25)],
                         ids=["reduced-cf", "cf1.25-drops"])
def test_moe_grouped_matches_jax(model, B, S, cf):
    """The grouped dispatch, with ``REDUCED``'s capacity factor (8.0: no
    drops) and with 1.25 at S = 48, where experts overflow and drop the
    same assignments in both packages."""
    arch, _, _ = model
    jcfg, cfg = _configs(arch, **({} if cf is None else
                                  {"capacity_factor": cf}))
    jl, tl = _layer(model)
    x = _x(cfg, B, S, seed=3, clusters=0 if cf is None else 3)
    want, jaux = J_GROUPED(jl, jnp.asarray(x), jcfg)
    got, aux = moe.moe_grouped(tl, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    _, top_i, _ = moe.router_probs(tl, _t(x).reshape(B * S, -1), cfg)
    counts = torch.stack([torch.bincount(r, minlength=cfg.moe.n_experts)
                          for r in top_i.reshape(B, -1)])
    dropped = int((counts - _capacity(cfg, S)).clamp(min=0).sum())
    assert (dropped > 0) == (cf is not None)


def test_moe_dense_decode_matches_jax(model):
    arch, _, _ = model
    jcfg, cfg = _configs(arch)
    jl, tl = _layer(model)
    x = _x(cfg, 4, 3, seed=4)
    want, _ = J_DENSE(jl, jnp.asarray(x), jcfg)
    got, aux = moe.moe_dense_decode(tl, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    assert aux == 0.0


@pytest.mark.parametrize("S,decode", [(4, False), (5, False), (8, True)],
                         ids=["S4-dense", "S5-grouped", "decode"])
def test_moe_apply_switch_matches_jax(model, S, decode):
    """``decode or S <= 4`` takes the dense path, in both packages."""
    arch, _, _ = model
    jcfg, cfg = _configs(arch, capacity_factor=1.0)
    jl, tl = _layer(model)
    x = _x(cfg, 2, S, seed=5)
    want, _ = J_APPLY(jl, jnp.asarray(x), jcfg, decode=decode)
    got, _ = moe.moe_apply(tl, _t(x), cfg, decode=decode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    dense, _ = moe.moe_dense_decode(tl, _t(x), cfg)
    assert torch.equal(got, dense) == (S <= 4 or decode)


# ---------------------------------------------------------------------------
# the reference's four MoE properties (tests/test_ssm_moe.py::TestMoE)
# ---------------------------------------------------------------------------


def _port_layer(arch, seed=0):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_params(cfg, seed, device="cpu")
    lp = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in params["blocks"][0]["moe"].items()}
    return cfg, lp


def test_grouped_equals_dense_decode():
    cfg, lp = _port_layer("mixtral-8x22b")
    x = _t(_x(cfg, 2, 8, seed=6))
    S, k = 8, cfg.moe.top_k
    y_train, aux = moe.moe_grouped(lp, x, cfg, capacity=S * k)   # no drops
    y_dec, _ = moe.moe_dense_decode(lp, x, cfg)
    torch.testing.assert_close(y_train, y_dec, **FN_TOL)
    assert float(aux) > 0.5


def test_capacity_drops_are_bounded():
    cfg, lp = _port_layer("mixtral-8x22b")
    x = _t(_x(cfg, 1, 32, seed=7))
    y_unbounded, _ = moe.moe_grouped(lp, x, cfg, capacity=32 * cfg.moe.top_k)
    y_capped, _ = moe.moe_grouped(lp, x, cfg, capacity=2)
    diff_tokens = int(((y_unbounded - y_capped).abs().amax(-1) > 1e-3).sum())
    assert 0 < diff_tokens < 32    # some tokens survive with exact output


def test_shared_experts_always_active():
    cfg, lp = _port_layer("deepseek-moe-16b")
    assert cfg.moe.n_shared_experts > 0
    x = _t(_x(cfg, 1, 4, seed=8))
    lp2 = dict(lp, wi=torch.zeros_like(lp["wi"]), wo=torch.zeros_like(lp["wo"]))
    y2, _ = moe.moe_apply(lp2, x, cfg, decode=False)
    assert float(y2.abs().max()) > 0


def test_load_balance_loss_uniform_router():
    E, T, K = 8, 1024, 2
    probs = torch.full((T, E), 1.0 / E)
    top_i = (torch.arange(T * K) % E).reshape(T, K)
    assert float(moe.load_balance_loss(probs, top_i, E)) == \
        pytest.approx(1.0, rel=1e-3)


def test_expert_products_read_the_weights_in_place():
    """The expert products take ``wi``/``wo`` as stored, (E, d, 2f) and
    (E, f, d), with a broadcast (1, T, d) batch, and equal an explicit loop
    over the experts (the card's peak-memory gate, phase 5g, shows that
    no weight is copied)."""
    cfg, lp = _port_layer("deepseek-moe-16b")
    x = _t(_x(cfg, 1, 6, seed=9))[0]
    wi, wo = lp["wi"], lp["wo"]
    assert wi.is_contiguous() and wo.is_contiguous()
    y = moe._expert_ffn(x[None], wi, wo)
    want = torch.stack([
        torch.nn.functional.silu(x @ wi[e][:, :wi.shape[-1] // 2])
        * (x @ wi[e][:, wi.shape[-1] // 2:]) @ wo[e]
        for e in range(wi.shape[0])])
    torch.testing.assert_close(y, want, **FN_TOL)


# ---------------------------------------------------------------------------
# the models: prefill, decode, verify and prefix against the reference
# ---------------------------------------------------------------------------


def test_period_structure_marks_moe_layers(model):
    arch, _, _ = model
    _, cfg = _configs(arch)
    specs = period_structure(cfg)
    assert [(s.mixer, s.mlp) for s in specs] == [("attn", "moe")]


def test_model_logits_and_tokens_match_jax(model):
    """Prefill of a 12-token prompt, 4 greedy decode steps, and (deepseek;
    mixtral's window refuses it in both packages) one verify window of the
    decoded tokens against the steps' logits."""
    arch, jp, params = model
    jcfg, cfg = _configs(arch)
    rng = np.random.default_rng(10)
    B, S, steps = 2, 12, 4
    toks = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    jl, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, max_len=24)
    tl, tc = prefill(params, _t(toks), cfg, max_len=24, impl="torch")
    cur = np.full((B,), S, np.int32)
    window, step_logits = [], []
    for _ in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab], -1)).astype(np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl[:, :cfg.vocab], -1).numpy(), tok)
        window.append(tok)
        step_logits.append(tl)
        jl, jc = J_DECODE(jp, jnp.asarray(tok), jc, jnp.asarray(cur), jcfg)
        tl, tc = decode_step(params, _t(tok), tc, _t(cur), cfg, impl="torch")
        cur = cur + 1
    if cfg.sliding_window:
        with pytest.raises(ValueError, match="sliding-window"):
            verify_step(params, _t(np.stack(window[:steps], 1)), tc, _t(cur),
                        cfg)
        return
    # a fresh prefill, then one window of the first `steps` decoded tokens
    w = np.stack(window[:steps], axis=1)
    _, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, max_len=24)
    _, tc = prefill(params, _t(toks), cfg, max_len=24, impl="torch")
    jv, _ = J_VERIFY(jp, jnp.asarray(w), jc, jnp.full((B,), S, jnp.int32),
                     jcfg)
    tv, _ = verify_step(params, _t(w), tc, torch.full((B,), S, dtype=torch.int32),
                        cfg, impl="torch")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL_TOL)
    for j in range(steps):
        np.testing.assert_allclose(tv[:, j].numpy(), step_logits[j + 1].numpy(),
                                   **MODEL_TOL)


@pytest.mark.parametrize("suffix", [3, 9], ids=["dense-suffix", "grouped-suffix"])
def test_prefix_prefill_matches_jax(weights, suffix):
    """A cached admission routes its suffix alone, with the suffix's own
    capacity; a suffix of at most 4 tokens takes the dense path."""
    jcfg, cfg = _configs("deepseek-moe-16b", capacity_factor=1.0)
    _, jp, params = weights["deepseek-moe-16b"]
    rng = np.random.default_rng(11)
    Lp = 8
    toks = rng.integers(1, cfg.vocab, size=(2, Lp + suffix)).astype(np.int32)
    _, pkv, _ = prefill_kv(params, _t(toks[:, :Lp]), cfg, impl="torch")
    got, out = prefix_prefill(params, _t(toks[:, Lp:]), pkv, cfg,
                              prefix_len=Lp, impl="torch")
    jpkv = {p: (jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
            for p, (k, v) in pkv.items()}
    want, jout = J_PREFIX(jp, jnp.asarray(toks[:, Lp:]), jpkv, jcfg,
                          prefix_len=Lp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for p in out:
        for a, b in zip(out[p], jout[p]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)


def test_bf16_moe_tree_round_trips_bit_exact():
    """params_from_jax / params_to_jax carry the ``moe`` subtree (router in
    f32, experts and shared MLP in bf16) and keep every bit."""
    jcfg = jax_reduced("deepseek-moe-16b")
    host = jax.device_get(jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(2)))
    ours = params_from_jax(host, device="cpu")
    lp = ours["blocks"][0]["moe"]
    assert lp["router"].dtype == torch.float32
    assert lp["wi"].dtype == lp["shared"]["wi"].dtype == torch.bfloat16
    flat_a, tree_a = jax.tree_util.tree_flatten(host)
    flat_b, tree_b = jax.tree_util.tree_flatten(params_to_jax(ours))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


# ---------------------------------------------------------------------------
# whole batcher runs against the reference's
# ---------------------------------------------------------------------------


def _prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _shared_prompts(cfg, n, seed):
    """A 16-token head shared by every prompt, then a 4-8 token tail."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, cfg.vocab, size=int(
        rng.integers(4, 9))).astype(np.int32)]) for _ in range(n)]


def _run_pair(model, kw, prompts, max_new, *, namespace=None):
    arch, jp, params = model
    jcfg, cfg = _configs(arch)
    jb = JaxBatcher(jp, jcfg, JaxServingConfig(attn_impl="xla", **kw))
    tb = ContinuousBatcher(params, cfg, ServingConfig(attn_impl="cuda", **kw),
                           device="cpu")
    runs = []
    for b, Req in ((jb, JaxRequest), (tb, Request)):
        reqs = [Req(rid=i, prompt=p, max_new=max_new[i % len(max_new)],
                    namespace=namespace) for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run(max_steps=4000)
        runs.append(reqs)
    assert [r.out for r in runs[1]] == [r.out for r in runs[0]]
    assert all(r.done and len(r.out) == r.max_new for r in runs[1])
    assert tb.stats.as_dict() == {**jb.stats.as_dict(),
                                  **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    return tb


MODES = {
    "dense": dict(slots=4, prompt_len=16, max_len=40, chunk=4),
    "paged-prefix": dict(slots=4, prompt_len=32, max_len=56, chunk=4,
                         paged=True, page_size=8, prefix_cache=True),
    "spec-overlap": dict(slots=4, prompt_len=32, max_len=64, chunk=2,
                         paged=True, page_size=8, prefix_cache=True,
                         speculative=True, draft_window=4, overlap=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_deepseek_batcher_matches_jax(weights, mode):
    """deepseek reduced through the batcher's dense rings, the paged pool
    with the prefix cache (cached admissions route their suffix), and
    speculative windows with overlap: tokens and stats equal."""
    model = weights["deepseek-moe-16b"]
    cfg = _configs("deepseek-moe-16b")[1]
    if mode == "dense":
        b = _run_pair(model, MODES[mode], _prompts(cfg, 7, 2, 16, seed=12),
                      [6, 11, 9])
        assert b.stats.prefills >= 2
        return
    b = _run_pair(model, MODES[mode], _shared_prompts(cfg, 8, seed=13),
                  [6, 12, 9, 16], namespace="t")
    assert b.stats.prefix_hits > 0
    if mode == "spec-overlap":
        assert b.stats.spec_windows > 0 and b.stats.overlap_rounds > 0


def test_mixtral_batcher_wraps_its_window_like_jax(weights):
    """mixtral reduced (window 64) on dense rings: prompts and ``max_new``
    reach past 64 positions, so every ring wraps."""
    model = weights["mixtral-8x22b"]
    cfg = _configs("mixtral-8x22b")[1]
    kw = dict(slots=3, prompt_len=32, max_len=100, chunk=8)
    b = _run_pair(model, kw, _prompts(cfg, 4, 20, 33, seed=14), [50, 44])
    assert b.caches.kv["0"].k.shape[2] == 64       # the ring, not max_len
    assert b.stats.completed == 4


@pytest.mark.parametrize("mode", ["prefix", "speculative"])
def test_model_dependent_refusals_match_jax(weights, mode):
    """deepseek takes the prefix cache and speculation; mixtral's window
    refuses both, in both packages (the reference's paged pool refuses a
    window where the port's batcher names it first)."""
    kw = dict(slots=2, prompt_len=8, max_len=24, paged=True, page_size=8)
    kw.update(prefix_cache=True) if mode == "prefix" else kw.update(
        speculative=True)
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        _, jp, params = weights[arch]

        def build_jax():
            return JaxBatcher(jp, jcfg, JaxServingConfig(attn_impl="xla", **kw))

        def build_port():
            return ContinuousBatcher(params, cfg, ServingConfig(
                attn_impl="torch", **kw), device="cpu")

        if cfg.sliding_window:
            for build in (build_jax, build_port):
                with pytest.raises(ValueError, match="sliding"):
                    build()
        else:
            build_jax()
            build_port()


def test_serve_launcher_serves_deepseek_reduced_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "deepseek-moe-16b", "--reduced",
                       "--tenants", "1", "--requests", "3", "--max-new", "5",
                       "--prompt-len", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-moe-16b-reduced" in out and "completed=3/3" in out


def test_profiler_ranges_name_the_moe_classes():
    """While a profiler records, the routing and dispatch ops run inside
    ``moe.dispatch`` and the expert products inside
    ``moe.expert_products``; with no profiler, no range is opened."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import profiled

    cfg, lp = _port_layer("deepseek-moe-16b")
    x = _t(_x(cfg, 2, 8, seed=15))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.moe_apply(lp, x, cfg)                     # grouped
        moe.moe_apply(lp, x, cfg, decode=True)        # dense

    def scope(evt):
        p = evt.cpu_parent
        while p is not None and not p.name.startswith("moe."):
            p = p.cpu_parent
        return p.name if p is not None else None

    seen = {(e.name, scope(e)) for e in prof.events()}
    for op in ("aten::topk", "aten::argsort", "aten::scatter_", "aten::gather"):
        assert (op, "moe.dispatch") in seen, op
    assert ("aten::bmm", "moe.expert_products") in seen
    assert not torch._C._autograd._profiler_enabled()
    # off: the one shared no-op context, no range object made
    assert profiled("moe.dispatch") is profiled("moe.expert_products")
    assert not isinstance(profiled("moe.dispatch"),
                          torch.profiler.record_function)
