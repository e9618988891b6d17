"""The port's Mamba-2 (SSD) family against the JAX package on the CPU, at f32.

Inputs are made with numpy from a seed and fed to both packages; weights
come from ``repro.models.init_params`` through ``weights.params_from_jax``.
The reference's Pallas route runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Tolerances:

* the scan: 1e-5 (rtol and atol) between the two ``ssd_chunked`` (the same
  algorithm, only the summation order differs), 1e-4 against the O(S²)
  ``ssd_naive`` and the Pallas kernel (another order of the same sums);
* layers: 1e-5; the SSM block and the model's logits: 1e-4, because
  rounding differences grow through the projections and layers;
* greedy tokens, batcher tokens and every ``BatcherStats`` counter: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan.ref import ssd_naive as jax_ssd_naive
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs import get_reduced
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_naive, ssd_passes_ref
from repro_torch.models import decode_step, init_caches, init_params, prefill
from repro_torch.models import layers, ssm
from repro_torch.serving import (
    ContinuousBatcher, Request, ServingConfig, generate, kv_cache,
)
from repro_torch.serving.batcher import PORT_STATS_FIELDS
from repro_torch.weights import params_from_jax, params_to_jax

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-370m"
# the port's impl names beside the reference's
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(dtype="float32"):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(get_reduced(ARCH), dtype=dtype))


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _scan_inputs(seed, B, S, nh, hd, G, N, dt_range=None):
    """SSD inputs as numpy f32 (dt after softplus, or log-uniform over
    ``dt_range``; A < 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    if dt_range is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    else:
        lo, hi = dt_range
        dt = np.exp(rng.uniform(np.log(lo), np.log(hi), size=(B, S, nh)))
    dt = dt.astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,nh,hd,G,N,chunk", [
    (2, 128, 4, 32, 1, 16, 32),      # the reduced config's dims, 4 chunks
    (1, 192, 8, 16, 2, 8, 64),       # G = 2, rep 4
    (2, 96, 2, 32, 1, 16, 96),       # a single chunk
])
def test_ssd_chunked_matches_jax_oracles_and_pallas(B, S, nh, hd, G, N, chunk):
    """The port's ``ssd_chunked`` against JAX's ``ssd_chunked`` (y and the
    final state), ``ssd_naive`` and the Pallas kernel in interpret mode."""
    x, dt, A, Bm, Cm = _scan_inputs(0, B, S, nh, hd, G, N)
    y, st = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=chunk,
                            return_state=True)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jst = jax_ssm.ssd_chunked(*jargs, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_ssd_naive(*jargs)),
                               **ORACLE_TOL)
    py, pst = jax_ssd_ops.ssd(*jargs, chunk=chunk, return_state=True,
                              interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **ORACLE_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **ORACLE_TOL)


@pytest.mark.parametrize("S,chunk", [(128, 32), (120, 32)])
def test_ssd_carries_the_state_as_jax(S, chunk):
    """Slow decay (dt log-uniform over Mamba-2's [1e-3, 1e-1], so the state
    decays by 0.1-0.9 over a chunk: checked): y of every chunk after the
    first depends on the carried state, which dt ~ 0.8 all but erases.  The
    port's ``ssd_chunked`` and ``ops.ssd`` (S = 120 pads a ragged tail)
    against JAX's ``ssd_chunked``, ``ssd_naive`` and, where S divides by
    the chunk, the Pallas kernel in interpret mode."""
    x, dt, A, Bm, Cm = _scan_inputs(2, 2, S, 4, 32, 1, 16,
                                    dt_range=(1e-3, 1e-1))
    n = S // chunk * chunk
    decay = np.exp((dt[:, :n] * A).reshape(2, -1, chunk, 4).sum(2))
    assert 0.1 <= np.median(decay) <= 0.9
    targs = [_t(a) for a in (x, dt, A, Bm, Cm)]
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jst = jax_ssm.ssd_chunked(*jargs, chunk=chunk, return_state=True)
    for fn in (ssm.ssd_chunked, ssd_ops.ssd):
        y, st = fn(*targs, chunk=chunk, return_state=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_ssd_naive(*jargs)),
                               **ORACLE_TOL)
    if S % chunk == 0:
        py, pst = jax_ssd_ops.ssd(*jargs, chunk=chunk, return_state=True,
                                  interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(py), **ORACLE_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(pst), **ORACLE_TOL)


def test_ssd_naive_matches_jax():
    x, dt, A, Bm, Cm = _scan_inputs(1, 2, 40, 4, 16, 2, 8)
    got = ssd_naive(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm))
    want = jax_ssd_naive(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("S,chunk", [(24, 32), (40, 16), (70, 32)])
def test_ssd_ops_pads_a_ragged_tail_as_ssd_chunked(S, chunk):
    """``ops.ssd`` takes ``L = min(chunk, S)`` and pads with ``dt = 0``, as
    JAX's ``ssd_chunked`` does, where the reference's Pallas route asserts
    ``S % chunk == 0`` (ROADMAP.md Queue 3: a deviation the port does not
    keep)."""
    x, dt, A, Bm, Cm = _scan_inputs(2, 2, S, 4, 32, 1, 16)
    before = ssd_ops.ssd.launches
    y, st = ssd_ops.ssd(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=chunk,
                        return_state=True)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jst = jax_ssm.ssd_chunked(*jargs, chunk=chunk, return_state=True)
    assert y.shape == (2, S, 4, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)
    if S > chunk or S % chunk:
        with pytest.raises(AssertionError):
            jax_ssd_ops.ssd(*jargs, chunk=chunk, interpret=True)
    assert ssd_ops.ssd.launches == before            # the CPU launches nothing


def test_ssd_kernel_is_built_and_refuses_cpu_tensors(tmp_path, monkeypatch):
    """``csrc/ssd_scan.cu`` is one of the sources the build compiles, an
    edit of it changes the build stamp, and its launcher takes CUDA tensors
    only: a CPU tensor reaches the plain version through ``ops``, never the
    kernel."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel

    assert _build.CSRC / "ssd_scan.cu" in _build._sources()
    assert "repro_ssd_scan" in _build.SIGNATURES
    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._stamp(_build._sources())
    with open(tmp_path / "ssd_scan.cu", "a") as f:
        f.write("// edited\n")
    assert _build._stamp(_build._sources()) != before
    x = torch.zeros(1, 4, 32, 32)
    dt = torch.zeros(1, 4, 32)
    bc = torch.zeros(1, 1, 32, 16)
    with pytest.raises(ValueError, match="cpu"):
        ssd_scan_kernel(x, dt, dt, bc, bc, chunk=32)


# ---------------------------------------------------------------------------
# the CUDA kernel's bf16 route, pass by pass in plain torch
# ---------------------------------------------------------------------------

# (B, S, nh, hd, G, N, chunk, dt_range)
PASSES_CASES = {
    "G=1, 4 chunks": (2, 128, 4, 32, 1, 16, 32, None),
    "G=2, rep 4": (1, 192, 8, 16, 2, 8, 64, None),
    "ragged S=120": (2, 120, 4, 32, 1, 16, 32, None),
    "S=24 < chunk": (2, 24, 4, 32, 1, 16, 32, None),
    "one chunk": (2, 96, 2, 32, 1, 16, 96, None),
    "slow decay": (2, 128, 4, 32, 1, 16, 32, (1e-3, 1e-1)),
    "slow decay, ragged, G=2": (1, 100, 4, 32, 2, 16, 32, (1e-3, 1e-1)),
}


@pytest.mark.parametrize("case", list(PASSES_CASES))
def test_ssd_passes_ref_matches_jax(case):
    """``ref.ssd_passes_ref`` (cum, C·Bᵀ per group, chunk states, passing,
    chunk scan) at f32 against JAX's ``ssd_chunked`` and the port's (1e-5:
    the same sums in another order), JAX's ``ssd_naive`` and, where S
    divides by the chunk (or is below it), the Pallas kernel in interpret
    mode (1e-4, the oracles' tolerance)."""
    B, S, nh, hd, G, N, chunk, dt_range = PASSES_CASES[case]
    x, dt, A, Bm, Cm = _scan_inputs(5, B, S, nh, hd, G, N, dt_range=dt_range)
    y, st = ssd_passes_ref(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=chunk)
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jst = jax_ssm.ssd_chunked(*jargs, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)
    ty, tst = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                              chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), ty.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), tst.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_ssd_naive(*jargs)),
                               **ORACLE_TOL)
    L = min(chunk, S)
    if S % L == 0:
        py, pst = jax_ssd_ops.ssd(*jargs, chunk=L, return_state=True,
                                  interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(py), **ORACLE_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(pst), **ORACLE_TOL)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _bf16_inputs(case, seed=6):
    B, S, nh, hd, G, N, chunk, dt_range = PASSES_CASES[case]
    x, dt, A, Bm, Cm = _scan_inputs(seed, B, S, nh, hd, G, N,
                                    dt_range=dt_range)
    bf = torch.bfloat16
    return (_t(x).to(bf), _t(dt), _t(A), _t(Bm).to(bf), _t(Cm).to(bf)), chunk


@pytest.mark.parametrize("case", list(PASSES_CASES))
def test_ssd_passes_bf16_rounding_stays_within_phase3_tolerances(case):
    """The kernel's bf16 rounding points modelled (C·Bᵀ, the scaled scores
    and the entering state rounded to bf16, the state update's weighted
    operand split into bf16 hi + lo, y rounded once), on bf16 inputs,
    against ``ssd_chunked`` on the same inputs (what ``chip_smoke.py``
    phase 3 holds the kernel to): y within 2e-2 and the final state within
    1e-4 of the plain version's largest magnitude, the slow-decay cases
    included."""
    args, chunk = _bf16_inputs(case)
    y, st = ssd_passes_ref(*args, chunk=chunk, bf16_points=True)
    want_y, want_st = ssm.ssd_chunked(*args, chunk=chunk, return_state=True)
    assert y.dtype == torch.bfloat16 and y.shape == want_y.shape
    assert _rel(y, want_y) <= 2e-2
    assert _rel(st, want_st) <= 1e-4


@pytest.mark.parametrize("case", ["G=1, 4 chunks", "slow decay",
                                  "slow decay, ragged, G=2"])
def test_ssd_state_update_needs_the_hi_lo_split(case):
    """The design's reason for the hi + lo pair: the state update's weighted
    operand rounded to bf16 once misses the state's 1e-4 tolerance."""
    args, chunk = _bf16_inputs(case)
    _, st = ssd_passes_ref(*args, chunk=chunk, bf16_points=True,
                           split_state=False)
    _, want_st = ssm.ssd_chunked(*args, chunk=chunk, return_state=True)
    assert _rel(st, want_st) > 1e-4


class _OnCard:
    """A CPU tensor that the kernel's input checks take for a card tensor:
    only ``.device`` differs (strides, dtype and ``data_ptr`` are real)."""

    def __init__(self, t):
        self._t = t

    def __getattr__(self, k):
        return getattr(self._t, k)

    @property
    def device(self):
        return torch.device("cuda", 0)


def _model_layout(B=2, S=64, nh=4, hd=32, G=1, N=16, dtype=torch.bfloat16,
                  offset=0):
    """x, dt, A, Bm, Cm as the SSM block hands them to ``ops.ssd``: views of
    one conv output ``xBC`` (B, S, nh hd + 2 G N), ``offset`` elements into
    its storage."""
    d_in, gn = nh * hd, G * N
    buf = torch.zeros(offset + B * S * (d_in + 2 * gn), dtype=dtype)
    xbc = buf[offset:].view(B, S, d_in + 2 * gn)
    x = xbc[..., :d_in].reshape(B, S, nh, hd)
    Bm = xbc[..., d_in:d_in + gn].reshape(B, S, G, N)
    Cm = xbc[..., d_in + gn:].reshape(B, S, G, N)
    return x, torch.zeros(B, S, nh), torch.zeros(nh), Bm, Cm


def _check(args, chunk=32):
    from repro_torch.kernels.ssd_scan.kernel import check_inputs

    check_inputs(*(_OnCard(a) for a in args), chunk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,N,G", [(32, 16, 1), (64, 128, 1), (32, 128, 2)])
def test_ssd_kernel_takes_the_model_layout_views(dtype, hd, N, G):
    """The SSM block's views of ``xBC`` (row stride the conv width) pass the
    kernel's checks as they are: the wrapper makes no copy of them."""
    x, dt, A, Bm, Cm = _model_layout(hd=hd, N=N, G=G, nh=4, dtype=dtype)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _check((x, dt, A, Bm, Cm))


@pytest.mark.parametrize("bad,match", [
    ("x last stride 2", "strides"),
    ("x heads interleaved", "strides"),
    ("dt head-major", "strides"),
    ("Bm last stride 2", "strides"),
    ("bf16 view off the 16-byte boundary", "16-byte"),
    ("A (nh, 2)[:, 0]", "contiguous"),
])
def test_ssd_kernel_refuses_strides_it_cannot_read(bad, match):
    """A view the kernel cannot read raises before any build: a non-unit
    last stride, inner strides other than (hd, 1) / (N, 1) / (1,), a bf16
    row off the 16-byte boundary the passes' copies need, a strided A."""
    x, dt, A, Bm, Cm = _model_layout()
    if bad == "x last stride 2":
        x = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)[..., ::2]
    elif bad == "x heads interleaved":
        x = torch.zeros(2, 64, 32, 4, dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "dt head-major":
        dt = torch.zeros(2, 4, 64).transpose(1, 2)
    elif bad == "Bm last stride 2":
        Bm = torch.zeros(2, 64, 1, 32, dtype=torch.bfloat16)[..., ::2]
    elif bad == "bf16 view off the 16-byte boundary":
        x, dt, A, Bm, Cm = _model_layout(offset=1)
    else:
        A = torch.zeros(4, 2)[:, 0]
    with pytest.raises(ValueError, match=match):
        _check((x, dt, A, Bm, Cm))


def test_ssd_f32_route_takes_a_view_off_the_16_byte_boundary():
    """The f32 kernel reads element by element: an f32 view one element off
    the boundary is taken, and the routes follow the dtype."""
    from repro_torch.kernels.ssd_scan.kernel import ROUTES, ssd_route

    _check(_model_layout(dtype=torch.float32, offset=1))
    assert ssd_route(torch.bfloat16) == "passes"
    assert ssd_route(torch.float32) == "f32"
    assert set(ssd_ops.ssd.route_calls) == set(ROUTES)


def test_ssd_passes_workspace_shapes():
    """The passes' scratch at the Mamba-2 path's admission shape: C·Bᵀ once
    per (batch, group, chunk), 4.2 MB; the chunk states 33.5 MB f32 and the
    entering states 16.8 MB bf16.  C·Bᵀ is kept in whole 64 x 64 tiles."""
    from repro_torch.kernels.ssd_scan.kernel import workspace_shapes

    ws = {name: (shape, dtype) for name, shape, dtype in
          workspace_shapes(8, 1024, 32, 64, 1, 128, 256)}
    assert ws["cb"] == ((8, 4, 256, 256), torch.bfloat16)
    assert ws["states"] == ((8, 4, 32, 64, 128), torch.float32)
    assert ws["state_in"] == ((8, 4, 32, 64, 128), torch.bfloat16)
    assert ws["cum"] == ws["dt"] == ((8, 32, 1024), torch.float32)
    assert workspace_shapes(2, 100, 4, 32, 1, 16, 100)[2][1] == (2, 1, 128, 128)
    assert workspace_shapes(4, 96, 8, 32, 1, 16, 32)[2][1] == (4, 3, 64, 64)


# ---------------------------------------------------------------------------
# layers and the SSM block
# ---------------------------------------------------------------------------


def test_gated_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    gate = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    got = layers.gated_rmsnorm({"scale": _t(scale)}, _t(x), _t(gate), eps=1e-5)
    want = jax_layers.gated_rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x), jnp.asarray(gate), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_causal_conv_and_step_match_jax():
    rng = np.random.default_rng(4)
    B, S, C, K = 2, 16, 24, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) * 0.3).astype(np.float32)
    full = ssm.causal_conv(_t(x), _t(w))
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jax_ssm.causal_conv(jnp.asarray(x),
                                                     jnp.asarray(w))),
        **LAYER_TOL)
    state = torch.zeros((B, K - 1, C))
    jstate = jnp.zeros((B, K - 1, C))
    for t in range(S):
        y, state = ssm.causal_conv_step(_t(x[:, t]), state, _t(w))
        jy, jstate = jax_ssm.causal_conv_step(jnp.asarray(x[:, t]), jstate,
                                              jnp.asarray(w))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(), **LAYER_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **LAYER_TOL)


def _block(models, b=0):
    jp, params = models
    jlp = jax.tree.map(lambda a: a[b], jp["blocks"][0])["ssm"]
    lp = {k: (v[b] if isinstance(v, torch.Tensor) else {kk: vv[b] for kk, vv in
                                                        v.items()})
          for k, v in params["blocks"][0]["ssm"].items()}
    return jlp, lp


@pytest.mark.parametrize("S", [33, 64])
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"), ("cuda", "xla"),
                                        ("naive", "xla")])
def test_ssm_forward_and_decode_match_jax(models, impl, jimpl, S):
    """``ssm_forward(return_state=True)`` then three ``ssm_decode`` steps,
    outputs and states against JAX; S = 33 leaves a ragged chunk."""
    jcfg, cfg = _configs()
    jlp, lp = _block(models)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, S + 3, cfg.d_model)) * 0.5).astype(np.float32)
    out, st = ssm.ssm_forward(lp, _t(x[:, :S]), cfg, impl=impl,
                              return_state=True)
    jout, jst = jax_ssm.ssm_forward(jlp, jnp.asarray(x[:, :S]), jcfg,
                                    impl=jimpl, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MODEL_TOL)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                               **MODEL_TOL)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm), **MODEL_TOL)
    st = ssm.SSMState(st.conv.clone(), st.ssm.clone())
    for t in range(S, S + 3):
        y, st2 = ssm.ssm_decode(lp, _t(x[:, t:t + 1]), st, cfg)
        assert st2 is st                             # updated in place
        jy, jst = jax_ssm.ssm_decode(jlp, jnp.asarray(x[:, t:t + 1]), jst,
                                     jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
        np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm),
                                   **MODEL_TOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   **MODEL_TOL)


def test_decode_continues_prefill(models):
    """``ssm_decode`` of token S+1 after ``ssm_forward`` over S equals the
    last output of ``ssm_forward`` over S+1 (tests/test_ssm_moe.py's check
    in JAX, here at f32 and 1e-4)."""
    _, cfg = _configs()
    _, lp = _block(models, 1)
    rng = np.random.default_rng(6)
    x = _t((rng.standard_normal((2, 41, cfg.d_model)) * 0.5).astype(np.float32))
    full = ssm.ssm_forward(lp, x, cfg, impl="torch")
    _, st = ssm.ssm_forward(lp, x[:, :-1], cfg, impl="torch",
                            return_state=True)
    y, _ = ssm.ssm_decode(lp, x[:, -1:], st, cfg)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, -1].numpy(),
                               **MODEL_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefill_and_decode_match_jax(models, impl, jimpl, S):
    """Logits within 1e-4 and greedy tokens equal over a prefill and four
    decode steps, on both routes; the Pallas route only where S is a
    multiple of the chunk (32), as the reference asserts."""
    if jimpl == "pallas" and S % 32:
        jimpl = "xla"
    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab, size=(3, S)).astype(np.int32)
    logits, caches = prefill(params, _t(toks), cfg, max_len=S + 8, impl=impl)
    jlogits, jcaches = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=S + 8,
                                   impl=jimpl)
    assert not caches.kv and set(caches.ssm) == set(jcaches.ssm) == {"0"}
    for step in range(5):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1), np.int32)
        assert (torch.argmax(logits[:, :cfg.vocab], -1).numpy() == tok).all()
        for a, b in zip(caches.ssm["0"], jcaches.ssm["0"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
        if step == 4:
            break
        cur = np.full((3,), S + step, np.int32)
        logits, caches = decode_step(params, _t(tok), caches, _t(cur), cfg,
                                     impl=impl)
        jlogits, jcaches = jax_decode_step(jp, jnp.asarray(tok), jcaches,
                                           jnp.asarray(cur), jcfg, impl=jimpl)


@pytest.fixture(scope="module")
def slow_models():
    """The reduced model with each SSM layer's dt_bias and A_log set as
    Mamba-2 initialises them (dt log-uniform over [1e-3, 1e-1], A uniform
    over [1, 16]), where the shared init (A = -1, dt_bias = 0) forgets the
    state within a few tokens."""
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    ssm_p = dict(jp["blocks"][0]["ssm"])
    shape = ssm_p["dt_bias"].shape
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
    ssm_p["dt_bias"] = jnp.asarray(dt + np.log(-np.expm1(-dt)), jnp.float32)
    ssm_p["A_log"] = jnp.asarray(np.log(rng.uniform(1, 16, size=shape)),
                                 jnp.float32)
    jp = dict(jp, blocks=[dict(jp["blocks"][0], ssm=ssm_p)])
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_prefill_and_decode_carry_the_state_as_jax(slow_models, impl, jimpl):
    """As ``test_prefill_and_decode_match_jax`` over three chunks of 32,
    with Mamba-2's dt and A init, so the logits depend on the state carried
    across chunks."""
    jp, params = slow_models
    jcfg, cfg = _configs()
    S = 96
    toks = np.random.default_rng(9).integers(1, cfg.vocab, size=(2, S))
    toks = toks.astype(np.int32)
    logits, caches = prefill(params, _t(toks), cfg, max_len=S + 4, impl=impl)
    jlogits, jcaches = jax_prefill(jp, jnp.asarray(toks), jcfg,
                                   max_len=S + 4, impl=jimpl)
    for step in range(3):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1), np.int32)
        assert (torch.argmax(logits[:, :cfg.vocab], -1).numpy() == tok).all()
        if step == 2:
            break
        cur = np.full((2,), S + step, np.int32)
        logits, caches = decode_step(params, _t(tok), caches, _t(cur), cfg,
                                     impl=impl)
        jlogits, jcaches = jax_decode_step(jp, jnp.asarray(tok), jcaches,
                                           jnp.asarray(cur), jcfg, impl=jimpl)


def test_generate_matches_jax(models):
    from repro.serving import generate as jax_generate

    jp, params = models
    jcfg, cfg = _configs()
    prompts = np.random.default_rng(8).integers(1, cfg.vocab, size=(2, 20))
    prompts = prompts.astype(np.int32)
    got = generate(params, cfg, prompts, n_new=11, device="cpu")
    want = jax_generate(jp, jcfg, jnp.asarray(prompts), n_new=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_caches_and_bytes_match_jax():
    """``init_caches`` holds one stacked SSMState per period position with
    the reference's shapes and dtypes, and ``kv_cache_bytes`` counts them
    as the reference does."""
    from repro.models import init_caches as jax_init_caches

    jcfg, cfg = _configs("bfloat16")
    caches = init_caches(cfg, 3, 40, device="cpu")
    jcaches = jax_init_caches(jcfg, 3, 40)
    assert not caches.kv
    for a, b in zip(caches.ssm["0"], jcaches.ssm["0"]):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert kv_cache.kv_cache_bytes(cfg, 3, 40) == \
        jax_kv_cache.kv_cache_bytes(jcfg, 3, 40) == \
        kv_cache.tree_bytes(caches)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    """A mamba2 tree crosses both ways bit for bit: its bf16 or f32
    projections and its f32 ``A_log``, ``D`` and ``dt_bias``; the port's
    own ``init_params`` makes the same tree, shapes and dtypes."""
    jcfg, cfg = _configs(dtype)
    host = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(2)))
    ours = params_from_jax(host, device="cpu")
    blk = ours["blocks"][0]["ssm"]
    assert blk["wz"].dtype == getattr(torch, dtype)
    assert blk["A_log"].dtype == blk["D"].dtype == torch.float32
    flat_a, tree_a = jax.tree_util.tree_flatten(host)
    flat_b, tree_b = jax.tree_util.tree_flatten(params_to_jax(ours))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    flat_c, tree_c = jax.tree_util.tree_flatten(init_params(cfg, 0,
                                                            device="cpu"))
    assert tree_c == tree_a
    for a, c in zip(flat_a, flat_c):
        assert tuple(a.shape) == tuple(c.shape)
        assert str(a.dtype) == str(c.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# the continuous batcher
# ---------------------------------------------------------------------------


PROMPTS = [np.random.default_rng(3 + i).integers(1, 512, size=1 + 7 * i % 32)
           .astype(np.int32) for i in range(9)]


def _serve(make, Req, config_cls, params, cfg, eos_map, impl, **extra):
    """Nine requests on four slots (prompt lengths 1-29, left-padded to
    32), ``max_new`` 6-10, chunks of 8."""
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
    jp, _ = models
    jcfg, _ = _configs()
    _, probe = _serve(JaxBatcher, JaxRequest, JaxServingConfig, jp, jcfg, {},
                      "xla")
    return {i: _mid_chunk_eos(probe[i].out) for i in (0, 5)}


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_batcher_matches_jax(models, eos_map, impl, jimpl, overlap):
    """Dense mode on reduced mamba2: ragged prompts left-padded to 32, more
    requests than slots, an EOS that fires mid-chunk; the tokens and every
    ``BatcherStats`` counter equal the JAX batcher's.  With ``overlap=True``
    both packages serve (admission behind the in-flight chunk)."""
    jp, params = models
    jcfg, cfg = _configs()
    jb, want = _serve(JaxBatcher, JaxRequest, JaxServingConfig, jp, jcfg,
                      eos_map, jimpl, overlap=overlap)
    b, got = _serve(_port, Request, ServingConfig, params, cfg, eos_map, impl,
                    overlap=overlap)
    for i in (0, 5):
        assert want[i].out[-1] == eos_map[i] and len(want[i].out) < 6 + i % 5
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert b.stats.as_dict() == {**jb.stats.as_dict(),
                                 **dict.fromkeys(PORT_STATS_FIELDS, 0)}
    assert (b.stats.overlap_rounds > 0) == overlap
    s = b.stats
    assert s.dispatches == s.host_syncs == s.prefills + s.chunks


@pytest.mark.parametrize("mode,match", [
    ("paged", "paged mode needs at least one attn layer"),
    ("prefix", "prefix caching requires a pure-attention"),
    ("speculative", "speculative decode requires a pure-attention"),
])
def test_unsupported_modes_refuse_as_jax(models, mode, match):
    jp, params = models
    jcfg, cfg = _configs()
    kw = {"paged": dict(paged=True, page_size=8),
          "prefix": dict(paged=True, page_size=8, prefix_cache=True),
          "speculative": dict(speculative=True)}[mode]
    for make, config_cls, p, c, impl in (
            (JaxBatcher, JaxServingConfig, jp, jcfg, "xla"),
            (_port, ServingConfig, params, cfg, "torch")):
        with pytest.raises(ValueError, match=match):
            make(p, c, config_cls(slots=2, prompt_len=8, max_len=16,
                                  attn_impl=impl, **kw))


def test_prefix_prefill_and_prefill_kv_refuse_ssm(models):
    from repro_torch.models import prefix_prefill, verify_step
    from repro_torch.models.transformer import prefill_kv

    _, params = models
    _, cfg = _configs()
    toks = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="pure-attention"):
        prefix_prefill(params, toks, {}, cfg, prefix_len=4)
    with pytest.raises(ValueError, match="SSM"):
        prefill_kv(params, toks, cfg)
    with pytest.raises(ValueError, match="pure-attention"):
        verify_step(params, toks, init_caches(cfg, 1, 16, device="cpu"),
                    torch.zeros(1, dtype=torch.int32), cfg)


def test_serve_launcher_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--reduced", "--tenants", "1",
                       "--requests", "5", "--max-new", "4", "--prompt-len",
                       "12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=mamba2-370m-reduced" in out and "completed=5/5" in out
