"""The training path's small pieces against the JAX package on the CPU: LR
schedules, global-norm clipping, int8 block quantization with error
feedback, the synthetic data pipeline (byte for byte), and the training
launcher's preempt-and-resume.

Inputs are made with numpy from a seed.  Schedules, clipping and
quantization compare f32 values computed in the same order: tolerance 1e-6
relative (the libraries' cos and pow may differ in the last bit); an int8
code may differ by one step where a value lies within rounding of a
half-way point, which the test counts and bounds.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data import synthetic as jax_synthetic
from repro.distributed import compression as jax_comp
from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_sched
from repro_torch.configs import get_reduced
from repro_torch.data import synthetic
from repro_torch.distributed import compression
from repro_torch.optim import adamw, schedules
from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

FAMILY_ARCHS = ["qwen3-0.6b", "mamba2-370m", "deepseek-moe-16b",
                "qwen2-vl-72b", "whisper-base", "jamba-1.5-large-398b"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_linear", (1e-3, 10, 50)),
    ("warmup_cosine", (1e-3, 10, 50)),
    ("warmup_cosine", (3e-4, 0, 7)),
])
def test_schedule_matches_jax(name, args):
    f = schedules.SCHEDULES[name](*args)
    g = jax_sched.SCHEDULES[name](*args)
    for step in range(0, 60, 3):
        got = f(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.float32(g(jnp.int32(step)))
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
        assert float(f(step)) == float(got)          # an int step too


# ---------------------------------------------------------------------------
# clipping and the global norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal((7, 5)).astype(np.float32)],
            "a": {"w": rng.standard_normal(33).astype(np.float32)}}
    got, norm = adamw.clip_by_global_norm(
        {"b": [_t(tree["b"][0])], "a": {"w": _t(tree["a"]["w"])}}, max_norm)
    want, jnorm = jax_adamw.clip_by_global_norm(
        {"b": [jnp.asarray(tree["b"][0])], "a": {"w": jnp.asarray(tree["a"]["w"])}},
        max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["a"]["w"].numpy(), np.asarray(want["a"]["w"]),
                               rtol=1e-6, atol=1e-7)
    if max_norm < float(norm):
        assert float(adamw.global_norm(got)) == pytest.approx(max_norm, rel=1e-5)


# ---------------------------------------------------------------------------
# int8 block quantization and error feedback
# ---------------------------------------------------------------------------


def _codes_agree(got, want):
    """int8 codes equal, or one step apart at no more than 1 in 1000."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((3, 7, 40), 256),
                                         ((64, 64), 128), ((5,), 256)])
def test_quantize_int8_matches_jax(shape, block):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(np.float32)
    q, s = compression.quantize_int8(_t(x), block=block)
    jq, js = jax_comp.quantize_int8(jnp.asarray(x), block=block)
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    _codes_agree(q.numpy(), np.asarray(jq))
    deq = compression.dequantize_int8(q, s, shape, block=block)
    jdeq = jax_comp.dequantize_int8(jq, js, shape, block=block)
    assert tuple(deq.shape) == shape
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq),
                               atol=float(np.asarray(js).max()) * 1.0001)
    err = compression.quantization_error(_t(x), block=block).numpy()
    assert np.abs(err).max() <= float(np.asarray(js).max()) * 0.5001


def test_compress_with_feedback_matches_jax_over_steps():
    """The residual carried over 5 steps of the same gradient stays the
    reference's, and the running mean of the dequantized wire converges on
    the gradient (error feedback removes the bias)."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((300,)).astype(np.float32) * 1e-3
    e = compression.init_error_feedback({"g": _t(g)})["g"]
    assert e.dtype == torch.float32 and float(e.abs().max()) == 0.0
    je = jnp.zeros((300,), jnp.float32)
    sent = np.zeros_like(g)
    for step in range(5):
        q, s, e = compression.compress_with_feedback(_t(g), e)
        jq, js, je = jax_comp.compress_with_feedback(jnp.asarray(g), je)
        _codes_agree(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-9)
        sent += compression.dequantize_int8(q, s, g.shape).numpy()
    assert np.abs(sent / 5 - g).max() < np.abs(g).max() / 127


# ---------------------------------------------------------------------------
# the synthetic data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_make_batch_is_byte_equal(arch, n_hosts):
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    for step in (0, 7):
        for host in range(n_hosts):
            got = synthetic.make_batch(cfg, seq_len=24, batch=8, step=step,
                                       seed=3, host=host, n_hosts=n_hosts,
                                       reduced=True)
            want = jax_synthetic.make_batch(jcfg, seq_len=24, batch=8,
                                            step=step, seed=3, host=host,
                                            n_hosts=n_hosts, reduced=True)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                assert got[k].tobytes() == want[k].tobytes(), k
    got = synthetic.global_batch(cfg, seq_len=24, batch=8, step=1,
                                 n_hosts=n_hosts, reduced=True)
    want = jax_synthetic.global_batch(jcfg, seq_len=24, batch=8, step=1,
                                      n_hosts=n_hosts, reduced=True)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_make_batch_full_vlm_patches_is_byte_equal():
    """The unreduced VLM stub: 256 patches on a 16 x 16 grid."""
    cfg = dataclasses.replace(get_reduced("qwen2-vl-72b"), d_model=16)
    jcfg = dataclasses.replace(jax_reduced("qwen2-vl-72b"), d_model=16)
    got = synthetic.make_batch(cfg, seq_len=300, batch=2, step=0)
    want = jax_synthetic.make_batch(jcfg, seq_len=300, batch=2, step=0)
    assert got["positions"].shape == (3, 2, 300)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# the training launcher
# ---------------------------------------------------------------------------


def _final_loss(out: str) -> float:
    return float(re.search(r"final loss ([0-9.]+)", out).group(1))


def test_launcher_preempts_and_resumes_to_the_uninterrupted_loss(tmp_path, capsys):
    """--die-at-step exits 42 after its checkpoint; a second run restores it
    and ends on the uninterrupted run's final loss (the batches are a pure
    function of (seed, step), the restore is bit-exact, the CPU
    deterministic)."""
    from repro_torch.launch import train

    base = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--loss-chunk", "8", "--log-every", "100"]
    assert train.main(base) == 0
    straight = _final_loss(capsys.readouterr().out)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    assert train.main(base + ck + ["--die-at-step", "3"]) == 42
    out = capsys.readouterr().out
    assert "simulated preemption at step 3" in out
    assert train.main(base + ck) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    assert _final_loss(out) == straight
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_launcher_defaults_to_the_card():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
