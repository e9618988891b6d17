"""Shared by the training parity tests (``test_torch_training.py``,
``test_torch_train_families.py``, ``test_torch_train_hybrid.py``): train
steps of the JAX package and of the port from the same weights, optimizer
state and batches.  Its own test holds the map of route names.

Weights and AdamW state are made by the reference and moved across with
``repro_torch.weights``; batches come from the reference's
``make_batch`` (byte-equal to the port's, ``test_torch_train_data.py``).
Everything runs at f32 on the CPU.

Tolerances, stated once: loss, aux and lr within 1e-5 relative (the same
f32 arithmetic, summed in another order); the grad norm within 1e-4
relative; gradients before the update within 1e-4 of each leaf's largest
magnitude; params after the update within rtol 1e-3, atol 1e-4 at lr
3e-4, the reference's own tolerance for two attention routes
(``tests/test_attention.py::TestFlashVJP::test_train_step_with_flash_impl``):
AdamW turns any gradient into an update of about +-lr, so a gradient at
rounding level whose sign parts the two packages parts the params by up to
2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.synthetic import make_batch
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.training.steps import TrainerConfig as JaxTrainerConfig
from repro.training.steps import make_loss_fn as jax_make_loss_fn
from repro.training.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.training import (
    TrainerConfig, batch_to_torch, make_loss_fn, make_train_step,
    value_and_grad)
from repro_torch.tree import flatten_with_path
from repro_torch.weights import opt_state_from_jax, params_from_jax

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after it: their
    tensors are small, and with several test workers on the machine's
    cores each worker's spinning thread pool slowed them many times over.
    Every CPU ``test_torch_*.py`` file imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the port's name for each reference route
JAX_IMPL = {"torch": "xla", "flash": "flash", "naive": "naive"}
LR = 3e-4
METRIC_RTOL = {"loss": 1e-5, "aux": 1e-5, "lr": 1e-5, "grad_norm": 1e-4}


def configs(arch):
    return (dataclasses.replace(get_reduced(arch), dtype="float32"),
            dataclasses.replace(jax_reduced(arch), dtype="float32"))


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf, np.float32)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


def assert_tree_close(got, want_jax, *, rtol, atol, what):
    want = _flat_jax(want_jax)
    flat = flatten_with_path(got)
    assert sorted(k for k, _ in flat) == sorted(want), what
    for key, t in flat:
        np.testing.assert_allclose(t.detach().float().numpy(), want[key],
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {key}")


def assert_grads_close(got, want_jax, tol=1e-4):
    want = _flat_jax(want_jax)
    for key, t in flatten_with_path(got):
        w = want[key]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(t.float().numpy() - w).max()) / scale
        assert err <= tol, f"grad {key}: {err:.3e} of its largest"


def assert_metrics_close(m, jm):
    for k, rtol in METRIC_RTOL.items():
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    assert int(m["tokens"]) == int(jm["tokens"])


def batches(jcfg, n, *, seq=16, batch=4):
    return [make_batch(jcfg, seq_len=seq, batch=batch, step=i, reduced=True)
            for i in range(n)]


def check_train_parity(arch, *, impl="torch", steps=3, grads=True, seq=16,
                       batch=4, **tkw):
    """``steps`` train steps of both packages on batches 0..steps-1:
    metrics after every step, gradients of the first batch before the
    update (``grads``), params after step 1 and step ``steps``.  Returns the
    port's (params, opt, metrics) after the last step."""
    cfg, jcfg = configs(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jo = jax_adamw_init(jp, quantize=tkw.get("quantize_opt", False))
    jt = JaxTrainerConfig(loss_chunk=8, attn_impl=JAX_IMPL[impl], lr=LR, **tkw)
    tt = TrainerConfig(loss_chunk=8, attn_impl=impl, lr=LR, **tkw)
    p = params_from_jax(jax.device_get(jp), device="cpu")
    o = opt_state_from_jax(jax.device_get(jo), device="cpu")
    data = batches(jcfg, steps, seq=seq, batch=batch)
    if grads:
        jgrad = jax.jit(jax.grad(jax_make_loss_fn(jcfg, jt), has_aux=True))
        jg, _ = jgrad(jp, {k: jnp.asarray(v) for k, v in data[0].items()})
        _, g = value_and_grad(make_loss_fn(cfg, tt), p,
                              batch_to_torch(data[0], "cpu"))
        assert_grads_close(g, jg)
    jstep = jax.jit(jax_make_train_step(jcfg, jt))
    step = make_train_step(cfg, tt)
    for i, b in enumerate(data):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, m = step(p, o, batch_to_torch(b, "cpu"))
        assert_metrics_close(m, jm)
        assert int(o.step) == int(jo.step) == i + 1
        if i in (0, steps - 1):
            assert_tree_close(p, jp, rtol=1e-3, atol=1e-4,
                              what=f"{arch} {impl} step {i + 1}")
    return p, o, m


def port_steps(arch, steps=2, *, seq=16, batch=4, **tkw):
    """The port alone: ``steps`` steps from the reference's init, returning
    (params, metrics of each step)."""
    cfg, jcfg = configs(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_jax(jax.device_get(jp), device="cpu")
    from repro_torch.optim import adamw_init

    o = adamw_init(p, quantize=tkw.get("quantize_opt", False))
    step = make_train_step(cfg, TrainerConfig(loss_chunk=8, lr=LR, **tkw))
    ms = []
    for b in batches(jcfg, steps, seq=seq, batch=batch):
        p, o, m = step(p, o, batch_to_torch(b, "cpu"))
        ms.append(m)
    return p, ms


def assert_port_trees_equal(a, b, *, tol=0.0):
    for (ka, ta), (kb, tb) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert ka == kb
        d = float((ta.float() - tb.float()).abs().max())
        assert d <= tol, f"{ka}: {d}"


def test_every_route_the_port_trains_has_its_reference_route():
    """The port's "train" row of ATTN_CAPABILITIES maps onto the
    reference's: "torch" is its "xla"; "cuda" (its "pallas") is absent."""
    from repro.models.attention import ATTN_CAPABILITIES as JAX_CAPS
    from repro_torch.models.attention import ATTN_CAPABILITIES

    assert sorted(ATTN_CAPABILITIES["train"]) == sorted(JAX_IMPL)
    assert all(JAX_IMPL[i] in JAX_CAPS["train"] for i in JAX_IMPL)
    assert "cuda" not in ATTN_CAPABILITIES["train"]
    assert "flash" in ATTN_CAPABILITIES["sliding_window"]
