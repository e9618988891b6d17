"""bf16 drift over full depth: qwen3-0.6b's 28 layers at reduced width, in
both packages, each held against its own f32 run on the same weights.

The decode cell's bf16 routes sit 3.5-3.9 % of the largest logit from
f32 on the card (PERF.md §6, PR 25), and the reduced cells hold bf16
parity with the reference over 2 layers only.  Here both packages get the
same bf16 weights (the reference's f32 init rounded to bf16) and the same
prompt; their f32 runs take those weights cast back to f32, so each
distance is its own arithmetic's rounding alone: the largest difference
of the logits of a prefill and of one serve step, over the largest f32
logit.

Tolerances: each distance at most 4 % (about 28 layers of 2^-8
roundings); the port's, on the plain route and on the kernels' route (the
kernels' plain versions on the CPU), at most 1.5 times the reference's.
The two packages round differently: XLA keeps a fused elementwise chain in
f32 and rounds at its end, eager PyTorch rounds each op's output to bf16.
Over seeds 0-4 the port's step distance was 0.69-1.35 times the
reference's, the prefill's 0.83-1.40 (ROADMAP.md Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import make_prefill_step as jax_make_prefill_step
from repro.serving.engine import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_reduced
from repro_torch.serving.engine import (
    ServeConfig, make_prefill_step, make_serve_step)
from repro_torch.weights import params_from_jax

ARCH, LAYERS = "qwen3-0.6b", 28
B, S, MAX_LEN = 4, 32, 48
MAX_DRIFT = 4e-2            # of the largest f32 logit
PORT_OVER_REF = 1.5


def _dist(got, want) -> float:
    finite = np.isfinite(want)
    return float(np.abs(got[finite] - want[finite]).max()
                 / np.abs(want[finite]).max())


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's prefill and serve step, jitted once for both
    dtypes."""
    base = dataclasses.replace(jax_reduced(ARCH), n_layers=LAYERS)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dt)
        scfg = JaxServeConfig(max_len=MAX_LEN)
        out[dt] = (cfg, jax.jit(jax_make_prefill_step(cfg, scfg)),
                   jax.jit(jax_make_serve_step(cfg, scfg)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_drift_over_28_layers_is_the_references(jax_steps, seed):
    base = dataclasses.replace(jax_reduced(ARCH), n_layers=LAYERS,
                               dtype="float32")
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                        jax_init_params(base, jax.random.PRNGKey(seed)))
    weights = {"bfloat16": bf16,
               "float32": jax.tree.map(lambda x: x.astype(jnp.float32), bf16)}
    toks = np.random.default_rng(seed).integers(0, base.vocab, (B, S),
                                                dtype=np.int32)
    cur = np.full((B,), S, np.int32)
    logits, first = {}, None
    for dt in ("float32", "bfloat16"):
        cfg, pre, step = jax_steps[dt]
        l0, caches = pre(weights[dt], {"tokens": jnp.asarray(toks)})
        if first is None:       # both dtypes decode the f32 run's token
            first = np.array(jnp.argmax(l0[..., :cfg.vocab], -1), np.int32)
        _, l1, _ = step(weights[dt], jnp.asarray(first), caches,
                        jnp.asarray(cur), jax.random.PRNGKey(1))
        logits[("reference", dt)] = (np.asarray(l0, np.float32),
                                     np.asarray(l1, np.float32))
        for impl in ("torch", "cuda"):
            pcfg = dataclasses.replace(get_reduced(ARCH), n_layers=LAYERS,
                                       dtype=dt)
            params = params_from_jax(jax.device_get(weights[dt]), device="cpu")
            scfg = ServeConfig(max_len=MAX_LEN, attn_impl=impl)
            with torch.no_grad():
                p0, pc = make_prefill_step(pcfg, scfg)(
                    params, {"tokens": torch.from_numpy(toks)})
                _, p1, _ = make_serve_step(pcfg, scfg)(
                    params, torch.from_numpy(first), pc, torch.from_numpy(cur))
            logits[(impl, dt)] = (p0.float().numpy(), p1.float().numpy())
    for i, what in enumerate(("prefill", "step")):
        ref = _dist(logits[("reference", "bfloat16")][i],
                    logits[("reference", "float32")][i])
        assert ref <= MAX_DRIFT, (what, ref)
        for impl in ("torch", "cuda"):
            port = _dist(logits[(impl, "bfloat16")][i],
                         logits[(impl, "float32")][i])
            assert port <= MAX_DRIFT, (what, impl, port)
            assert port <= PORT_OVER_REF * ref, (what, impl, port, ref)
        # the two packages agree at f32 on the same weights
        for impl in ("torch", "cuda"):
            assert _dist(logits[(impl, "float32")][i],
                         logits[("reference", "float32")][i]) < 1e-5
