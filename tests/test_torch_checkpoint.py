"""The port's checkpoint store against the JAX package's: one on-disk
format, so a checkpoint written by either package restores in the other
bit for bit (bf16 params stored as raw bits with their logical dtype, the
int8 and f32 AdamW moments, the int32 step), and ``AsyncCheckpointer``
snapshots on the caller's thread.  The store and the training path run
without ``ml_dtypes``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import checkpoint as ckpt
from repro_torch.optim import AdamWState, QTensor
from repro_torch.tree import flatten_with_path, tree_map
from repro_torch.weights import opt_state_from_jax, params_from_jax
from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=2)
def _jax_state(quantize: bool):
    """The reference's reduced qwen3-0.6b (bf16) with a stepped AdamW
    state, so no leaf is all zeros (made once a mode; JAX arrays are
    immutable)."""
    cfg = jax_reduced("qwen3-0.6b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    opt = jax_adamw_init(params, quantize=quantize)
    noise = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    from repro.optim import adamw_update

    params, opt = adamw_update(noise, opt, params, lr=1e-3, quantized=quantize)
    return {"params": params, "opt": opt}


def _port_state(jstate):
    host = jax.device_get(jstate)
    return {"params": params_from_jax(host["params"], device="cpu"),
            "opt": opt_state_from_jax(host["opt"], device="cpu")}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_bit_equal(port_tree, jax_tree):
    want = {jax.tree_util.keystr(p): _bits(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jax_tree))[0]}
    got = flatten_with_path(port_tree)
    assert [k for k, _ in got] == list(want)
    for key, t in got:
        w = want[key]
        b = _port_bits(t)
        assert b.dtype == w.dtype and b.shape == w.shape, key
        assert b.tobytes() == w.tobytes(), key


@pytest.mark.parametrize("quantize", [False, True])
def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path, quantize):
    jstate = _jax_state(quantize)
    jax_ckpt.save(str(tmp_path), 7, jstate, metadata={"by": "jax"})
    like = tree_map(torch.empty_like, _port_state(jstate))
    got = ckpt.restore(str(tmp_path), like)
    assert isinstance(got["opt"], AdamWState)
    if quantize:
        assert isinstance(got["opt"].m["embed"]["w"], QTensor)
    _assert_bit_equal(got, jstate)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.read_metadata(str(tmp_path))["metadata"] == {"by": "jax"}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("writer", ["save", "save_async"])
def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path, quantize,
                                                        writer):
    jstate = _jax_state(quantize)
    state = _port_state(jstate)
    if writer == "save":
        ckpt.save(str(tmp_path), 3, state, metadata={"by": "port"})
    else:
        w = ckpt.AsyncCheckpointer(str(tmp_path))
        w.save_async(3, state, metadata={"by": "port"})
        w.wait()
        assert w.last_saved == 3
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
    got = jax_ckpt.restore(str(tmp_path), like)
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(got))[0],
            jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]):
        assert a.dtype == b.dtype and _bits(a).tobytes() == _bits(b).tobytes()
    # the manifest the reference writes for the same tree
    ref_dir = tmp_path / "ref"
    if writer == "save":
        jax_ckpt.save(str(ref_dir), 3, jstate, metadata={"by": "port"})
    else:
        jw = jax_ckpt.AsyncCheckpointer(str(ref_dir))
        jw.save_async(3, jstate, metadata={"by": "port"})
        jw.wait()
    mine = ckpt.read_metadata(str(tmp_path))
    theirs = jax_ckpt.read_metadata(str(ref_dir))
    assert mine == theirs


def test_async_save_snapshots_on_the_callers_thread(tmp_path):
    """A tensor changed in place after ``save_async`` returns does not reach
    the checkpoint; a second save waits for the first."""
    state = {"w": torch.arange(1000, dtype=torch.float32),
             "b": torch.ones(3, dtype=torch.bfloat16)}
    original = tree_map(torch.clone, state)
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    w.save_async(1, state)
    state["w"].add_(5.0)
    state["b"].mul_(2)
    w.save_async(2, state)
    w.wait()
    like = tree_map(torch.empty_like, state)
    for step, want in ((1, original), (2, state)):
        got = ckpt.restore(str(tmp_path), like, step=step)
        assert all(torch.equal(got[k], want[k]) for k in state), step
    w.save_async(3, state)
    w.save_async(4, state)
    w.wait()
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000002", "step_00000003", "step_00000004"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), {"w": state["w"], "x": state["b"]})


def test_restore_casts_to_like(tmp_path):
    state = {"w": torch.linspace(-1, 1, 17, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 1, state)
    got = ckpt.restore(str(tmp_path),
                       {"w": torch.empty(17, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"].to(torch.bfloat16))


def test_store_and_training_run_without_ml_dtypes(tmp_path):
    """With ``ml_dtypes`` made unimportable, a bf16 train step, a save and
    a restore still run, and nothing imports it."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import restore, save\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.data import make_batch\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.optim import adamw_init\n"
        "from repro_torch.training import TrainerConfig, batch_to_torch, "
        "make_train_step\n"
        "from repro_torch.tree import tree_map\n"
        "cfg = get_reduced('qwen3-0.6b')\n"
        "p = init_params(cfg, 0, device='cpu')\n"
        "o = adamw_init(p, quantize=True)\n"
        "b = batch_to_torch(make_batch(cfg, seq_len=16, batch=2, step=0, "
        "reduced=True), 'cpu')\n"
        "p, o, m = make_train_step(cfg, TrainerConfig(loss_chunk=8, "
        "quantize_opt=True, attn_impl='flash'))(p, o, b)\n"
        f"save({str(tmp_path)!r}, 1, {{'params': p, 'opt': o}})\n"
        f"got = restore({str(tmp_path)!r}, tree_map(torch.empty_like, "
        "{'params': p, 'opt': o}))\n"
        "assert torch.equal(got['params']['embed']['w'], p['embed']['w'])\n"
        "assert p['embed']['w'].dtype == torch.bfloat16\n"
        "print('ok', float(m['loss']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
