"""The port's cell matrix (``repro_torch.launch.{mesh,cells}``), its
train-side spec functions and ``make_serve_step`` against the reference's
(``repro.launch.cells``, ``repro.distributed.sharding``,
``repro.optim.opt_state_specs``, ``repro.serving.engine``).

* The spec functions read only a mesh's axis names and sizes, so the
  reference's run on ``jax.sharding.AbstractMesh`` (no 256 devices) and the
  port's on its own mesh descriptions; the trees must be equal leaf for
  leaf, for every arch and both production meshes and the (64, 4) split.
* ``make_serve_step`` against the reference's at f32 on reduced
  qwen3-0.6b and mamba2-370m, from the same prefill: tokens equal, logits
  and caches within 1e-4 (the same f32 arithmetic in another order).
* ``build_cell(reduced=True)`` runs on the CPU with the reference's weights
  (``weights.params_from_jax``) and is held against the reference cell's
  jitted program on a (1, 1) host mesh, on the same inputs.  The reduced
  configs are bf16, as the reference's cells are, so the tolerances are
  bf16's: logits within 3e-2 of the reference's largest magnitude (a few
  roundings of 2^-8 each through two layers), greedy tokens equal where
  the reference's top two logits are further apart than that; the train
  step's loss within 1e-3 and grad norm within 1e-2 relative, params
  after the update within 2 lr + 2^-7 of each leaf's largest magnitude
  (AdamW moves every element by about lr, whose sign a rounding-level
  gradient can flip, and the update is rounded to bf16).  The prefill's
  caches within 3e-2 of each leaf's largest magnitude (or 1), except in the
  MoE archs, where up to 1 % of a leaf's elements may part: a token whose
  top-k experts tie within bf16 rounding takes another expert.  The
  argument bytes of what the program reads equal the compiled reference's
  ``argument_size_in_bytes`` (``jax.jit`` drops unread arguments), and the
  counted dot FLOPs its ``hlo_static`` count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import cells as jax_cells
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.distributed import sharding as jax_sharding
from repro.distributed.hlo_static import analyze_hlo
from repro.launch.cells import build_cell as jax_build_cell
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import KVCacheView as JaxKV
from repro.models.ssm import SSMState as JaxSSM
from repro.models.transformer import Caches as JaxCaches
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import opt_state_specs as jax_opt_state_specs
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import make_serve_step as jax_make_serve_step
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, get_reduced
from repro_torch.distributed import sharding
from repro_torch.launch.cells import (
    abstract_params, argument_bytes_per_device, build_cell)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import prefill
from repro_torch.optim import opt_state_specs
from repro_torch.serving import ServeConfig, make_serve_step
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

REF_ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "mamba2-370m",
             "jamba-1.5-large-398b", "whisper-base", "qwen2-vl-72b")
MESHES = {  # name -> (the reference's AbstractMesh, the port's description)
    "pod16x16": (AbstractMesh((16, 16), ("data", "model")),
                 make_production_mesh()),
    "pod2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                   make_production_mesh(multi_pod=True)),
    "dp64tp4": (AbstractMesh((64, 4), ("data", "model")),
                make_production_mesh(dp_tp=(64, 4))),
}


# ---------------------------------------------------------------------------
# the cell matrix
# ---------------------------------------------------------------------------


def test_forty_cells_and_seven_skips_match_the_reference():
    cs = cells()
    assert ARCHS == list(JAX_ARCHS)
    assert len(cs) == 40
    assert cs == jax_cells()
    skips = {(c["arch"], c["shape"]) for c in cs if not c["runs"]}
    assert skips == {
        (a, "long_500k")
        for a in ("command-r-plus-104b", "qwen3-0.6b", "starcoder2-7b",
                  "qwen3-32b", "deepseek-moe-16b", "qwen2-vl-72b",
                  "whisper-base")}


def test_production_meshes_describe_the_references():
    for name, (ref, port) in MESHES.items():
        assert port.axis_names == tuple(ref.axis_names), name
        assert port.shape == dict(ref.shape), name
        assert port.size == 256 * (2 if "pod2" in name else 1)
        assert port.device is None
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(dp_tp=(8, 16))
    host = make_host_mesh((1, 1), device="cpu")
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh((1, 2), device="cpu")


# ---------------------------------------------------------------------------
# the spec functions against the reference's
# ---------------------------------------------------------------------------


def _jax_specs(tree):
    """[(path, spec tuple)] of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(_key(k) for k in path), tuple(spec))
            for path, spec in flat]


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _port_specs(tree, prefix=""):
    """[(path, spec tuple)] of a port spec tree, in the reference's order."""
    if isinstance(tree, sharding.P):
        return [(prefix, tuple(tree))]
    if tree is None:
        return []
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_specs(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _port_specs(v, join(f))]
    return [x for i, v in enumerate(tree) for x in _port_specs(v, join(i))]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_functions_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, (jmesh, mesh) in MESHES.items():
        for fsdp in (True, False):
            for moe_ep in (True, False):
                got = sharding.param_specs(cfg, mesh, fsdp=fsdp, moe_ep=moe_ep)
                want = jax_sharding.param_specs(jcfg, jmesh, fsdp=fsdp,
                                                moe_ep=moe_ep)
                assert _port_specs(got) == _jax_specs(want), (name, fsdp, moe_ep)
                assert (_port_specs(opt_state_specs(got))
                        == _jax_specs(jax_opt_state_specs(want))), name
        for batch in (1, 4, 32, 128, 256):
            assert (_port_specs(sharding.train_batch_specs(cfg, mesh, batch=batch))
                    == _jax_specs(jax_sharding.train_batch_specs(
                        jcfg, jmesh, batch=batch))), (name, batch)
            assert (_port_specs(sharding.cache_specs(cfg, mesh, batch=batch))
                    == _jax_specs(jax_sharding.cache_specs(
                        jcfg, jmesh, batch=batch))), (name, batch)
            assert (sharding.batch_shard(mesh, batch)
                    == jax_sharding.batch_shard(jmesh, batch))
        assert sharding.data_axes(mesh) == jax_sharding.data_axes(jmesh)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-vl-72b"])
def test_quantized_opt_state_specs_match_the_reference(arch):
    """int8 moments (the cells above 40e9 parameters): each leaf's block
    axis over "data" exactly where the reference puts it."""
    cfg = get_config(arch)
    params = abstract_params(cfg)
    jparams = jax.eval_shape(
        lambda k: jax_init_params(jax_config(arch), k), jax.random.PRNGKey(0))
    for name, (jmesh, mesh) in MESHES.items():
        p_specs = sharding.param_specs(cfg, mesh)
        got = opt_state_specs(p_specs, quantize=True, params=params, mesh=mesh)
        want = jax_opt_state_specs(
            jax_sharding.param_specs(jax_config(arch), jmesh), quantize=True,
            params=jparams, mesh=jmesh)
        assert _port_specs(got) == _jax_specs(want), name
    with pytest.raises(ValueError, match="params="):
        opt_state_specs(p_specs, quantize=True)


# ---------------------------------------------------------------------------
# make_serve_step against the reference's
# ---------------------------------------------------------------------------


def _np(t):
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m"])
def test_serve_step_matches_the_reference(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(jax.device_get(jp), device="cpu")
    B, S, max_len = 3, 12, 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    _, jcaches = jax.jit(lambda p, t: jax_prefill(p, t, jcfg, max_len=max_len))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        _, caches = prefill(params, torch.from_numpy(toks), cfg,
                            max_len=max_len, impl="torch")
    last = toks[:, -1]
    cur = np.full((B,), S, np.int32)
    jstep = jax.jit(jax_make_serve_step(jcfg, JaxServeConfig(max_len=max_len)))
    jn, jl, jc = jstep(jp, jnp.asarray(last), jcaches, jnp.asarray(cur),
                       jax.random.PRNGKey(0))
    step = make_serve_step(cfg, ServeConfig(max_len=max_len, attn_impl="torch"))
    with torch.no_grad():
        n, logits, caches = step(params, torch.from_numpy(last), caches,
                                 torch.from_numpy(cur))
    assert n.dtype == torch.int32 and n.shape == (B,)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    jl = np.asarray(jl)
    assert logits.shape == jl.shape
    finite = np.isfinite(jl)
    assert (np.isfinite(logits.numpy()) == finite).all()   # the vocab mask
    np.testing.assert_allclose(logits.numpy()[finite], jl[finite], atol=1e-4,
                               rtol=0)
    for got, want in zip(leaves(caches), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


# ---------------------------------------------------------------------------
# reduced cells against the reference cell's jitted program
# ---------------------------------------------------------------------------


def _caches_to_jax(c):
    return JaxCaches(
        kv={p: JaxKV(*(jnp.asarray(_np(t)) for t in v)) for p, v in c.kv.items()},
        ssm={p: JaxSSM(*(jnp.asarray(_np(t)) for t in v))
             for p, v in c.ssm.items()},
        cross=None if c.cross is None else {
            p: tuple(jnp.asarray(_np(t)) for t in v) for p, v in c.cross.items()})


def _f32(a):
    return np.asarray(a, np.float32)


def _check_logits(got, want, tol=3e-2):
    """bf16 logits within ``tol`` of the reference's largest magnitude,
    greedy tokens equal where the reference's top two are further apart."""
    got, want = _f32(got), _f32(want)
    ok = np.isfinite(want)
    scale = np.abs(want[ok]).max()
    err = np.abs(got[ok] - want[ok]).max() / scale
    assert err <= tol, err
    masked = np.where(ok, want, -np.inf)
    top2 = np.sort(masked, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return err


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_reduced_cell_matches_the_reference_cell(arch, shape):
    jmesh = jax_host_mesh(shape=(1, 1))
    jcell = jax_build_cell(arch, shape, jmesh, reduced=True)
    with jmesh:
        compiled = jcell.lower().compile()
    cell = build_cell(arch, shape, make_host_mesh((1, 1), device="cpu"),
                      reduced=True)
    assert dataclasses.astuple(cell.shape) == dataclasses.astuple(jcell.shape)
    assert cell.model_flops == jcell.model_flops
    assert cell.donate_argnums == jcell.donate_argnums
    cost = cell.analyze()
    assert (argument_bytes_per_device(cell, cost)
            == compiled.memory_analysis().argument_size_in_bytes)
    # dot FLOPs against the reference's static analysis of the compiled
    # cell (see test_torch_op_static.py for the tolerances)
    assert cost.flops == pytest.approx(
        analyze_hlo(compiled.as_text()).flops,
        rel=0.03 if shape == "train_4k" else 0.02)

    jp = jax_init_params(jcell.cfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jp), device="cpu")
    args = (params,) + tuple(cell.materialize("cpu", seed=1)[1:])
    if shape == "train_4k":
        batch = {k: jnp.asarray(_np(v)) for k, v in args[2].items()}
        with jmesh:
            jparams, _, jm = compiled(jp, jax_adamw_init(jp), batch)
        new_params, _, m = cell.run(*args)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-2)
        lr = cell.tcfg.lr
        for got, want in zip(leaves(new_params), jax.tree.leaves(jparams)):
            want = _f32(want)
            bound = 2 * lr + 2 ** -7 * np.abs(want).max()
            assert np.abs(_f32(got.float()) - want).max() <= bound
    elif shape == "prefill_32k":
        batch = {k: jnp.asarray(_np(v)) for k, v in args[1].items()}
        with jmesh:
            jlogits, jcaches = compiled(jp, batch)
        logits, caches = cell.run(*args)
        _check_logits(logits.float().numpy(), jlogits)
        # a token whose top-k experts tie within bf16 rounding may take
        # another expert in an MoE arch: its later K/V rows part
        share = 0.01 if cell.cfg.moe is not None else 0.0
        for got, want in zip(leaves(caches), jax.tree.leaves(jcaches)):
            want = _f32(want)
            off = (np.abs(_f32(got.float()) - want)
                   > 3e-2 * max(np.abs(want).max(), 1.0))
            assert off.mean() <= share, off.mean()
    else:
        _, tokens, caches, cur_pos, _ = args
        jcaches = _caches_to_jax(caches)
        with jmesh:
            jn, jlogits, _ = compiled(jp, jnp.asarray(tokens.numpy()), jcaches,
                                      jnp.asarray(cur_pos.numpy()),
                                      jax.random.PRNGKey(0))
        # jcaches may alias the port's cache memory, which cell.run updates
        # in place: the reference's asynchronous step must end first
        jax.block_until_ready((jn, jlogits))
        n, logits, _ = cell.run(*args)
        _check_logits(logits.float().numpy(), jlogits)
        assert n.dtype == torch.int32 and n.shape == tuple(jn.shape)
