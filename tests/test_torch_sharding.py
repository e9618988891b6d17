"""The port's tensor-parallel layout (``repro_torch.distributed.sharding``)
against the reference's ``repro.distributed.sharding`` on the CPU, and its
single-controller runtime (``ShardGroup``) on its own.

Spec trees compare with every ``PartitionSpec`` as a tuple; the permuted
weights bit for bit, from one set of JAX weights
(``weights.params_from_jax``); ``check_tp``'s and ``tp_supported``'s
messages word for word for every arch in the catalog.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.distributed import sharding as jsh
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels.common import count_launch
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")


def _plain(tree):
    """A spec tree with every spec a tuple and every NamedTuple a
    (type name, fields) pair, so both packages' trees compare."""
    if isinstance(tree, (PartitionSpec, tsh.P)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,
                {f: _plain(getattr(tree, f)) for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _configs(arch="qwen3-0.6b", **kw):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **kw)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **kw)
    return jcfg, cfg


def _shardable():
    return [a for a in JAX_ARCHS if jsh.tp_supported(jax_config(a)) is None]


@pytest.mark.parametrize("arch", _shardable())
def test_param_specs_equal_reference(arch):
    jcfg, cfg = _configs(arch)
    assert _plain(tsh.tp_param_specs(cfg)) == _plain(jsh.tp_param_specs(jcfg))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_specs_equal_reference(paged):
    jcfg, cfg = _configs()
    assert _plain(tsh.tp_cache_specs(cfg, paged=paged)) == \
        _plain(jsh.tp_cache_specs(jcfg, paged=paged))


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_tp_supported_and_check_tp_match_reference(arch):
    """Every arch, full and reduced, at every width up to 16 (the
    non-dividing ones included): the same reason, the same message."""
    for jcfg, cfg in ((jax_config(arch), get_config(arch)),
                      (jax_reduced(arch), get_reduced(arch))):
        assert tsh.tp_supported(cfg) == jsh.tp_supported(jcfg)
        for tp in range(1, 17):
            msgs = []
            for check, c in ((jsh.check_tp, jcfg), (tsh.check_tp, cfg)):
                try:
                    check(c, tp)
                    msgs.append(None)
                except ValueError as e:
                    msgs.append(str(e))
            assert msgs[0] == msgs[1], (arch, tp, msgs)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_cfg_fields_match_reference(tp):
    jcfg, cfg = _configs(n_kv_heads=4)
    jl, tl = jsh.tp_local_cfg(jcfg, tp), tsh.tp_local_cfg(cfg, tp)
    shared = ({f.name for f in dataclasses.fields(jl)}
              & {f.name for f in dataclasses.fields(tl)})
    assert {"n_heads", "n_kv_heads", "d_ff", "d_head"} <= shared
    for name in sorted(shared):
        assert getattr(tl, name) == getattr(jl, name), name
    assert (tl.q_dim, tl.kv_dim) == (jl.q_dim, jl.kv_dim)
    assert tsh.tp_local_cfg(cfg, 1) is cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _configs(n_kv_heads=4)
    jp = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_jax(jp, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("tp", [2, 4])
def test_permuted_params_equal_reference_bit_for_bit(weights, tp):
    jcfg, cfg, jp, params = weights
    want = dict(_leaves(jsh.permute_params_for_tp(jp, jcfg, tp)))
    got = dict(_leaves(tsh.permute_params_for_tp(params, cfg, tp)))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        assert np.array_equal(got[name], arr), name
    # only swiglu's wi moved: every other leaf is the input's tensor
    permuted = tsh.permute_params_for_tp(params, cfg, tp)
    block, old = permuted["blocks"][0], params["blocks"][0]
    assert permuted["embed"]["w"] is params["embed"]["w"]
    assert block["attn"]["wq"] is old["attn"]["wq"]
    assert block["mlp"]["wi"] is not old["mlp"]["wi"]


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_concatenate_to_the_permuted_tree(weights, tp):
    _, cfg, _, params = weights
    full = tsh.permute_params_for_tp(params, cfg, tp)
    specs = tsh.tp_param_specs(cfg)
    shards = tsh.tp_shards(full, specs, tp)
    assert isinstance(shards, tsh.PerShard) and len(shards) == tp
    back = dict(_leaves(tsh.tp_gather(shards, specs)))
    want = dict(_leaves(full))
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        assert np.array_equal(back[name], arr), name
    # sharded leaves are views; replicated ones the same tensor in each shard
    wq = full["blocks"][0]["attn"]["wq"]
    for r, shard in enumerate(shards):
        piece = shard["blocks"][0]["attn"]["wq"]
        assert piece.data_ptr() == wq[..., r * wq.shape[-1] // tp:].data_ptr()
        assert shard["embed"]["w"] is full["embed"]["w"]
    assert tsh.tp_tree_bytes(shards, specs) == sum(
        t.numel() * t.element_size() for _, t in _torch_leaves(full))


def _torch_leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _torch_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _torch_leaves(v)
    else:
        yield None, tree


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_shards_are_contiguous_and_rejoin(paged):
    from repro_torch.models.transformer import init_caches, init_paged_caches

    _, cfg = _configs(n_kv_heads=4)
    caches = (init_paged_caches(cfg, 2, 9, 4, device="cpu") if paged
              else init_caches(cfg, 2, 12, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    for view in caches.kv.values():
        for t in view:
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
    specs = tsh.tp_cache_specs(cfg, paged=paged)
    shards = tsh.tp_shards(caches, specs, 4, copy=True)
    for shard in shards:
        view = shard.kv["0"]
        assert view.k.is_contiguous() and view.k.shape[3] == 1
    back = tsh.tp_gather(shards, specs)
    for a, b in zip(back.kv["0"], caches.kv["0"]):
        assert torch.equal(a, b)
    if not paged:   # the replicated ring positions: one replica a shard
        assert shards[0].kv["0"].pos is caches.kv["0"].pos
        assert shards[1].kv["0"].pos is not caches.kv["0"].pos
        assert torch.equal(shards[1].kv["0"].pos, caches.kv["0"].pos)


def test_mesh_rules():
    mesh = tsh.make_tp_mesh(3, [CPU] * 4)
    assert mesh.shape == (3,) and all(d == CPU for d in mesh)
    assert tsh.mesh_device(mesh) == CPU
    assert tsh.mesh_device(mesh, torch.device("cpu", 0)) == CPU
    with pytest.raises(ValueError, match="need 4 devices"):
        tsh.make_tp_mesh(4, [CPU] * 2)
    with pytest.raises(ValueError, match="flat"):
        tsh.mesh_device(np.array([[CPU, CPU]], dtype=object))
    with pytest.raises(ValueError, match="Queue 1 item 18 part b"):
        tsh.mesh_device(tsh.make_tp_mesh(2, [CPU, torch.device("meta")]))


# ---------------------------------------------------------------------------
# the runtime: ShardGroup and TPShardPolicy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_policy_sums_partials_in_f32_once_for_all_shards(dtype):
    group = tsh.ShardGroup(tsh.make_tp_mesh(3, [CPU] * 3))
    parts = [torch.randn(4, 5, generator=torch.Generator().manual_seed(r))
             .to(dtype) for r in range(3)]

    def shard(x):
        names = [tsh.TP_POLICY(x, "hidden")]          # not a sum: identity
        return names[0], tsh.TP_POLICY(x, "attn_out"), \
            tsh.TP_POLICY(x * 2, "mlp_out")

    outs = group.run(shard, [(p,) for p in parts])
    want = (parts[0].float() + parts[1].float() + parts[2].float()).to(dtype)
    for r, (same, attn, mlp) in enumerate(outs):
        assert same is parts[r]
        assert attn is outs[0][1] and torch.equal(attn, want)
        assert torch.equal(mlp, ((parts[0] * 2).float() + (parts[1] * 2).float()
                                 + (parts[2] * 2).float()).to(dtype))
    assert group.all_reduces == 2
    with pytest.raises(RuntimeError, match="ShardGroup.run"):
        tsh.TP_POLICY(parts[0], "attn_out")


def test_a_failing_shard_fails_the_program_and_frees_the_others():
    group = tsh.ShardGroup(tsh.make_tp_mesh(4, [CPU] * 4))

    def shard(rank):
        if rank == 2:
            raise KeyError("shard 2 fails before its sum")
        return tsh.TP_POLICY(torch.ones(2), "attn_out")

    with pytest.raises(KeyError, match="shard 2"):
        group.run(shard, [(r,) for r in range(4)])
    # the group is usable again after the failure
    outs = group.run(lambda: tsh.TP_POLICY(torch.ones(2), "mlp_out"),
                     [()] * 4)
    assert all(torch.equal(o, torch.full((2,), 4.0)) for o in outs)


def test_a_shard_that_skips_its_sum_fails_the_program():
    group = tsh.ShardGroup(tsh.make_tp_mesh(3, [CPU] * 3))

    def shard(rank):
        if rank == 1:
            return None                          # skips the sum
        return tsh.TP_POLICY(torch.ones(2), "attn_out")

    for order in ([0, 1, 2], [2, 1, 0]):
        with pytest.raises(RuntimeError, match="ended before its sum"):
            group.run(shard, [(order[r],) for r in range(3)])


def test_a_shard_that_hangs_times_out_the_others():
    group = tsh.ShardGroup(tsh.make_tp_mesh(2, [CPU] * 2), timeout=0.5)
    release = threading.Event()

    def shard(rank):
        if rank == 1:
            release.wait()                      # holds its turn
        return tsh.TP_POLICY(torch.ones(2), "attn_out")

    try:
        with pytest.raises(RuntimeError, match="waited more than 0.5 s"):
            group.run(shard, [(0,), (1,)])
    finally:
        release.set()


def test_shards_take_turns_one_at_a_time():
    group = tsh.ShardGroup(tsh.make_tp_mesh(3, [CPU] * 3))
    log = []

    def shard(rank):
        for layer in range(2):
            log.append((rank, layer))
            tsh.TP_POLICY(torch.ones(1), "attn_out")
        log.append((rank, "end"))

    group.run(shard, [(r,) for r in range(3)])
    assert log == [(r, 0) for r in range(3)] + [(r, 1) for r in range(3)] \
        + [(r, "end") for r in range(3)]
    assert group.all_reduces == 2


def test_workers_enter_the_callers_grad_mode():
    group = tsh.ShardGroup(tsh.make_tp_mesh(2, [CPU] * 2))
    with torch.inference_mode():
        modes = group.run(torch.is_inference_mode_enabled, [(), ()])
    assert modes == [True, True]
    with torch.no_grad():
        modes = group.run(torch.is_grad_enabled, [(), ()])
    assert modes == [False, False]


def test_launch_counts_survive_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.route_launches = {"a": 0}

    def bump():
        for _ in range(2000):
            count_launch(wrapper, "a")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 8000 and wrapper.route_launches["a"] == 8000
