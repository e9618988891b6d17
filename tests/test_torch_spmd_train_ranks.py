"""The rank programs of ``tests/test_torch_spmd_train.py``, run on every
rank of a gloo group by ``repro_torch.launch.spmd.run_ranks``.

As ``test_torch_spmd_ranks.py`` is for serving, this module lives apart
from its test file so that a spawned rank imports only numpy, torch and the
port (never JAX).  Each program returns CPU tensors and plain values; the
test file holds them against the reference.  No test is collected here.
"""

import dataclasses

from repro_torch.configs import get_reduced
from repro_torch.distributed.spmd import (
    gather_param_shards, make_policy, param_shardings, shard_batch)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw_init
from repro_torch.training import TrainerConfig, make_train_step
from repro_torch.tree import leaves, tree_map

from test_torch_spmd_ranks import cell_collectives

B, SEQ, CHUNK, LR = 4, 32, 8, 3e-4


def f32(arch: str):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def trainer(tkw) -> TrainerConfig:
    return TrainerConfig(loss_chunk=CHUNK, lr=LR, **tkw)


def local_batch(batch, mesh, pol, micro: int):
    """This rank's rows of a train batch (of each microbatch under
    ``grad_accum``), as ``train_batch_specs`` places them: the (3, B, S)
    M-RoPE positions on their axis 1."""
    return {k: shard_batch(v, mesh, pol.batch_axes, micro=micro,
                           dim=1 if k == "positions" else 0)
            for k, v in batch.items()}


def _moments(pol, tcfg, params, opt):
    """The rank's f32 moment blocks (the 8-bit ones dequantized)."""
    if not tcfg.quantize_opt:
        return opt.m, opt.v
    plans = pol.leaf_plans()

    def dq(p, qt, plan):
        return pol.dequantize_moment(qt.q, qt.scale, plan, p.shape, 256)

    return (tree_map(dq, params, opt.m, plans),
            tree_map(dq, params, opt.v, plans))


def train(mesh, arch, params, batches, *, fsdp=True, moe_ep=True, tkw=None,
          hook_off=None):
    """Two train steps of ``arch`` under ``make_policy`` on this rank, one
    batch each: the first step's gradients before clipping
    (``keep_grads``), each step's metrics, the params and moments after the
    last, all gathered whole; and this rank's own blocks of the params and
    moments with each leaf's split axes.  ``hook_off`` names an entry hook
    switched off (the identity both ways): what must fail."""
    tkw = dict(tkw or {})
    cfg, tcfg = f32(arch), trainer(tkw)
    pol = make_policy(cfg, mesh, batch=B, fsdp=fsdp, moe_ep=moe_ep)
    if hook_off is not None:
        enter = pol._enter
        pol._enter = lambda x, site: x if site == hook_off else enter(x, site)
    lp = param_shardings(cfg, mesh, params, fsdp=fsdp, moe_ep=moe_ep)
    lbs = [local_batch(b, mesh, pol, tcfg.grad_accum) for b in batches]
    step = make_train_step(cfg, tcfg, policy=pol, mesh=mesh)

    def whole(tree):
        return gather_param_shards(cfg, mesh, tree, fsdp=fsdp, moe_ep=moe_ep)

    opt = adamw_init(lp, quantize=tcfg.quantize_opt, policy=pol)
    pol.log.reset()
    lp, opt, m, grads = step(lp, opt, lbs[0], keep_grads=True)
    out = {"grads": whole(grads), "metrics": [
        {k: float(v) for k, v in m.items()}]}
    if hook_off is not None:
        return out
    for b in lbs[1:]:
        lp, opt, m = step(lp, opt, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    m, v = _moments(pol, tcfg, lp, opt)
    out.update(params=whole(lp), m=whole(m), v=whole(v), log=dict(
        pol.log.count), local={"params": lp, "m": m, "v": v},
        split=[plan.split for plan in leaves(pol.leaf_plans())],
        kv_len_sharded=pol.kv_len_sharded, batch_axes=pol.batch_axes)
    return out


def ranks_train(rank, world, data):
    """Every case of ``data["cases"]`` on 4 ranks, the meshes made once
    each: ``(name, arch, axes, shape, fsdp, moe_ep, tkw)``; then the
    switched-off hook, the live refusal of ``compress_pods`` and the
    reduced train cell's collectives on (2, 2)."""
    meshes, out = {}, {"cases": {}}

    def mesh_of(axes, shape):
        key = (tuple(axes), tuple(shape))
        if key not in meshes:
            meshes[key] = make_host_mesh(shape, axes=axes, device="cpu")
        return meshes[key]

    for name, arch, axes, shape, fsdp, ep, tkw in data["cases"]:
        mesh = mesh_of(axes, shape)
        out["cases"][name] = dict(train(
            mesh, arch, data["params"][arch], data["batches"][arch],
            fsdp=fsdp, moe_ep=ep, tkw=tkw), coords=mesh.coords)
    arch, axes, shape = data["hook_off"]
    out["hook_off"] = train(mesh_of(axes, shape), arch, data["params"][arch],
                            data["batches"][arch], hook_off="moe_weights")
    pods = mesh_of(("pod", "data", "model"), (2, 1, 2))
    cfg = f32("qwen3-0.6b")
    try:
        make_train_step(cfg, TrainerConfig(compress_pods=True), mesh=pods,
                        policy=make_policy(cfg, pods, batch=B))
        out["refused"] = None
    except NotImplementedError as e:
        out["refused"] = str(e)
    out["cell"] = cell_collectives(mesh_of(("data", "model"), (2, 2)),
                                   "train_4k")
    return out
