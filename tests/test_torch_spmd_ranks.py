"""The rank programs of ``tests/test_torch_spmd.py``, each run on every
rank of a gloo group by ``repro_torch.launch.spmd.run_ranks``.

They live apart from the test file so that a spawned rank imports only
numpy, torch and the port (never JAX): ``spawn`` imports the module of the
function it runs.  Each returns CPU tensors and plain values; the test
file holds them against the reference.  No test is collected here.
"""

import dataclasses

import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import cache_specs
from repro_torch.distributed.spmd import (
    CollectiveLog, block_of, gather_batch, gather_param_shards, make_policy,
    param_shardings, shard_batch, shard_tree)
from repro_torch.kernels.common import close_cost_sink, open_cost_sink
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import prefill
from repro_torch.serving.engine import (
    ServeConfig, make_prefill_step, make_serve_step)

ARCH = "qwen3-0.6b"


def reduced(dtype: str):
    return dataclasses.replace(get_reduced(ARCH), dtype=dtype)


class OpSink:
    """A cost sink (``kernels.common``) that tallies collectives by op."""

    def __init__(self):
        self.wire, self.count = {}, {}

    def add_kernel(self, name, flops, n_bytes):
        pass

    def add_collective(self, op, wire, raw):
        self.wire[op] = self.wire.get(op, 0.0) + wire
        self.count[op] = self.count.get(op, 0) + 1


def serve(cfg, mesh, params, toks, *, max_len, steps=2, place=False,
          fsdp=True, impl="torch"):
    """Prefill ``toks`` (B, S) and ``steps`` greedy serve steps under
    ``make_policy`` on this rank; the whole batch's first-token logits and
    each step's (tokens, logits), gathered over the data axes.  With
    ``place`` the prefill is single-device on the full params and its
    caches are placed by ``cache_specs``, as the reference's test places
    them; else the prefill runs under the policy."""
    B, S = toks.shape
    pol = make_policy(cfg, mesh, batch=B, fsdp=fsdp)
    lp = param_shardings(cfg, mesh, params, fsdp=fsdp)
    ltoks = shard_batch(toks, mesh, pol.batch_axes)
    scfg = ServeConfig(max_len=max_len, attn_impl=impl)
    with torch.no_grad():
        if place:
            logits0, caches = prefill(params, toks, cfg, max_len=max_len,
                                      impl=impl)
            caches = shard_tree(caches, cache_specs(cfg, mesh, batch=B), mesh)
            logits0 = shard_batch(logits0, mesh, pol.batch_axes)
        else:
            logits0, caches = make_prefill_step(cfg, scfg, policy=pol)(
                lp, {"tokens": ltoks})
        tok = torch.argmax(logits0[..., :cfg.vocab], -1).to(torch.int32)
        cur = torch.full((tok.shape[0],), S, dtype=torch.int32)
        step = make_serve_step(cfg, scfg, policy=pol)
        out = []
        for i in range(steps):
            tok, logits, caches = step(lp, tok, caches, cur + i)
            out.append((gather_batch(tok, mesh, pol.batch_axes),
                        gather_batch(logits, mesh, pol.batch_axes)))
    kv = next(iter(caches.kv.values()))
    return {"first": gather_batch(logits0, mesh, pol.batch_axes),
            "steps": out, "kv_len_sharded": pol.kv_len_sharded,
            "cache_dtypes": (kv.k.dtype, kv.v.dtype, kv.pos.dtype),
            "cache_shape": tuple(kv.k.shape), "log": dict(pol.log.count)}


def merge_cases(cfg, mesh, case):
    """Decode attention over this rank's length block of ``case``'s whole
    cache (the plain version's ``return_stats``), merged by the policy,
    beside the whole cache's attention."""
    pol = make_policy(cfg, mesh, batch=case["q"].shape[0], fsdp=False)
    spec = (None, "model")
    k = block_of(case["k"], spec, mesh)
    v = block_of(case["v"], spec, mesh)
    pos = block_of(case["pos"], spec, mesh)
    out, m, l = decode_attention_ref(case["q"], k, v, pos, case["cur"],
                                     return_stats=True)
    merged = pol.merge_attention(out, m, l)
    whole = decode_attention_ref(case["q"], case["k"], case["v"], case["pos"],
                                 case["cur"])
    return {"merged": merged, "whole": whole,
            "rows_valid": ((pos >= 0) & (pos <= case["cur"][:, None])).any(1)}


def cell_collectives(mesh, shape: str):
    """One rank's run of the reduced cell's program (``build_cell`` on the
    process mesh), its arguments placed by the cell's specs: the
    collectives it issued, by op and by site."""
    from repro_torch.launch.cells import build_cell

    cell = build_cell(ARCH, shape, mesh, reduced=True)
    args = cell.materialize(device="cpu", seed=0)
    local = (param_shardings(cell.cfg, mesh, args[0]),) + tuple(
        shard_tree(a, s, mesh) if isinstance(a, (dict, tuple)) and s is not None
        else (block_of(a, s, mesh) if isinstance(a, torch.Tensor) else a)
        for a, s in zip(args[1:], cell.in_specs[1:]))
    sink = OpSink()
    open_cost_sink(sink)
    try:
        cell.run(*local)
    finally:
        close_cost_sink(sink)
    return {"by_op_bytes": sink.wire, "by_op_count": sink.count,
            "by_site_bytes": dict(cell.policy.log.wire),
            "by_site_count": dict(cell.policy.log.count)}


def ranks_2x4(rank, world, data):
    """(a), (c), (d), (f) and (g) on the (data 2, model 4) mesh: reduced
    qwen3-0.6b, whose 2 kv heads do not divide 4, so the decode cache's
    length is sharded over "model"."""
    mesh = make_host_mesh((2, 4), device="cpu")
    out = {"coords": mesh.coords}
    f32, bf16 = reduced("float32"), reduced("bfloat16")
    toks = data["toks"]
    out["f32_placed"] = serve(f32, mesh, data["params_f32"], toks, max_len=32,
                              place=True)
    out["f32_policy"] = serve(f32, mesh, data["params_f32"], toks, max_len=32)
    out["f32_cuda_route"] = serve(f32, mesh, data["params_f32"], toks,
                                  max_len=32, fsdp=False, impl="cuda")
    out["bf16_placed"] = serve(bf16, mesh, data["params_bf16"], toks,
                               max_len=32, place=True)
    # a prompt longer than the 16-slot ring: the first steps wrap it
    out["wrap"] = serve(f32, mesh, data["params_f32"], data["toks_wrap"],
                        max_len=16)
    # (c) the vocab-parallel lookup at ids on the shard boundaries
    for name, cfg, params in (("f32", f32, data["params_f32"]),
                              ("bf16", bf16, data["params_bf16"])):
        pol = make_policy(cfg, mesh, batch=4)
        table = params["embed"]["w"]
        local = block_of(table, ("model", None), mesh)
        ids = data["boundary_ids"]
        out[f"embed_{name}"] = torch.equal(pol.embed(local, ids), table[ids])
    # (d) param_shardings and its inverse, fsdp on and off
    for fsdp in (True, False):
        shards = param_shardings(f32, mesh, data["params_f32"], fsdp=fsdp)
        back = gather_param_shards(f32, mesh, shards, fsdp=fsdp)
        out[f"roundtrip_fsdp{int(fsdp)}"] = _trees_equal(back,
                                                        data["params_f32"])
        out[f"wi_block_fsdp{int(fsdp)}"] = shards["blocks"][0]["mlp"]["wi"]
    # (f) the merge over the model ranks, cases with no valid slot
    out["merge"] = merge_cases(f32, mesh, data["merge_case"])
    # (g) the reduced cells' collectives on the process mesh
    out["cells"] = {shape: cell_collectives(mesh, shape)
                    for shape in ("decode_32k", "prefill_32k", "train_4k")}
    return out


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def ranks_2(rank, world, data):
    """(b) the head-aligned (1, 2) and data-only (2, 1) meshes, and (e) a
    "pod" axis of 2: ``pod_psum_compressed`` and a ``compress_pods`` train
    step, one pod a rank."""
    from repro_torch.distributed.compression import pod_psum_compressed
    from repro_torch.training import TrainerConfig, make_train_step
    from repro_torch.training.steps import make_loss_fn, value_and_grad
    from repro_torch.optim import adamw_init

    f32 = reduced("float32")
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_host_mesh(shape, device="cpu")
        out[shape] = serve(f32, mesh, data["params_f32"], data["toks"],
                           max_len=32)
    pods = make_host_mesh((2,), axes=("pod",), device="cpu")
    log = CollectiveLog()
    red, efb = pod_psum_compressed(data["pod_grads"][rank],
                                   data["pod_efb"][rank], mesh=pods, log=log)
    out["psum"] = (red, efb, dict(log.count), dict(log.wire))
    # the train step over the pods: each rank its pod's rows
    batch = {k: v[rank * 2:(rank + 1) * 2] for k, v in data["batch"].items()}
    tcfg = TrainerConfig(compress_pods=True, lr=data["lr"])
    step = make_train_step(f32, tcfg, mesh=pods)
    params, _, metrics = step(data["params_f32"],
                              adamw_init(data["params_f32"]), batch)
    (_, local_metrics), grads = value_and_grad(make_loss_fn(f32, tcfg),
                                               data["params_f32"], batch)
    out["train"] = {"params": params, "metrics": metrics,
                    "local_grads": grads, "local_loss": local_metrics["loss"]}
    return out
