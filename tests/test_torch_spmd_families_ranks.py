"""The rank programs of ``tests/test_torch_spmd_families.py``, each run on
every rank of a gloo group by ``repro_torch.launch.spmd.run_ranks``.

As ``test_torch_spmd_ranks.py`` is for the dense family, this module lives
apart from its test file so that a spawned rank imports only numpy, torch
and the port (never JAX).  Each program returns CPU tensors and plain
values; the test file holds them against the reference.  No test is
collected here.
"""

import dataclasses

import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed.spmd import (
    block_of, gather_batch, gather_param_shards, make_policy,
    param_shardings, shard_batch, shard_tree)
from repro_torch.kernels.common import close_cost_sink, open_cost_sink
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving.engine import (
    ServeConfig, SlotState, make_decode_chunk, make_prefill_step,
    make_serve_step)

from test_torch_spmd_ranks import OpSink, _trees_equal

MAX_LEN, STEPS, CHUNK = 32, 2, 4


def f32(arch: str):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def prompt_len(batch) -> int:
    """Positions the prompt fills: the VLM's patches and its tokens."""
    extra = batch.get("extra_embeds")
    return batch["tokens"].shape[1] + (0 if extra is None else extra.shape[1])


def local_batch(batch, mesh, pol):
    """This rank's rows of a serving batch, as ``train_batch_specs`` places
    them: the (3, B, S) M-RoPE positions on their axis 1."""
    return {k: shard_batch(v, mesh, pol.batch_axes,
                           dim=1 if k == "positions" else 0)
            for k, v in batch.items()}


def serve(arch, mesh, params, batch, *, moe_ep=True, norm_local=False):
    """One family under ``make_policy`` on this rank, every result
    gathered to the whole batch: the prefill's logits and gathered caches;
    ``STEPS`` greedy serve steps (tokens, logits) and the gathered caches
    after them; then, from a fresh prefill, one ``make_decode_chunk`` of
    ``CHUNK`` steps (its tokens and emitted mask).  ``norm_local`` swaps
    the SSM norm's sum over "model" for this rank's own sum scaled up, a
    local mean (what the tests must see fail)."""
    cfg = f32(arch)
    B = batch["tokens"].shape[0]
    pol = make_policy(cfg, mesh, batch=B, moe_ep=moe_ep)
    if norm_local:
        summed = pol.model_sum
        pol.model_sum = lambda x, site: (x * pol.model if site == "ssm-norm"
                                         else summed(x, site))
    lp = param_shardings(cfg, mesh, params, moe_ep=moe_ep)
    lb = local_batch(batch, mesh, pol)
    scfg = ServeConfig(max_len=MAX_LEN, attn_impl="torch")
    prefill = make_prefill_step(cfg, scfg, policy=pol)

    def whole(x, dim=0):
        return gather_batch(x, mesh, pol.batch_axes, dim=dim)

    out = {"kv_len_sharded": pol.kv_len_sharded, "expert_block":
           pol.expert_block, "ssm_groups": pol.ssm_groups}
    with torch.no_grad():
        logits0, caches = prefill(lp, lb)
        out["first"] = whole(logits0)
        out["caches0"] = pol.gather_caches(caches)
        tok = torch.argmax(logits0[..., :cfg.vocab], -1).to(torch.int32)
        cur = torch.full((tok.shape[0],), prompt_len(batch), dtype=torch.int32)
        step = make_serve_step(cfg, scfg, policy=pol)
        out["steps"] = []
        pol.log.reset()
        for i in range(STEPS):
            tok, logits, caches = step(lp, tok, caches, cur + i)
            out["steps"].append((whole(tok), whole(logits)))
        out["log"] = dict(pol.log.count)
        out["caches"] = pol.gather_caches(caches)
        if norm_local:
            return out
        logits0, caches = prefill(lp, lb)
        t0 = torch.argmax(logits0[..., :cfg.vocab], -1).to(torch.int32)
        n = t0.shape[0]
        state = SlotState(tokens=t0, cur_pos=cur.clone(),
                          active=torch.ones(n, dtype=torch.bool),
                          remaining=torch.full((n,), 100, dtype=torch.int32),
                          eos=torch.full((n,), -1, dtype=torch.int32))
        chunk = make_decode_chunk(cfg, scfg, CHUNK, policy=pol)
        _, _, toks, emitted, poisoned = chunk(lp, caches, state)
        out["chunk"] = (whole(toks, 1), whole(emitted, 1), whole(poisoned))
    return out


def round_trips(arch, mesh, params):
    """``param_shardings`` then ``gather_param_shards``, for ``fsdp`` and
    ``moe_ep`` both ways: whether each gives ``params`` back bit for bit,
    and the MoE's ``wi`` block this rank holds in each layout."""
    cfg = f32(arch)
    out = {}
    for fsdp in (True, False):
        for ep in (True, False):
            shards = param_shardings(cfg, mesh, params, fsdp=fsdp, moe_ep=ep)
            back = gather_param_shards(cfg, mesh, shards, fsdp=fsdp, moe_ep=ep)
            out[(fsdp, ep)] = _trees_equal(back, params)
            if cfg.moe is not None and not fsdp:
                moe = next(lp["moe"] for lp in shards["blocks"] if "moe" in lp)
                out[("wi", ep)] = moe["wi"]
    return out


def cell_collectives(mesh, arch: str, shape: str):
    """One rank's run of the reduced cell's program (``build_cell`` on the
    process mesh), its parameters placed by ``param_shardings``, its batch
    by the cell's specs and its caches by ``shard_caches``: the
    collectives it issued, by op and by site."""
    from repro_torch.launch.cells import build_cell

    cell = build_cell(arch, shape, mesh, reduced=True)
    args = cell.materialize(device="cpu", seed=0)
    local = [param_shardings(cell.cfg, mesh, args[0])]
    for a, s in zip(args[1:], cell.in_specs[1:]):
        if isinstance(a, tuple) and hasattr(a, "kv"):
            a = cell.policy.shard_caches(a)
        elif isinstance(a, dict):
            a = shard_tree(a, s, mesh)
        elif isinstance(a, torch.Tensor):
            a = block_of(a, s, mesh)
        local.append(a)
    sink = OpSink()
    open_cost_sink(sink)
    try:
        cell.run(*local)
    finally:
        close_cost_sink(sink)
    return {"by_op_bytes": sink.wire, "by_op_count": sink.count,
            "by_site_bytes": dict(cell.policy.log.wire),
            "by_site_count": dict(cell.policy.log.count)}


def ranks_2x2(rank, world, data):
    """Every family on (data 2, model 2), deepseek in both MoE layouts,
    the local-mean norm on mamba2, the parameter round trips and the
    cells' collectives."""
    mesh = make_host_mesh((2, 2), device="cpu")
    out = {"coords": mesh.coords, "serve": {}, "round_trip": {}}
    for arch, ep in data["cases"]:
        out["serve"][(arch, ep)] = serve(arch, mesh, data["params"][arch],
                                         data["batches"][arch], moe_ep=ep)
        if (arch, ep) == ("mamba2-370m", True):
            out["norm_local"] = serve(arch, mesh, data["params"][arch],
                                      data["batches"][arch], norm_local=True)
    for arch in data["round_trip"]:
        out["round_trip"][arch] = round_trips(arch, mesh, data["params"][arch])
    out["cells"] = {(arch, shape): cell_collectives(mesh, arch, shape)
                    for arch, shape in data["cells"]}
    return out


def ranks_2x4(rank, world, data):
    """Reduced jamba and qwen2-vl on (data 2, model 4): their 2 kv heads do
    not divide 4, so the decode cache's length is split over "model"."""
    mesh = make_host_mesh((2, 4), device="cpu")
    out = {"coords": mesh.coords, "serve": {}}
    for arch, ep in data["cases"]:
        out["serve"][(arch, ep)] = serve(arch, mesh, data["params"][arch],
                                         data["batches"][arch], moe_ep=ep)
    return out


def _clone(view):
    """A copy of a cache view (a NamedTuple, or the cross K/V's plain
    tuple)."""
    parts = (t.clone() for t in view)
    return type(view)(*parts) if hasattr(view, "_fields") else tuple(parts)


def single(arch, params, batch):
    """The single process's run of :func:`serve`'s program (no policy):
    the caches after the prefill and after ``STEPS`` steps."""
    cfg = f32(arch)
    scfg = ServeConfig(max_len=MAX_LEN, attn_impl="torch")
    with torch.no_grad():
        logits0, caches = make_prefill_step(cfg, scfg)(params, batch)
        caches0 = type(caches)(*(
            None if part is None else
            {p: _clone(v) for p, v in part.items()} for part in caches))
        tok = torch.argmax(logits0[..., :cfg.vocab], -1).to(torch.int32)
        cur = torch.full((tok.shape[0],), prompt_len(batch), dtype=torch.int32)
        step = make_serve_step(cfg, scfg)
        for i in range(STEPS):
            tok, _, caches = step(params, tok, caches, cur + i)
    return {"first": logits0, "caches0": caches0, "caches": caches}


__all__ = ["ranks_2x2", "ranks_2x4", "single"]
