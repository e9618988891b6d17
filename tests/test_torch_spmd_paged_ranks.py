"""The rank programs of ``tests/test_torch_spmd_paged.py``, each run on every
rank of a gloo group by ``repro_torch.launch.spmd.run_ranks``, and the
single process's runs of the same programs.

As ``test_torch_spmd_ranks.py`` is for the dense family, this module lives
apart from its test file so that a spawned rank imports only numpy, torch
and the port (never JAX).  Each program returns CPU tensors and plain
values; the test file holds them against the reference and against each
other.  No test is collected here.
"""

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed.spmd import make_policy, param_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, prefix_prefill, verify_step
from repro_torch.serving import ContinuousBatcher, Request, ServingConfig
from repro_torch.serving.kv_cache import (
    kv_cache_bytes, paged_kv_cache_bytes, tree_bytes)
from repro_torch.serving.engine import (
    ServeConfig, init_draft_state, init_page_state, init_slot_state,
    make_cached_admit_step, make_paged_admit_step, make_paged_decode_chunk,
    make_paged_spec_decode_chunk)

BASE = dict(slots=4, prompt_len=16, max_len=48, chunk=4, page_size=4)
MODES = {
    "dense": {},
    "paged": dict(paged=True),
    "prefix": dict(paged=True, prefix_cache=True),
    "spec": dict(speculative=True),
    "spec_paged": dict(paged=True, speculative=True, overlap=True),
    "audit": dict(paged=True, audit=True, watchdog_s=1000.0),
}
N_REQ, HEAD, TAIL, MAX_NEW = 6, 8, 8, 10
DEADLINE = 1e12           # never reached: the shedding path runs all the same


def f32(arch: str):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def prompts(arch: str) -> np.ndarray:
    """(N_REQ, HEAD + TAIL) prompts: one shared head, distinct tails."""
    rng = np.random.default_rng(0)
    vocab = get_reduced(arch).vocab
    head = rng.integers(1, vocab, size=HEAD)
    tails = rng.integers(1, vocab, size=(N_REQ, TAIL))
    return np.concatenate([np.broadcast_to(head, (N_REQ, HEAD)), tails],
                          axis=1).astype(np.int32)


def requests(arch: str, mode: str):
    deadline = DEADLINE if mode == "audit" else None
    return [Request(rid=i, prompt=p, max_new=MAX_NEW, namespace="a",
                    deadline=deadline) for i, p in enumerate(prompts(arch))]


def _ledger(b) -> str:
    """The host ledgers a round leaves: the page ledger's holdings, shared
    pages and refcounts, the prefix cache's nodes and ghost index."""
    parts = []
    if b.paged:
        pool = b.kv_pool
        parts += [sorted(pool._held.items()), sorted(pool._shared.items()),
                  sorted(pool._ref.items()), sorted(b._quarantined)]
    if b.prefix is not None:
        nodes, todo = [], list(b.prefix._roots.items())
        while todo:
            ns, children = todo.pop()
            for key, node in children.items():
                nodes.append((ns, node.depth, key, node.page_id,
                              node.refcount, node.last_used))
                todo.append((ns, node.children))
        parts += [sorted(nodes, key=repr), list(b.prefix._seen)]
    return repr(parts)


def _page_state(b) -> str:
    """A digest of the round's device bookkeeping: the page table, free
    stack, ``free_top`` and ``pinned`` (paged), the slot state."""
    h = hashlib.sha256()
    tensors = list(b.state)
    if b.paged:
        tensors += [b.pages.table, b.pages.free, b.pages.free_top,
                    b.pages.pinned]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_batcher(arch, mode, params, *, policy=None):
    """One batcher run of ``mode`` over the requests: each request's tokens,
    every ``BatcherStats`` counter, each round's page-state digest and
    ledger (the page ledger's own check holding after every round), the
    pool after the first round (gathered over "model" under a policy);
    under a policy also the bytes of the rank's caches beside
    ``kv_cache_bytes``' reckoning for a rank, and ``remesh``'s refusal."""
    cfg = f32(arch)
    b = ContinuousBatcher(params, cfg, ServingConfig(**BASE, **MODES[mode]),
                          device="cpu", policy=policy)
    reqs = requests(arch, mode)
    for r in reqs:
        b.submit(r)
    rounds, pool = [], None
    with torch.no_grad():
        while b.queue or any(r is not None for r in b.slot_req):
            b.step()
            rounds.append((_page_state(b), _ledger(b)))
            if b.paged:
                b.kv_pool.check()
                if pool is None:
                    caches = (b.caches if policy is None
                              else policy.gather_caches(b.caches))
                    pool = {p: (v.k.clone(), v.v.clone())
                            for p, v in caches.kv.items()}
            assert len(rounds) < 100, "the batcher did not drain"
    out = {"tokens": [list(r.out) for r in reqs], "stats": b.stats.as_dict(),
           "rounds": rounds, "pool": pool}
    if policy is not None:
        out["rank_bytes"] = tree_bytes(b.caches)
        out["reckoned"] = (
            paged_kv_cache_bytes(cfg, b.n_pages, b.page_size, policy=policy)
            if b.paged else
            kv_cache_bytes(cfg, b.B, b.config.max_len, policy=policy))
        try:
            b.remesh(tp=1)
            out["remesh"] = None
        except ValueError as e:
            out["remesh"] = str(e)
    return out


def serve_cases(mesh, params, cases):
    """Every (arch, mode, moe_ep) case's batcher under ``make_policy`` on
    this rank, its params placed by ``param_shardings``."""
    out = {}
    for arch, mode, ep in cases:
        cfg = f32(arch)
        pol = make_policy(cfg, mesh, batch=BASE["slots"], moe_ep=ep)
        lp = param_shardings(cfg, mesh, params[arch], moe_ep=ep)
        res = run_batcher(arch, mode, lp, policy=pol)
        res["log"] = dict(pol.log.count)
        out[(arch, mode, ep)] = res
    return out


# ---------------------------------------------------------------------------
# Engine-level programs
# ---------------------------------------------------------------------------

PS, N_PAGES, ENGINE_B = 4, 24, 4


def _pool_local(pol):
    """``pol`` with the data-axis K/V gather switched off: every pool write
    keeps only this data group's rows (the other groups' rows write zeros,
    as a pool that never saw them holds), so a prefix page one group wrote
    is missing in the others' pools."""
    gather = pol.pool_rows

    def pool_rows(*parts, n=None, dim=0):
        whole = gather(*parts, n=n, dim=dim)
        blk = pol.row_block(n)
        if blk is None:
            return whole
        out = []
        for w in whole:
            if w.is_floating_point():
                keep = torch.zeros(w.shape[dim], dtype=torch.bool)
                keep[blk[0]:blk[1]] = True
                shape = [1] * w.dim()
                shape[dim] = -1
                w = torch.where(keep.view(shape), w, torch.zeros_like(w))
            out.append(w)
        return tuple(out)

    pol.pool_rows = pool_rows
    return pol


def engine(params, *, mesh=None, switch_off=False):
    """The paged programs one by one on reduced qwen3 (4 slots, pages of 4):
    a cold admission of slots 0 and 1 (its bucket split one row a data
    group; slot 1's first two pages pinned for the prefix cache), a cached
    admission of slots 2 and 3 over slot 1's two pages (row 0 of that
    bucket runs on data group 0 and reads the pages data group 1 wrote), a
    paged decode chunk of 3 steps and a paged spec chunk of 2 windows of 3;
    then the logits of a paged ``decode_step``, a paged ``verify_step`` and
    a ``prefix_prefill`` on the final state.  Returns every step's tokens,
    the page state and the pool (gathered over "model") after each, and the
    logits (gathered over the data axes)."""
    cfg = f32("qwen3-0.6b")
    scfg = ServeConfig(max_len=BASE["max_len"], attn_impl="torch")
    B, maxp = ENGINE_B, BASE["max_len"] // PS
    pol = None
    if mesh is not None:
        pol = make_policy(cfg, mesh, batch=B)
        if switch_off:
            _pool_local(pol)
        params = param_shardings(cfg, mesh, params)
        caches = pol.init_paged_caches(N_PAGES, PS, device="cpu")
    else:
        from repro_torch.models import init_paged_caches

        caches = init_paged_caches(cfg, B, N_PAGES, PS, device="cpu")
    state = init_slot_state(B, device="cpu")
    pages = init_page_state(B, N_PAGES, maxp, device="cpu")
    toks = torch.from_numpy(prompts("qwen3-0.6b")[:4].copy())
    out = {}

    def pool():
        c = caches if pol is None else pol.gather_caches(caches)
        return {p: (v.k.clone(), v.v.clone()) for p, v in c.kv.items()}

    def snap(name, tokens):
        out[name] = {"tokens": tokens.clone(), "pool": pool(),
                     "pages": tuple(t.clone() for t in pages),
                     "state": tuple(t.clone() for t in state)}

    i32 = lambda v: torch.tensor(v, dtype=torch.int32)    # noqa: E731
    with torch.no_grad():
        cold = make_paged_admit_step(cfg, scfg, policy=pol)
        nxt, caches, state, pages, _ = cold(
            params, {"tokens": toks[:2]}, caches, state, pages, i32([0, 1]),
            i32([16, 16]), i32([12, 12]), i32([-1, -1]),
            torch.tensor([True, True]), i32([0, 2]))
        snap("cold", nxt)
        pids = pages.table[1, :2].clone()
        cached = make_cached_admit_step(cfg, scfg, 2, policy=pol)
        nxt, caches, state, pages, _ = cached(
            params, {"tokens": toks[2:, 8:]}, caches, state, pages,
            i32([2, 3]), i32([16, 16]), i32([12, 12]), i32([-1, -1]),
            torch.tensor([True, True]), torch.stack([pids, pids]),
            i32([2, 2]))
        snap("cached", nxt)
        if switch_off:
            return out
        chunk = make_paged_decode_chunk(cfg, scfg, 3, PS, policy=pol)
        caches, state, pages, t, emitted, poisoned, ctr = chunk(
            params, caches, state, pages)
        snap("decode", torch.cat([t, emitted.int(), poisoned[None].int(),
                                  ctr[:, None].expand(4, B)]))
        draft = init_draft_state(B, 16, device="cpu")
        spec = make_paged_spec_decode_chunk(cfg, scfg, 2, 3, 2, PS,
                                            policy=pol)
        caches, state, pages, draft, t, emitted, poisoned, ctr = spec(
            params, caches, state, pages, draft)
        snap("spec", torch.cat([t.reshape(-1), emitted.int().reshape(-1),
                                poisoned.int(), ctr, draft.hist.reshape(-1)]))
        out["logits"] = _logits(params, caches, state, pages, cfg, pol)
    return out


def _logits(params, caches, state, pages, cfg, pol):
    """The paged decode step's, the paged verify window's and a prefix
    prefill's logits on the final state, the whole batch's."""
    rows = slice(None)
    if pol is not None and pol.row_block() is not None:
        rows = slice(*pol.row_block())

    def whole(x):
        return x if pol is None or rows == slice(None) else \
            pol.gather_rows(x)[0]

    st = state
    lg_d, _ = decode_step(params, st.tokens[rows], caches, st.cur_pos[rows],
                          cfg, impl="torch", page_table=pages.table[rows],
                          policy=pol)
    q = torch.stack([st.tokens, st.tokens], dim=1)
    lg_v, _ = verify_step(params, q[rows], caches, st.cur_pos[rows], cfg,
                          impl="torch", page_table=pages.table[rows],
                          policy=pol)
    # the prefix prefill of the prompts' tails over slot 1's first two pages
    pids = pages.table[1, :2].long()
    prefix_kv = {p: tuple(a[:, pids].reshape(a.shape[0], 1, 2 * PS,
                                             *a.shape[3:]).expand(
        a.shape[0], st.tokens.shape[0], 2 * PS, *a.shape[3:])[:, rows]
        for a in (v.k, v.v)) for p, v in caches.kv.items()}
    tails = torch.from_numpy(prompts("qwen3-0.6b")[:4, 8:].copy())
    lg_p, _ = prefix_prefill(params, tails[rows], prefix_kv, cfg,
                             prefix_len=2 * PS, impl="torch", policy=pol)
    return {"decode": whole(lg_d), "verify": whole(lg_v),
            "prefix": whole(lg_p)}


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


def ranks_2x2(rank, world, data):
    """Every (2, 2) batcher case, the engine's programs with the data-axis
    gather on and off."""
    mesh = make_host_mesh((2, 2), device="cpu")
    out = {"coords": mesh.coords}
    out["serve"] = serve_cases(mesh, data["params"], data["cases"])
    qwen = data["params"]["qwen3-0.6b"]
    out["engine"] = engine(qwen, mesh=mesh)
    out["engine_off"] = engine(qwen, mesh=mesh, switch_off=True)
    return out


def ranks_1x4(rank, world, data):
    """Reduced qwen3 on (1, 4), whose 2 kv heads do not divide 4: the dense
    batcher on the length-sharded ring, and the paged and speculative
    batchers' refusals (their messages)."""
    mesh = make_host_mesh((1, 4), device="cpu")
    out = {"coords": mesh.coords,
           "serve": serve_cases(mesh, data["params"], data["cases"])}
    cfg = f32("qwen3-0.6b")
    pol = make_policy(cfg, mesh, batch=BASE["slots"])
    lp = param_shardings(cfg, mesh, data["params"]["qwen3-0.6b"])
    out["kv_len_sharded"] = pol.kv_len_sharded
    out["refused"] = {}
    for mode in data["refused"]:
        try:
            ContinuousBatcher(lp, cfg, ServingConfig(**BASE, **MODES[mode]),
                              device="cpu", policy=pol)
            out["refused"][mode] = None
        except NotImplementedError as e:
            out["refused"][mode] = str(e)
    return out


__all__ = ["engine", "ranks_1x4", "ranks_2x2", "run_batcher"]
