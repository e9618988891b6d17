"""The port's fault guards on the CPU, against the JAX package at f32.

Serving guards (mirrors of ``tests/test_faults.py::TestServingGuards``):
both packages' batchers get the same requests and the same injections (the
NaN sentinel dense and paged, the watchdog under a pinned clock, an
out-of-range page id, a double mapping, shared prefix pages, the audit
under ``overlap=True``), then the tokens of every request, every
``BatcherStats`` counter (``dispatches`` and ``host_syncs`` included), the
quarantined set, the page tables, the free stack and ``free_top`` must be
identical.  The NaN sentinel, the watchdog and a double mapping also run
under ``speculative=True``, held to the same equality; an out-of-range id
there differs from the reference by exactly one accepted draft
(``SPEC_OUT_OF_RANGE_DELTA``).  Reduced qwen3-0.6b; weights from
``repro.models.init_params`` through ``weights.params_from_jax``; prompts
made with numpy from a seed.

Core faults (mirrors of ``TestSlowCoreFaults`` and
``TestRollbackUnderShrink``): ``CORE_SLOW`` through the port's
``VirtualEngine`` and its straggler probe, and the hypervisor's rollback
when a core dies inside an eviction, each against the reference.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_reduced as jax_reduced
from repro.core.hrp import HRPError as JaxHRPError
from repro.models import init_params as jax_init_params
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch.configs import get_reduced
from repro_torch.core.hrp import HRPError
from repro_torch.serving import ContinuousBatcher, Request, ServingConfig
from repro_torch.weights import params_from_jax


def _configs():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


BASE = dict(slots=4, prompt_len=8, max_len=64, chunk=4)


class _Pair:
    """The reference's batcher and the port's, built from one config, fed
    the same requests, stepped and injected together."""

    def __init__(self, models, *, clock=None, impl="torch", **kw):
        jp, params = models
        jcfg, cfg = _configs()
        self.cfg = cfg
        kw = {**BASE, **kw}
        self.j = JaxBatcher(jp, jcfg, JaxServingConfig(attn_impl="xla", **kw),
                            clock=clock)
        self.t = ContinuousBatcher(params, cfg,
                                   ServingConfig(attn_impl=impl, **kw),
                                   device="cpu", clock=clock)
        self.jreqs, self.treqs = [], []

    def submit(self, prompts, max_new):
        for i, p in enumerate(prompts):
            n = max_new[i % len(max_new)]
            self.jreqs.append(JaxRequest(rid=i, prompt=p, max_new=n))
            self.treqs.append(Request(rid=i, prompt=p, max_new=n))
            self.j.submit(self.jreqs[-1])
            self.t.submit(self.treqs[-1])

    def step(self, n=1):
        for _ in range(n):
            self.j.step()
            self.t.step()

    def run(self):
        self.j.run(max_steps=4000)
        self.t.run(max_steps=4000)

    def assert_same(self):
        assert _state(self.t, self.treqs) == _state(self.j, self.jreqs)


def _state(b, reqs):
    """Everything the guards touch, in plain form: tokens, counters, slot
    and queue occupancy, and (paged) quarantine, tables, free stack,
    ``free_top``, pins and the ledger."""
    out = {"tokens": [list(r.out) for r in reqs],
           "done": [r.done for r in reqs],
           "stats": b.stats.as_dict(),
           "slots": [None if r is None else r.rid for r in b.slot_req],
           "queue": [r.rid for r in b.queue],
           "active": np.asarray(b.state.active).tolist()}
    if b.paged:
        top = int(np.asarray(b.pages.free_top))
        out.update(
            quarantined=sorted(b._quarantined),
            table=np.asarray(b.pages.table).tolist(),
            free=np.asarray(b.pages.free)[:top].tolist(),
            free_top=top,
            pinned=np.asarray(b.pages.pinned).tolist(),
            ledger=(b.kv_pool.used, b.kv_pool.shared,
                    b.kv_pool.held_by("__quarantine__")))
    return out


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=1 + i % 6).astype(np.int32)
            for i in range(n)]


def _poison_jax(b):
    b.caches = jax.tree_util.tree_map(
        lambda x: jnp.full_like(x, jnp.nan)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, b.caches)


def _poison_port(tree):
    """Fill every float tensor of the port's cache tree with NaN, in place:
    the bit-flip fault model of the reference's test."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            tree.fill_(float("nan"))
    elif isinstance(tree, dict):
        for v in tree.values():
            _poison_port(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _poison_port(v)


def _quarantine_partition(b):
    """Mapped + free + cache-shared + quarantined partitions the pool, and a
    quarantined page is neither free nor mapped."""
    tab = np.asarray(b.pages.table)
    top = int(np.asarray(b.pages.free_top))
    free = set(np.asarray(b.pages.free)[:top].tolist())
    mapped = set(tab[tab >= 0].tolist())
    shared = b.kv_pool.shared_ids()
    quarantined = b._quarantined
    assert not (quarantined & free), "quarantined page back on free stack"
    assert not (quarantined & mapped), "quarantined page still mapped"
    assert sorted(mapped | free | shared | quarantined) == \
        list(range(b.n_pages)), "pool partition violated"
    b.kv_pool.check()


# ---------------------------------------------------------------------------
# serving guards, both packages side by side
# ---------------------------------------------------------------------------


def test_guards_build_in_the_port(models):
    """watchdog_s and audit=True are ported: the batcher builds with both
    and only tp > 1 is still refused."""
    _, params = models
    _, cfg = _configs()
    b = ContinuousBatcher(params, cfg, ServingConfig(
        **BASE, paged=True, page_size=8, watchdog_s=1.0, audit=True),
        device="cpu")
    assert b._audit and b._watchdog_s == 1.0
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        ContinuousBatcher(params, cfg, ServingConfig(
            **BASE, tp=2, attn_impl="torch"), device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nan_sentinel_requeues_like_reference(models, paged):
    kw = dict(paged=True, page_size=8) if paged else {}
    pair = _Pair(models, **kw)
    pair.submit(_prompts(pair.cfg, 4), [8])
    pair.step(2)
    _poison_jax(pair.j)
    _poison_port(pair.t.caches)
    pair.step()
    pair.assert_same()
    pair.run()
    pair.assert_same()
    b = pair.t
    assert b.stats.poisoned_slots >= 1
    assert all(len(r.out) > 0 for r in pair.treqs)
    assert not any(b.slot_req)
    if paged:       # poisoned slots were recycled on the device
        assert int(b.pages.free_top) == b.n_pages
        b.kv_pool.check()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_watchdog_trips_like_reference(models, paged):
    """A pinned clock (every read is 0.0) and a synthetic 1 s stall against
    a 0.5 s bound: exactly one trip, the stalled slot deactivated and its
    request requeued; paged, its private pages return to the free stack."""
    kw = dict(paged=True, page_size=8) if paged else {}
    pair = _Pair(models, clock=lambda: 0.0, watchdog_s=0.5, **kw)
    pair.submit(_prompts(pair.cfg, 2), [8])
    pair.step()
    assert pair.t.stats.watchdog_trips == 0
    pair.j.inject_stall(0, 1.0)
    pair.t.inject_stall(0, 1.0)
    pair.step()
    pair.assert_same()
    assert pair.t.stats.watchdog_trips == 1
    assert pair.t.slot_req[0] is None
    assert not bool(pair.t.state.active[0])
    pair.run()
    pair.assert_same()
    assert all(len(r.out) > 0 for r in pair.treqs)


def test_watchdog_without_a_named_slot_retires_the_longest_lane(models):
    """A stall blamed on an empty slot falls back to the slot with the most
    generated tokens, as in the reference."""
    pair = _Pair(models, clock=lambda: 0.0, watchdog_s=0.5, paged=True,
                 page_size=8)
    pair.submit(_prompts(pair.cfg, 3), [12, 16, 14])
    pair.step()
    for b in (pair.j, pair.t):
        b.inject_stall(3, 2.0)           # slot 3 is empty
    pair.step()
    pair.assert_same()
    assert pair.t.stats.watchdog_trips == 1
    # three lanes of 9 tokens each: the tie goes to the lowest slot
    assert pair.t.slot_req.count(None) == 2 and pair.t.queue[0].rid == 0
    pair.run()
    pair.assert_same()


def test_audit_quarantines_out_of_range_pid_like_reference(models):
    pair = _Pair(models, paged=True, page_size=8, audit=True)
    pair.submit(_prompts(pair.cfg, 4), [32])
    pair.step(2)
    assert pair.t.slot_req[0] is not None
    pair.assert_same()
    pair.j.inject_kv_corruption(0)
    pair.t.inject_kv_corruption(0)
    assert int(pair.t.pages.table[0].max()) == pair.t.n_pages + 7
    pair.step()
    pair.assert_same()
    assert pair.t.stats.audit_repairs >= 1
    pair.run()
    pair.assert_same()
    assert all(len(r.out) > 0 for r in pair.treqs)
    _quarantine_partition(pair.t)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_audit_quarantines_double_mapped_page_like_reference(models, impl):
    """Slot 0 claims a page slot 1 really owns: both mappings are cleared,
    the page is quarantined for good (billed to ``__quarantine__``), both
    slots requeue, and slot 0's orphaned page is reclaimed.  ``"cuda"`` on
    CPU tensors runs the kernels' plain versions."""
    pair = _Pair(models, impl=impl, paged=True, page_size=8, audit=True)
    pair.submit(_prompts(pair.cfg, 4), [32])
    pair.step(2)
    row1 = pair.t.pages.table[1].numpy()
    stolen = int(row1[row1 >= 0][0])
    pair.j.inject_kv_corruption(0, pid=stolen)
    pair.t.inject_kv_corruption(0, pid=stolen)
    syncs = pair.t.stats.host_syncs
    pair.step()
    pair.assert_same()
    b = pair.t
    assert b.stats.audit_repairs >= 2
    assert stolen in b._quarantined and b.stats.quarantined_pages == 1
    assert b.kv_pool.held_by("__quarantine__") == 1
    # the chunk's fetch, then two requeued slots read their rows and the
    # leak check reads the pool
    assert b.stats.host_syncs - syncs == 1 + 2 + 1
    pair.run()
    pair.assert_same()
    assert all(len(r.out) > 0 for r in pair.treqs)
    _quarantine_partition(b)


def test_audit_exempts_shared_prefix_pages_like_reference(models):
    """Cache-owned prefix pages are legitimately multi-mapped; the audit
    must not mistake them for corruption.  The requests share a namespace,
    so the cache really maps its pages into several slots at once."""
    pair = _Pair(models, prompt_len=32, paged=True, page_size=8,
                 prefix_cache=True, audit=True)
    rng = np.random.default_rng(0)
    head = rng.integers(1, pair.cfg.vocab, size=28).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, pair.cfg.vocab, size=4)
                               .astype(np.int32)]) for _ in range(6)]
    for i, p in enumerate(prompts):
        for b, Req, reqs in ((pair.j, JaxRequest, pair.jreqs),
                             (pair.t, Request, pair.treqs)):
            reqs.append(Req(rid=i, prompt=p, max_new=6, namespace="t"))
            b.submit(reqs[-1])
    multi = 0
    while pair.t.queue or any(pair.t.slot_req):
        pair.step()
        pair.assert_same()
        tab = pair.t.pages.table.numpy()
        _, counts = np.unique(tab[tab >= 0], return_counts=True)
        multi = max(multi, int((counts > 1).sum()))
    b = pair.t
    assert all(len(r.out) > 0 for r in pair.treqs)
    assert b.stats.prefix_hits > 0 and multi > 0
    assert b.stats.audit_repairs == 0 and b.stats.quarantined_pages == 0


def test_audit_under_overlap_repairs_the_chunks_table(models):
    """overlap=True: the admission dispatched behind a chunk writes the
    table in place; the audit reads the copy packed before it (the
    reference's ``jnp.copy`` snapshot) and repairs the live table.  The
    corruption lands in a round where an admission runs behind the chunk,
    and every round of both packages agrees."""
    pair = _Pair(models, paged=True, page_size=8, audit=True, overlap=True)
    pair.submit(_prompts(pair.cfg, 8, seed=5), [6, 14, 9, 20])
    for _ in range(3):
        pair.step()
        pair.assert_same()
    # a live slot claims another live slot's page, in a round with queued
    # work behind it
    live = [i for i, r in enumerate(pair.t.slot_req) if r is not None]
    assert len(live) >= 2 and pair.t.queue
    row = pair.t.pages.table[live[1]].numpy()
    stolen = int(row[row >= 0][-1])
    pair.j.inject_kv_corruption(live[0], pid=stolen)
    pair.t.inject_kv_corruption(live[0], pid=stolen)
    rounds = pair.t.stats.overlap_rounds
    pair.step()
    pair.assert_same()
    assert pair.t.stats.overlap_rounds == rounds + 1   # admission behind it
    assert stolen in pair.t._quarantined
    pair.run()
    pair.assert_same()
    assert all(r.done and len(r.out) == r.max_new for r in pair.treqs)
    _quarantine_partition(pair.t)


def test_audit_reads_the_table_the_chunk_left(models):
    """A table write after the chunk's dispatch (an admission behind it
    under overlap, here a corruption) is not in the copy the audit reads:
    it is repaired at the next chunk's sync, not this one, in both
    packages."""
    pair = _Pair(models, paged=True, page_size=8, audit=True)
    pair.submit(_prompts(pair.cfg, 4), [32])
    pair.step(2)
    for b in (pair.j, pair.t):
        active = [i for i, r in enumerate(b.slot_req) if r is not None]
        pending = b._dispatch_chunk(active)
        b.inject_kv_corruption(0)
        b._finish_chunk(pending)
    pair.assert_same()
    assert pair.t.stats.audit_repairs == 0
    assert int(pair.t.pages.table[0].max()) == pair.t.n_pages + 7
    pair.step()
    pair.assert_same()
    assert pair.t.stats.audit_repairs >= 1 and pair.t.slot_req[0] is None
    pair.run()
    pair.assert_same()
    _quarantine_partition(pair.t)


@pytest.mark.parametrize("mode", ["paged", "prefix", "overlap"])
def test_audit_adds_no_host_sync_without_a_fault(models, mode):
    """With nothing to repair the audit rides the chunk's one fetch: every
    counter, ``host_syncs`` and ``dispatches`` included, equals the run
    without the audit, and equals the reference's with it."""
    _, cfg = _configs()
    kw = dict(paged=True, page_size=8)
    if mode == "prefix":
        kw.update(prefix_cache=True, prompt_len=16)
    if mode == "overlap":
        kw.update(overlap=True)
    prompts = _prompts(cfg, 8, seed=9)
    runs = {}
    for audit in (False, True):
        pair = _Pair(models, audit=audit, **kw)
        pair.submit(prompts, [5, 9, 12])
        pair.run()
        pair.assert_same()
        runs[audit] = _state(pair.t, pair.treqs)
    assert runs[True] == runs[False]
    assert runs[True]["stats"]["host_syncs"] == \
        runs[True]["stats"]["chunks"] + runs[True]["stats"]["prefills"]


def test_guard_pushes_count_as_page_pushes(models):
    """Every push a guard dispatches is a dispatch without a sync, so
    ``dispatches - page_pushes`` still counts admissions and chunks."""
    pair = _Pair(models, paged=True, page_size=8, audit=True)
    pair.submit(_prompts(pair.cfg, 4), [32])
    pair.step(2)
    row1 = pair.t.pages.table[1].numpy()
    pair.t.inject_kv_corruption(0, pid=int(row1[row1 >= 0][0]))
    pair.t.run(max_steps=4000)
    st = pair.t.stats
    assert pair.t.page_pushes >= 2
    assert st.dispatches - pair.t.page_pushes == st.prefills + st.chunks


# ---------------------------------------------------------------------------
# the guards under speculative decode (draft-and-verify windows)
# ---------------------------------------------------------------------------


SPEC = dict(speculative=True, page_size=8, audit=True)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_nan_sentinel_requeues_like_reference(models, paged):
    pair = _Pair(models, paged=paged, **SPEC)
    pair.submit(_prompts(pair.cfg, 4), [32])
    pair.step()
    _poison_jax(pair.j)
    _poison_port(pair.t.caches)
    pair.step()
    pair.assert_same()
    assert pair.t.stats.poisoned_slots >= 1
    pair.run()
    pair.assert_same()
    assert all(len(r.out) > 0 for r in pair.treqs)
    assert not any(pair.t.slot_req)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_watchdog_trips_like_reference(models, paged):
    pair = _Pair(models, clock=lambda: 0.0, watchdog_s=0.5, paged=paged,
                 **SPEC)
    pair.submit(_prompts(pair.cfg, 2), [32])
    pair.step()
    for b in (pair.j, pair.t):
        b.inject_stall(0, 1.0)
    pair.step()
    pair.assert_same()
    assert pair.t.stats.watchdog_trips == 1 and pair.t.slot_req[0] is None
    pair.run()
    pair.assert_same()
    assert all(len(r.out) > 0 for r in pair.treqs)


@pytest.mark.parametrize("impl,overlap", [("torch", False), ("torch", True),
                                          ("cuda", False)],
                         ids=["serial", "overlap", "cuda"])
def test_spec_audit_quarantines_double_mapped_page_like_reference(
        models, impl, overlap):
    pair = _Pair(models, impl=impl, paged=True, overlap=overlap, **SPEC)
    pair.submit(_prompts(pair.cfg, 8, seed=5), [32, 40])
    pair.step()
    pair.assert_same()
    row1 = pair.t.pages.table[1].numpy()
    stolen = int(row1[row1 >= 0][0])
    pair.j.inject_kv_corruption(0, pid=stolen)
    pair.t.inject_kv_corruption(0, pid=stolen)
    pair.step()
    pair.assert_same()
    assert stolen in pair.t._quarantined
    pair.run()
    pair.assert_same()
    assert all(r.done and len(r.out) == r.max_new for r in pair.treqs)
    _quarantine_partition(pair.t)


# the counters an out-of-range id moves in the port's corrupt window: the
# port reads the entry as unmapped where the reference attends the trash
# page (ROADMAP.md Queue 3), and here that accepts one more draft
SPEC_OUT_OF_RANGE_DELTA = dict(accepted_tokens=1, device_draft_accepted=1,
                               decode_tokens=1, slot_busy_steps=1,
                               oom_discarded_tokens=1)


def test_spec_out_of_range_id_differs_from_reference_by_one_draft(models):
    """8 requests, one clean round, then an out-of-range id in slot 0's
    table.  The corrupt window leaves the port exactly
    ``SPEC_OUT_OF_RANGE_DELTA`` ahead of the reference, and the run ends
    so; tokens, every other counter, slots, tables, free stack, ledger and
    quarantine are equal every round."""
    pair = _Pair(models, paged=True, **SPEC)
    pair.submit(_prompts(pair.cfg, 8), [32, 40])
    pair.step()
    pair.assert_same()
    pair.j.inject_kv_corruption(0)
    pair.t.inject_kv_corruption(0)

    def assert_delta():
        want, got = _state(pair.j, pair.jreqs), _state(pair.t, pair.treqs)
        delta = {k: got["stats"][k] - want["stats"][k]
                 for k in want["stats"] if got["stats"][k] != want["stats"][k]}
        assert delta == SPEC_OUT_OF_RANGE_DELTA
        want.pop("stats"), got.pop("stats")
        assert got == want

    pair.step()
    assert_delta()
    assert pair.t.stats.audit_repairs >= 1
    pair.run()
    assert_delta()
    assert all(r.done and len(r.out) == r.max_new for r in pair.treqs)
    _quarantine_partition(pair.t)


def _init_pools(cfg, P, ps, seed):
    """The port's paged caches (one attention position per period of the
    reduced qwen3), filled with seeded random K/V."""
    from repro_torch.models import init_paged_caches

    rng = np.random.default_rng(seed)
    port = init_paged_caches(cfg, 1, P, ps, device="cpu")
    for view in port.kv.values():
        for t in view:
            t.copy_(torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    return port


def _jax_pools(jcfg, port, P, ps):
    """The reference's paged caches holding the same K/V as ``port``."""
    from repro.models import init_paged_caches as jax_init_paged_caches

    jc = jax_init_paged_caches(jcfg, 1, P, ps)
    return jc._replace(kv={
        key: type(jc.kv[key])(k=jnp.asarray(view.k.numpy()),
                              v=jnp.asarray(view.v.numpy()))
        for key, view in port.kv.items()})


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_out_of_range_entry_reads_as_unmapped(models, impl):
    """A corrupt table entry outside ``[0, n_pages)`` reads as unmapped in
    the port (its kernel skips such pages too), so a slot's logits in the
    chunk before the audit equal those with the entry cleared, here and in
    the reference.  The reference's XLA path instead clamps the gather to
    the trash page and attends it as valid (ROADMAP.md Queue 3): its logits
    with the corrupt entry differ."""
    from repro.models import decode_step as jax_decode_step
    from repro_torch.models import decode_step

    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    ps, P = 4, 12
    port = _init_pools(cfg, P, ps, seed=2)
    jc = _jax_pools(jcfg, port, P, ps)
    table = np.asarray([[3, 7, 1, -1], [0, 5, 9, -1]], np.int32)
    bad, cleared = table.copy(), table.copy()
    bad[0, 0] = P + 7
    cleared[0, 0] = -1
    cur = np.asarray([10, 9], np.int32)
    toks = rng.integers(1, cfg.vocab, size=2).astype(np.int32)

    def port_logits(table):          # each call writes its own fresh pool
        out, _ = decode_step(params, torch.from_numpy(toks),
                             _init_pools(cfg, P, ps, seed=2),
                             torch.from_numpy(cur), cfg, impl=impl,
                             page_table=torch.from_numpy(table))
        return out.numpy()

    def jax_logits(table):
        out, _ = jax_decode_step(jp, jnp.asarray(toks), jc, jnp.asarray(cur),
                                 jcfg, impl="xla",
                                 page_table=jnp.asarray(table))
        return np.asarray(out)

    got = port_logits(bad)
    np.testing.assert_array_equal(got, port_logits(cleared))
    np.testing.assert_allclose(got, jax_logits(cleared), rtol=1e-4, atol=1e-4)
    assert np.abs(jax_logits(bad)[0] - jax_logits(cleared)[0]).max() > 1e-3


def test_admission_writes_a_popped_out_of_range_id_to_the_trash_page(models):
    """A slot that finishes in the chunk after a corruption pushes its
    corrupt entry onto the free stack before the audit can see it; the
    next admission pops it.  The reference's scatter drops that write and
    torch would raise: the port writes the trash page.  Tokens, rows and
    the page state equal the reference's, and the pool outside the trash
    page too."""
    from repro.serving import engine as jeng
    from repro_torch.serving import PageState, ServeConfig, SlotState
    from repro_torch.serving import make_paged_admit_step

    jp, params = models
    jcfg, cfg = _configs()
    rng = np.random.default_rng(4)
    B, ps, P, maxp = 2, 4, 8, 4
    port = _init_pools(cfg, P, ps, seed=5)
    jc = _jax_pools(jcfg, port, P, ps)
    toks = rng.integers(1, cfg.vocab, size=(2, 6)).astype(np.int32)
    free = np.full((P + 1,), -1, np.int32)
    free[:6] = [0, 1, 2, 3, 4, P + 7]         # the corrupt id on top
    pages = dict(table=np.full((B, maxp), -1, np.int32), free=free,
                 free_top=np.int32(6), quota=np.int32(P),
                 pinned=np.zeros((B,), np.int32))
    state = dict(tokens=np.zeros((B,), np.int32),
                 cur_pos=np.zeros((B,), np.int32),
                 active=np.zeros((B,), bool),
                 remaining=np.zeros((B,), np.int32),
                 eos=np.full((B,), -1, np.int32))
    args = dict(slots=np.asarray([0, 1], np.int32),
                pos0=np.full((2,), 6, np.int32),
                budget=np.asarray([5, 5], np.int32),
                eos=np.full((2,), -1, np.int32),
                real=np.asarray([True, True]),
                pin=np.zeros((2,), np.int32))
    names = ("slots", "pos0", "budget", "eos", "real", "pin")
    nxt, port, st, pg, rows = make_paged_admit_step(
        cfg, ServeConfig(max_len=16, attn_impl="torch"))(
        params, {"tokens": torch.from_numpy(toks)}, port,
        SlotState(**{k: torch.from_numpy(v.copy()) for k, v in state.items()}),
        PageState(**{k: torch.from_numpy(np.asarray(v))
                     for k, v in pages.items()}),
        *(torch.from_numpy(args[k]) for k in names))
    jnxt, jc, jst, jpg, jrows = jeng.make_paged_admit_step(
        jcfg, jeng.ServeConfig(max_len=16))(
        jp, {"tokens": jnp.asarray(toks)}, jc,
        jeng.SlotState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jeng.PageState(**{k: jnp.asarray(v) for k, v in pages.items()}),
        *(jnp.asarray(args[k]) for k in names))
    for a, b in [(nxt, jnxt), (rows, jrows), (pg.table, jpg.table),
                 (pg.free_top, jpg.free_top)] + list(zip(st, jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(pg.table.max()) == P + 7       # mapped, for the audit to find
    for key, view in port.kv.items():
        for a, b in zip(view, jc.kv[key]):
            np.testing.assert_allclose(a.numpy()[:, :-1],
                                       np.asarray(b)[:, :-1],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial", "overlap"])
def test_corrupt_slot_finishing_in_its_chunk_like_reference(models, overlap):
    """The corrupted slot finishes in the chunk after the injection, so the
    device pushes its corrupt id onto the free stack before the audit;
    admission later pops it into another slot, whose next audit requeues
    it.  Counters, slots, queue, tables, free stack, pins, ledger and
    quarantine equal the reference's every round.  Tokens equal too except
    for the requests that attended the corrupt id: the reference reads it
    as the trash page, the port as unmapped (ROADMAP.md Queue 3), and
    those two requests keep what they decoded (one finishes, one's
    tokens fit its prompt bucket)."""
    pair = _Pair(models, slots=2, prompt_len=8, paged=True, page_size=16,
                 audit=True, overlap=overlap)
    pair.submit(_prompts(pair.cfg, 6), [6, 20])
    pair.step()
    victim = pair.t.slot_req[0].rid
    pair.j.inject_kv_corruption(0)
    pair.t.inject_kv_corruption(0)
    read_corrupt = {victim}
    audit = pair.t._run_audit

    def audit_and_note(table_np):        # the audit's victims read the id
        before = {r.rid for r in pair.t.slot_req if r is not None}
        audit(table_np)
        read_corrupt.update(
            before - {r.rid for r in pair.t.slot_req if r is not None})

    pair.t._run_audit = audit_and_note
    while pair.t.queue or any(pair.t.slot_req):
        pair.step()
        a, b = _state(pair.t, pair.treqs), _state(pair.j, pair.jreqs)
        ta, tb = a.pop("tokens"), b.pop("tokens")
        assert a == b
        assert [t for i, t in enumerate(ta) if i not in read_corrupt] == \
            [t for i, t in enumerate(tb) if i not in read_corrupt]
    # serial, admission pops the corrupt id into request 2's slot; with
    # overlap the page fault of a decoding slot pops it first
    assert read_corrupt == ({0} if overlap else {0, 2})
    assert pair.t.stats.audit_repairs >= 1
    assert (pair.t.stats.overlap_rounds > 0) == overlap
    assert all(r.done and len(r.out) == r.max_new for r in pair.treqs)
    _quarantine_partition(pair.t)


# ---------------------------------------------------------------------------
# CORE_SLOW -> straggler probes, through the port's VirtualEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet_artifacts():
    """resnet50's artifact from each package, compiled under one pinned
    ``time.perf_counter`` so the engines' timelines can be compared."""
    out = {}
    real = time.perf_counter
    for key, core in (("jax", jcore), ("torch", tcore)):
        n = [0]

        def clock():
            n[0] += 1
            return n[0] * 1e-5

        time.perf_counter = clock
        try:
            out[key] = core.StaticCompiler(core.fpga_small_core(),
                                           n_tiles=16).compile(
                core.CNN_WORKLOADS["resnet50"]())
        finally:
            time.perf_counter = real
    return out


@pytest.fixture
def pinned(monkeypatch):
    n = [0]

    def clock():
        n[0] += 1
        return n[0] * 1e-5

    monkeypatch.setattr(time, "perf_counter", clock)

    def reset():
        n[0] = 0

    return reset


def test_exec_fault_sets_and_clears_slowdown():
    def run(core):
        eng = core.VirtualEngine(core.ResourcePool(8), core.fpga_small_core())
        f = core.FaultSpec(time=1.0, kind=core.FaultKind.CORE_SLOW, fid=0,
                           core=3, factor=3.0, duration=2.0)
        eng.exec_fault(f, 1.0)
        seen = [dict(eng.core_slowdown)]
        eng.exec_fault(dataclasses.replace(f, factor=2.0), 1.5)
        seen.append(dict(eng.core_slowdown))
        eng.exec_recover(f, 3.0)
        seen.append(dict(eng.core_slowdown))
        return seen

    got = run(tcore)
    assert got == run(jcore)
    assert got == [{3: 3.0}, {3: 3.0}, {}]   # escalation keeps the max


def test_injected_slowdown_trips_straggler_probe_like_reference(
        resnet_artifacts, pinned):
    """CORE_SLOW shows up in core_slowdown, the next probe rebalances the
    tenant's tiles, and the repair clears it; both packages' engines give
    the same metrics, fault and recovery logs."""
    def run(core, art):
        pinned()
        pool = core.ResourcePool(16)
        eng = core.VirtualEngine(pool, core.fpga_small_core(),
                                 straggler_threshold=1.3)
        hv = core.Hypervisor(pool, policy="no_realloc", executor=eng,
                             probe_interval=0.05)
        hv.schedule_arrival(core.TenantSpec("t", 8, artifact=art), at=0.0)
        hv.schedule_fault(core.FaultSpec(time=0.1,
                                         kind=core.FaultKind.CORE_SLOW,
                                         fid=0, core=0, factor=3.0,
                                         duration=0.3))
        m = hv.run(0.6)["t"]
        return {"completions": m.completions, "rebalances": m.rebalances,
                "ctx": (m.ctx_switches, m.ctx_overhead),
                "slowdown": dict(eng.core_slowdown),
                "faults": [(f.fid, f.kind.value, f.time, f.core)
                           for f in hv.fault_log],
                "recovery": [sorted(r.items()) for r in hv.recovery_log]}

    got = run(tcore, resnet_artifacts["torch"])
    assert got == run(jcore, resnet_artifacts["jax"])
    assert got["rebalances"] >= 1
    assert got["slowdown"] == {}             # RECOVERY cleared it


# ---------------------------------------------------------------------------
# preemption rollback under a shrinking pool
# ---------------------------------------------------------------------------


class _ChaosExecutor:
    """Pool-backed executor that records its calls and can kill a core
    *inside* ``exec_evict``: hardware that dies mid-context-switch."""

    def __init__(self, pool, fail_on_evict=None):
        self.pool = pool
        self.fail_on_evict = fail_on_evict
        self.calls = []
        self.faults = []

    def advance(self, t):
        pass

    def exec_admit(self, spec, n_cores, at):
        self.calls.append(("admit", spec.name, n_cores))
        self.pool.alloc(spec.name, n_cores)

    def exec_resize(self, name, n_cores, at, mode):
        self.calls.append(("resize", name, n_cores))
        self.pool.resize(name, n_cores)

    def exec_remove(self, name, at):
        self.calls.append(("remove", name))
        self.pool.release(name)

    def exec_evict(self, name, at):
        self.calls.append(("evict", name))
        self.pool.release(name)
        if self.fail_on_evict is not None:
            self.pool.mark_failed(self.fail_on_evict)
            self.fail_on_evict = None

    def exec_kv_resize(self, name, pages, at):
        self.calls.append(("kv", name, pages))

    def exec_fault(self, fault, at):
        self.faults.append(("fault", fault.kind.value, fault.core, at))

    def exec_recover(self, fault, at):
        self.faults.append(("recover", fault.kind.value, fault.core, at))


def _rollback_result(hv, pool, ex):
    return {"alloc": hv.allocation(), "kv": dict(pool.kv_leases),
            "waiting": hv.waiting_tenants(),
            "displaced": sorted(hv._displaced_at), "calls": ex.calls,
            "faults": ex.faults,
            "cores": {n: sorted(pool.lease_of(n).cores)
                      for n in hv.allocation()},
            "recovery": [sorted(r.items()) for r in hv.recovery_log]}


def test_rollback_aborts_loudly_when_pool_shrank():
    def run(core, err):
        pool = core.ResourcePool(n_cores=4, n_kv_pages=100)
        ex = _ChaosExecutor(pool, fail_on_evict=0)
        hv = core.Hypervisor(pool, executor=ex, preemptive=True)
        assert hv.admit(core.TenantSpec("low", 4, min_cores=4, priority=1.0,
                                        requested_kv_pages=40,
                                        min_kv_pages=40), at=0.0)
        with pytest.raises(err, match="rollback could not restore"):
            hv.admit(core.TenantSpec("hi", 4, min_cores=4, priority=2.0,
                                     arrived_at=1.0), at=1.0)
        pool.check_isolation()
        pool.check_kv_quota()
        pool.check_health()
        return _rollback_result(hv, pool, ex)

    got = run(tcore, HRPError)
    assert got == run(jcore, JaxHRPError)
    assert got["waiting"][0] == "low" and "low" in got["displaced"]
    assert got["alloc"] == {} and got["kv"] == {}


def test_rollback_restores_exactly_on_healthy_remainder():
    def run(core):
        pool = core.ResourcePool(n_cores=4, n_kv_pages=100)
        ex = _ChaosExecutor(pool, fail_on_evict=3)   # kill a FREE core
        hv = core.Hypervisor(pool, executor=ex, preemptive=True)
        assert hv.admit(core.TenantSpec("low", 2, min_cores=2, priority=1.0,
                                        requested_kv_pages=30,
                                        min_kv_pages=30), at=0.0)
        assert not hv.admit(core.TenantSpec("hi", 4, min_cores=4,
                                            priority=2.0, arrived_at=1.0),
                            at=1.0)
        pool.check_isolation()
        pool.check_kv_quota()
        pool.check_health()
        return _rollback_result(hv, pool, ex)

    got = run(tcore)
    assert got == run(jcore)
    assert got["alloc"] == {"low": 2} and got["kv"] == {"low": 30}
    assert 3 not in got["cores"]["low"] and got["waiting"] == ["hi"]


def test_recovered_core_readmits_rollback_casualty():
    def run(core, err):
        pool = core.ResourcePool(n_cores=4, n_kv_pages=100)
        ex = _ChaosExecutor(pool, fail_on_evict=0)
        hv = core.Hypervisor(pool, executor=ex, preemptive=True)
        hv.admit(core.TenantSpec("low", 4, min_cores=4, priority=1.0), at=0.0)
        with pytest.raises(err):
            hv.admit(core.TenantSpec("hi", 4, min_cores=4, priority=2.0,
                                     arrived_at=1.0), at=1.0)
        hv.recover_core(0, at=2.0)
        return _rollback_result(hv, pool, ex)

    got = run(tcore, HRPError)
    assert got == run(jcore, JaxHRPError)
    assert got["alloc"] == {"low": 4}
    rec = dict(got["recovery"][-1])
    assert rec["tenant"] == "low"
    assert rec["recovery_latency"] == pytest.approx(1.0)
