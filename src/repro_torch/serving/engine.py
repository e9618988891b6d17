"""Inference engine: prefill, chunked decode, speculative (draft-and-verify)
decode and admission steps, and a host ``generate`` loop, on dense KV
caches and on the paged pool.

Counterpart of the dense, paged and speculative parts of
``repro.serving.engine``.  The contract is
the reference's: :func:`make_decode_chunk` runs ``n_steps`` decode
iterations with the slot bookkeeping (:class:`SlotState`: active mask,
positions, EOS and budget detection) on the device, so a batcher issues one
dispatch and one host sync per chunk instead of per token.  Nothing inside
the T-step loop reads a value back to the host.

Where JAX jits these programs with ``donate_argnums`` so XLA updates the
ring-buffer KV in place, the port updates the caches **in place** directly
(``index_put_`` on views of the stacked cache); PyTorch runs eagerly, so the
reference's ``ProgramRegistry`` of compiled programs has no counterpart.
Every ``make_*`` takes the reference's ``policy=None`` (the model's
activation-policy hook), and :func:`tp_program` runs one of them
tensor-parallel over a :class:`~repro_torch.distributed.ShardGroup`.
Under an SPMD policy (``distributed.spmd``) a program takes the whole
slot, page and draft state on every rank and runs the model on the
rank's rows: its bookkeeping is taken alike on every rank from what one
gather a step brings back.

Invariant: a slot that deactivates mid-chunk (EOS or token budget) keeps
decoding with its position frozen — it overwrites its *own* ring slot with
dead values, which is safe because admission re-seeds the slot's cache from
prefill before it is reused.  (Paged: a finished slot's table row is
cleared in the same step, so its later writes land on the trash page.)

The paged steps keep the page allocator on the device, as the reference
does: the free stack, its pointer ``free_top`` and the lease ``quota`` are
tensors; grants are cumsum-ranked on the device; the host learns
``free_top`` only from the chunk's single fetch.  Three torch hazards are
handled explicitly where JAX's semantics are implicit: an index past the
page table (a stopped slot at ``cur_pos == max_len`` with ``max_len %
page_size == 0``) is clamped and masked, and so is a page id outside the
pool that a corrupt table entry put on the free stack, since torch raises
where JAX clamps a gather and drops a scatter; and duplicate-index
scatters only ever write identical values or land on a scratch element or
the trash page, since ``index_put_`` does not say which duplicate wins.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.common import (
    add_launches, close_launch_tally, open_launch_tally,
)
from ..models import (
    decode_step, encoder_forward, prefill, prefix_prefill, verify_step,
)
from ..models.attention import check_attn_impl
from ..models.transformer import Caches, prefill_kv
from ..obs import NULL_TRACER
from ..tree import leaves
from .kv_cache import pages_for


@functools.lru_cache(maxsize=32)
def _logit_mask(vocab: int, vocab_padded: int, device: torch.device):
    """Additive mask (Vp,) on ``device`` — 0 on the real vocab, -inf on
    padding.  Built once per device and reused by every step."""
    if vocab_padded <= vocab:
        return None
    m = np.zeros((vocab_padded,), np.float32)
    m[vocab:] = -np.inf
    return torch.from_numpy(m).to(device)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    attn_impl: str = "cuda"      # see models.attention.ATTN_CAPABILITIES
    greedy: bool = True
    temperature: float = 1.0
    chunk: int = 8               # max decode steps fused per dispatch

    def __post_init__(self):
        check_attn_impl(self.attn_impl, "dense")

    def logit_mask(self, cfg, device):
        return _logit_mask(cfg.vocab, cfg.vocab_padded, torch.device(device))


def chunk_bucket(n: int) -> int:
    """Largest power of two ≤ n — the fixed set of chunk/prefill shapes."""
    return 1 << (max(n, 1).bit_length() - 1)


def select_token(logits, mask, scfg: ServeConfig,
                 generator: Optional[torch.Generator] = None):
    """Greedy or sampled next-token selection under the vocab-padding mask.
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if scfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / scfg.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _slot_rows(policy, B: int) -> Optional[slice]:
    """This rank's rows of a whole slot state of ``B`` rows under an SPMD
    policy that splits the slots over the data axes (a policy batcher's
    layout: the bookkeeping whole on every rank, the model on the rank's
    rows; ``distributed.spmd``), else None: no such policy, slots that do
    not split, or a state of fewer rows than the policy's batch, which is
    already the rank's own."""
    if not hasattr(policy, "row_block") or B != policy.batch:
        return None
    blk = policy.row_block()
    return None if blk is None else slice(*blk)


def _bucket_rows(policy, n: int) -> Optional[slice]:
    """This rank's rows of an admission bucket of ``n`` rows: the bucket is
    split by its own size (``batch_shard(mesh, n)``), not the slots'; None
    where it runs whole on every data group."""
    blk = policy.row_block(n) if hasattr(policy, "row_block") else None
    return None if blk is None else slice(*blk)


def _take(x, rows: Optional[slice]):
    return x if rows is None else x[rows]


def _select_rows(logits, mask, scfg, generator, policy, rows):
    """The next token and the finite flag of each row (on the raw logits,
    before the vocab mask), all-gathered over the data axes when the model
    ran on the rank's ``rows``: one collective for what the bookkeeping
    reads."""
    finite = torch.isfinite(logits).all(dim=-1)
    nxt = select_token(logits, mask, scfg, generator)
    if rows is not None:
        nxt, finite = policy.gather_rows(nxt, finite)
    return nxt, finite


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg, scfg: ServeConfig, *, policy=None):
    """prefill_step(params, batch) -> (last-token logits, Caches).

    batch: {"tokens": (B, S) int32} + the family's extras: the VLM's
    ``extra_embeds`` (B, S_vis, d) and ``positions`` (3, B, S_vis + S),
    the audio family's ``frames`` (B, S_enc, d), which the encoder runs
    over first."""

    def prefill_step(params, batch):
        kw = {}
        if cfg.family == "vlm":
            kw["extra_embeds"] = batch["extra_embeds"]
            kw["positions"] = batch["positions"]
        if cfg.family == "audio":
            kw["enc_out"] = encoder_forward(params, batch["frames"], cfg,
                                            impl=scfg.attn_impl, policy=policy)
        return prefill(params, batch["tokens"], cfg, max_len=scfg.max_len,
                       impl=scfg.attn_impl, policy=policy, **kw)

    return prefill_step


def make_serve_step(cfg, scfg: ServeConfig, *, policy=None):
    """serve_step(params, tokens (B,), caches, cur_pos (B,), key=None) ->
    (next_tokens (B,) int32, logits (B, Vp), caches).

    One decode step, the counterpart of the reference's ``make_serve_step``
    (the decode cells' program): the vocab-padding mask is added to the
    returned logits before the token is selected.  ``key`` stands where the
    reference takes a PRNG key: a ``torch.Generator`` for sampling, or None.
    The caches are updated in place and returned as the same object."""

    def serve_step(params, tokens, caches: Caches, cur_pos,
                   key: Optional[torch.Generator] = None):
        logits, caches = decode_step(params, tokens, caches, cur_pos, cfg,
                                     impl=scfg.attn_impl, policy=policy)
        mask = scfg.logit_mask(cfg, logits.device)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        return select_token(logits, None, scfg, key), logits, caches

    return serve_step


# ---------------------------------------------------------------------------
# Chunked decode with on-device slot bookkeeping
# ---------------------------------------------------------------------------


class SlotState(NamedTuple):
    """Per-slot decode bookkeeping, resident on the device between chunks.

    tokens:     (B,) int32 — last emitted token (next decode input)
    cur_pos:    (B,) int32 — absolute position the next token writes to
    active:     (B,) bool  — slot is mid-generation
    remaining:  (B,) int32 — decode tokens left until the slot's max budget
    eos:        (B,) int32 — per-slot EOS id, -1 = none
    """

    tokens: torch.Tensor
    cur_pos: torch.Tensor
    active: torch.Tensor
    remaining: torch.Tensor
    eos: torch.Tensor


def init_slot_state(batch: int, *, device="cuda") -> SlotState:
    device = resolve_device(device)
    return SlotState(
        tokens=torch.zeros((batch,), dtype=torch.int32, device=device),
        cur_pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        active=torch.zeros((batch,), dtype=torch.bool, device=device),
        remaining=torch.zeros((batch,), dtype=torch.int32, device=device),
        eos=torch.full((batch,), -1, dtype=torch.int32, device=device),
    )


def make_decode_chunk(cfg, scfg: ServeConfig, n_steps: int, *, policy=None,
                      tracer=NULL_TRACER):
    """decode_chunk(params, caches, state, generator=None) ->
    (caches, state, tokens (T, B), emitted (T, B), poisoned (B,)).

    ``n_steps`` decode iterations with EOS and token-budget detection on the
    device: a slot that finishes deactivates immediately, its position
    freezes, and later iterations emit nothing for it (``emitted`` is the
    validity mask).  ``poisoned`` is the fault sentinel: a slot whose logits
    come back non-finite is deactivated *before* its token is selected, and
    the check runs on the raw logits, before the additive vocab mask puts
    -inf on the padding.

    The caches are updated **in place** and returned as the same object
    (the reference returns new caches under buffer donation); the slot state
    is returned as new tensors.  No value is read back to the host inside
    the loop.

    With an enabled ``tracer`` under a profiler, each step's model call
    runs inside a ``serving.decode_model`` range; whatever else the chunk
    launches (token selection, the EOS and budget mask, and in the paged
    and speculative twins the page faults, frees and counters) is the
    chunk's bookkeeping.  The three twins below do the same.
    """

    def decode_chunk(params, caches: Caches, state: SlotState,
                     generator: Optional[torch.Generator] = None):
        mask = scfg.logit_mask(cfg, state.tokens.device)
        rows = _slot_rows(policy, state.tokens.shape[0])
        st = state
        poisoned = torch.zeros_like(state.active)
        toks, emitted = [], []
        for _ in range(n_steps):
            with tracer.range("decode_model"):
                logits, caches = decode_step(params, _take(st.tokens, rows),
                                             caches, _take(st.cur_pos, rows),
                                             cfg, impl=scfg.attn_impl,
                                             policy=policy)
            nxt, finite = _select_rows(logits, mask, scfg, generator,
                                       policy, rows)
            bad = st.active & ~finite
            active = st.active & ~bad
            nxt = torch.where(active, nxt, st.tokens)
            remaining = st.remaining - active.to(torch.int32)
            done = active & ((nxt == st.eos) | (remaining <= 0))
            st = SlotState(
                tokens=nxt,
                cur_pos=st.cur_pos + active.to(torch.int32),
                active=active & ~done,
                remaining=remaining,
                eos=st.eos,
            )
            poisoned = poisoned | bad
            toks.append(nxt)
            emitted.append(active)
        return caches, st, torch.stack(toks), torch.stack(emitted), poisoned

    return decode_chunk


def _merge_fresh(resident, fresh, idx, policy=None) -> None:
    """Scatter each freshly prefilled per-slot tensor (stacked over blocks,
    slots on axis 1) into the resident tree's rows ``idx``, in place.
    Under an SPMD policy that splits the slots the resident tree holds
    only the rank's slots: each rank keeps the bucket's rows of its own."""
    blk = policy.row_block() if hasattr(policy, "row_block") else None
    if blk is not None:
        lo, hi = blk
        mine = (idx >= lo) & (idx < hi)
        fresh = {p: tuple(t[:, mine] for t in v) for p, v in fresh.items()}
        idx = idx[mine] - lo
    for p, old in resident.items():
        for o, n in zip(old, fresh[p]):
            o[:, idx] = n.to(o.dtype)


def make_admit_step(cfg, scfg: ServeConfig, *, policy=None):
    """admit_step(params, batch, caches, state, slots, pos0, budget, eos) ->
    (first_tokens (n,), caches, state).

    Right-sized admission: ``batch["tokens"]`` is (n, S) for the *bucketed*
    number of joining requests — prefill runs over n rows, not the full slot
    count — and the fresh caches (KV rings and SSM states) are scattered
    into the resident tree per slot, and so is the audio family's
    cross-attention K/V.  The resident caches and slot state are updated
    **in place** (``index_put_``; the reference donates them instead) and
    returned.

    Duplicate entries in ``slots`` are allowed only when they carry
    identical rows (the batcher pads a partial bucket by repeating row 0):
    which duplicate write wins is then irrelevant.

    Under an SPMD policy the bucket runs whole on every data group and
    each rank keeps the rows of its own slots (a ring is per slot; see
    ``distributed.spmd``); the slot state is whole.
    """
    prefill_step = make_prefill_step(cfg, scfg, policy=policy)

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   slots, pos0, budget, eos):
        logits, fresh = prefill_step(params, batch)
        mask = scfg.logit_mask(cfg, logits.device)
        # admission is greedy: the prompt's continuation token
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        idx = slots.long()
        _merge_fresh(caches.kv, fresh.kv, idx, policy)
        _merge_fresh(caches.ssm, fresh.ssm, idx, policy)
        if caches.cross is not None and fresh.cross is not None:
            _merge_fresh(caches.cross, fresh.cross, idx, policy)
        # the admission token already counts toward the budget; a slot with
        # nothing left (or an immediate EOS) never activates
        remaining = budget - 1
        state.tokens[idx] = nxt
        state.cur_pos[idx] = pos0
        state.active[idx] = (remaining > 0) & (nxt != eos)
        state.remaining[idx] = remaining
        state.eos[idx] = eos
        return nxt, caches, state

    return admit_step


# ---------------------------------------------------------------------------
# Paged KV: on-device page tables, free stack and page-fault allocation
# ---------------------------------------------------------------------------


class PageState(NamedTuple):
    """Device-resident page-pool bookkeeping, beside the caches.

    table:    (B, max_pages) int32 — physical page backing each slot's
              logical page (absolute positions [j*ps, (j+1)*ps)); -1 =
              unmapped.  A private physical page is mapped by at most one
              (slot, logical) entry.
    free:     (n_pages + 1,) int32 — stack of free page ids; entries
              [0, free_top) are valid, the last element is scratch for
              masked-out pushes (mirrors the trash page of the pool).
    free_top: () int32 — stack pointer; allocated pages = n_pages - free_top.
    quota:    () int32 — lease cap on allocated pages (the hypervisor's
              ``kv_pages`` dimension); a fault beyond it is denied even if
              the pool has free pages.
    pinned:   (B,) int32 — leading logical pages of each slot's row owned by
              the **prefix cache** (shared, read-only): a finishing slot
              never pushes them back onto the free stack — the host's
              refcount ledger decides when a shared page becomes free.
    """

    table: torch.Tensor
    free: torch.Tensor
    free_top: torch.Tensor
    quota: torch.Tensor
    pinned: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.free.shape[0] - 1


def init_page_state(batch: int, n_pages: int, max_pages: int, *,
                    quota: Optional[int] = None, device="cuda") -> PageState:
    device = resolve_device(device)
    free = torch.full((n_pages + 1,), -1, dtype=torch.int32, device=device)
    free[:n_pages] = torch.arange(n_pages, dtype=torch.int32, device=device)
    q = n_pages if quota is None else min(quota, n_pages)
    return PageState(
        table=torch.full((batch, max_pages), -1, dtype=torch.int32,
                         device=device),
        free=free,
        free_top=torch.tensor(n_pages, dtype=torch.int32, device=device),
        quota=torch.tensor(q, dtype=torch.int32, device=device),
        pinned=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _i32(x):
    return x.to(torch.int32)


def _cumsum(mask):
    return torch.cumsum(_i32(mask), 0, dtype=torch.int32)


def _free_finished_pages(table, free, free_top, finished, pinned):
    """Push every *private* page mapped by a ``finished`` slot back onto the
    free stack (cumsum-ranked scatter; masked-out entries land on the
    scratch element) and clear those table rows.  The slot's first
    ``pinned`` logical pages are cache-owned and are NOT pushed.  Returns
    new (table, free, free_top, pinned); the inputs are not modified."""
    scratch = free.shape[0] - 1
    maxp = table.shape[1]
    private = torch.arange(maxp, device=table.device)[None, :] >= pinned[:, None]
    flat = (finished[:, None] & (table >= 0) & private).reshape(-1)
    idx = torch.where(flat, free_top + _cumsum(flat) - 1, scratch).long()
    free = free.index_put((idx,), table.reshape(-1))
    free_top = free_top + flat.sum(dtype=torch.int32)
    table = torch.where(finished[:, None], -1, table)
    pinned = torch.where(finished, 0, pinned)
    return table, free, free_top, pinned


def make_paged_decode_chunk(cfg, scfg: ServeConfig, n_steps: int,
                            page_size: int, *, policy=None,
                            tracer=NULL_TRACER):
    """decode_chunk(params, caches, state, pages, generator=None) ->
    (caches, state, pages, tokens (T, B), emitted (T, B), poisoned (B,),
    ctr (4,) int32).

    The paged twin of :func:`make_decode_chunk`: the same loop with the same
    EOS/budget bookkeeping and NaN sentinel, plus **page faults inside the
    chunk**: a slot whose write position crosses into an unmapped logical
    page pops a page off the device free stack before the decode step.
    Grants are prefix-ordered by slot index, so a denied slot implies every
    later needer is denied too and pops stay contiguous at the top of the
    stack.  A denied slot (pool dry or quota hit) deactivates without
    emitting — the host sees ``active`` drop without EOS/budget and requeues
    it.  Pages of slots that finish (EOS, budget, denial, non-finite
    logits) go back on the stack in the same step.

    ``ctr`` counts pages popped, pages pushed, slot-steps denied a grant, and
    (speculative twin only; 0 here) drafts accepted; it rides back in the
    chunk's one fetch.  Each step reads the table before the frees clear
    it, and the decode step writes the new token's K/V into the pool before
    attention reads it.  The caches are updated in place; the slot and page
    state come back as new tensors.

    Under an SPMD policy the slot and page state are whole on every rank
    and every grant, pop and push is taken alike on each; the model runs
    on the rank's rows (their tokens, positions and table rows), and the
    chosen tokens and finite flags come back whole (``gather_rows``).
    """
    ps = int(page_size)

    def decode_chunk(params, caches: Caches, state: SlotState,
                     pages: PageState,
                     generator: Optional[torch.Generator] = None):
        dev = state.tokens.device
        mask = scfg.logit_mask(cfg, dev)
        n_pages = pages.free.shape[0] - 1
        B = state.tokens.shape[0]
        maxp = pages.table.shape[1]
        bidx = torch.arange(B, device=dev)
        rows = _slot_rows(policy, B)
        st, pg = state, pages
        poisoned = torch.zeros_like(state.active)
        ctr = torch.zeros((4,), dtype=torch.int32, device=dev)
        toks, emitted = [], []
        for _ in range(n_steps):
            # -- page fault: map the write position's logical page --------
            logical = (st.cur_pos // ps).long()
            inside = logical < maxp
            col = logical.clamp(max=maxp - 1)
            held = pg.table[bidx, col]
            # past the table reads as unmapped (JAX's fill value is < 0)
            cur_pid = torch.where(inside, held, -1)
            need = st.active & (cur_pid < 0)
            rank = _cumsum(need) - 1
            allocated = n_pages - pg.free_top
            got = need & (rank < pg.free_top) & (allocated + rank < pg.quota)
            pid = pg.free[(pg.free_top - 1 - rank).clamp(0, n_pages).long()]
            # a write past the table is dropped, as JAX drops the scatter
            table = pg.table.index_put(
                (bidx, col), torch.where(got & inside, pid, held))
            popped = got.sum(dtype=torch.int32)
            free_top = pg.free_top - popped
            oom = need & ~got
            active = st.active & ~oom
            # -- decode against the (updated) page table ------------------
            with tracer.range("decode_model"):
                logits, caches = decode_step(
                    params, _take(st.tokens, rows), caches,
                    _take(st.cur_pos, rows), cfg, impl=scfg.attn_impl,
                    page_table=_take(table, rows), policy=policy)
            nxt, finite = _select_rows(logits, mask, scfg, generator,
                                       policy, rows)
            bad = active & ~finite
            active = active & ~bad
            nxt = torch.where(active, nxt, st.tokens)
            remaining = st.remaining - _i32(active)
            done = active & ((nxt == st.eos) | (remaining <= 0))
            # -- recycle pages of finished slots --------------------------
            table, free, pushed_top, pinned = _free_finished_pages(
                table, pg.free, free_top, done | oom | bad, pg.pinned)
            ctr = ctr + torch.stack([
                popped, pushed_top - free_top, oom.sum(dtype=torch.int32),
                torch.zeros((), dtype=torch.int32, device=dev)])
            toks.append(nxt)
            emitted.append(active)
            st = SlotState(tokens=nxt, cur_pos=st.cur_pos + _i32(active),
                           active=active & ~done, remaining=remaining,
                           eos=st.eos)
            pg = PageState(table=table, free=free, free_top=pushed_top,
                           quota=pg.quota, pinned=pinned)
            poisoned = poisoned | bad
        return (caches, st, pg, torch.stack(toks), torch.stack(emitted),
                poisoned, ctr)

    return decode_chunk


def _grant_admission_pages(pages: PageState, ask, np_: int):
    """Prefix-feasible page grants for one admission batch: every asking
    row needs ``np_`` pages.  ``cum`` is monotone, so stack/quota denials
    only ever cut a suffix — pops stay contiguous at the stack top.  Shared
    by the cold and cached admission steps.  Returns (ok, grant, pid
    (n, np_), dest, free_top); ``dest`` is the trash page for rows without
    a grant, and for a popped id outside ``[0, n_pages)``: a corrupt table
    entry that a finishing slot pushed back before the page-table audit
    saw it, whose write JAX drops and torch would raise on."""
    n_pages = pages.free.shape[0] - 1
    cum = _cumsum(ask) * np_
    allocated = n_pages - pages.free_top
    ok = (cum <= pages.free_top) & (allocated + cum <= pages.quota)
    grant = ask & ok
    ranks = ((_cumsum(grant) - 1)[:, None] * np_
             + torch.arange(np_, dtype=torch.int32, device=ask.device)[None, :])
    pid = pages.free[(pages.free_top - 1 - ranks).clamp(0, n_pages).long()]
    dest = torch.where(grant[:, None] & (pid >= 0) & (pid < n_pages), pid,
                       n_pages)
    free_top = pages.free_top - grant.sum(dtype=torch.int32) * np_
    return ok, grant, pid, dest, free_top


def _scatter_fresh_kv(caches_kv, fresh_kv, dest, *, S: int, np_: int,
                      ps: int, n: int) -> None:
    """Scatter freshly prefilled K/V (per layer: (nb, n, S, Hkv, dh)) into
    the popped pool pages at ``dest`` ((n, np_); the trash page for rows
    without a grant, the only index written more than once), in place.
    ``fresh_kv`` maps layer key -> (k, v)."""
    pad = np_ * ps - S
    idx = dest.reshape(-1).long()

    def to_pages(a):
        # (nb, n, S, ...) -> (nb, n * np_, ps, ...)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(a.shape[0], n * np_, ps, *a.shape[3:])

    for p, view in caches_kv.items():
        k, v = fresh_kv[p]
        view.k[:, idx] = to_pages(k).to(view.k.dtype)
        view.v[:, idx] = to_pages(v).to(view.v.dtype)


def _page_size(caches: Caches) -> int:
    for view in caches.kv.values():
        return view.k.shape[2]           # (nb, n_pages + 1, ps, Hkv, dh)
    raise ValueError("paged admission needs at least one attention layer")


def _admit_state(state: SlotState, pages: PageState, slots, nxt, pos0,
                 remaining, eos, act_vals, pin_vals, table,
                 free_top) -> PageState:
    """The per-slot writes shared by both admission steps: slot state in
    place; the page state's table, stack pointer and pin plan come back as
    a new PageState."""
    idx = slots.long()
    state.tokens[idx] = nxt
    state.cur_pos[idx] = pos0
    state.active[idx] = act_vals
    state.remaining[idx] = remaining
    state.eos[idx] = eos
    return pages._replace(table=table, free_top=free_top,
                          pinned=pages.pinned.index_put((idx,), pin_vals))


def _dup_row0(real, vals):
    """Bucket-padding rows carry row 0's values (the duplicate-scatter
    rule: duplicates of a slot index then write identical values)."""
    if vals.dim() == 1:
        return torch.where(real, vals, vals[0])
    return torch.where(real[:, None], vals, vals[0:1])


def _first_tokens(logits, cfg, scfg: ServeConfig, policy, rows, n: int):
    """The admission's greedy first tokens (n,), all-gathered over the data
    axes when the bucket ran on the rank's ``rows``."""
    mask = scfg.logit_mask(cfg, logits.device)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    if rows is not None:
        (nxt,) = policy.gather_rows(nxt, n=n)
    return nxt


def _whole_fresh(fresh_kv, fresh_ssm, policy, rows, n: int):
    """A split bucket's fresh K/V (``pool_rows``: the pool is whole on every
    data group) and SSM states (``gather_rows``) of every row, (nb, n,
    ...), one collective a period position."""
    if rows is None:
        return fresh_kv, fresh_ssm
    kv = {p: policy.pool_rows(k, v, n=n, dim=1)
          for p, (k, v) in fresh_kv.items()}
    ssm = {p: type(st)(*policy.gather_rows(*st, n=n, dim=1))
           for p, st in fresh_ssm.items()}
    return kv, ssm


def make_paged_admit_step(cfg, scfg: ServeConfig, *, policy=None):
    """admit_step(params, batch, caches, state, pages, slots, pos0, budget,
    eos, real, pin) -> (first_tokens (n,), caches, state, pages, rows).

    Paged admission: right-sized bucketed prefill as in
    :func:`make_admit_step`, but the fresh K/V is scattered into **freshly
    popped pool pages** and the joining slots' page-table rows are
    rewritten.  ``real`` (n,) bool marks genuine rows — bucket padding
    duplicates row 0 and neither pops pages nor writes conflicting values.
    A row that never activates (immediate EOS, zero budget, allocation
    denied) gets no pages and a cleared table row.  SSM states (hybrid
    archs) stay dense per slot and are scattered into the joining slots as
    the dense admission scatters them.  ``pin`` (n,) int32 is
    the prefix-cache pin plan (how many leading logical pages the host will
    insert into the shared cache after the sync), recorded in
    ``PageState.pinned``.  ``rows`` returns the written table rows so the
    host learns the physical ids it is about to share.  Caches and slot
    state are updated in place; the page state comes back new.

    Under an SPMD policy the bucket is split over the data axes by its own
    size (``batch_shard(mesh, n)``; whole on every data group where ``n``
    does not divide them); the first tokens and the prompt K/V (and SSM
    states) of every row are all-gathered before the bookkeeping and the
    pool write, which every rank takes whole (``distributed.spmd``).
    """

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   pages: PageState, slots, pos0, budget, eos, real, pin):
        ps = _page_size(caches)
        tokens = batch["tokens"]
        n, S = tokens.shape
        rows = _bucket_rows(policy, n)
        # the prompt's K/V in absolute-position order, ready to pack
        logits, fresh, fresh_ssm = prefill_kv(params, _take(tokens, rows),
                                              cfg, impl=scfg.attn_impl,
                                              policy=policy)
        nxt = _dup_row0(real, _first_tokens(logits, cfg, scfg, policy, rows,
                                            n))
        fresh, fresh_ssm = _whole_fresh(fresh, fresh_ssm, policy, rows, n)

        np_ = pages_for(S, ps)
        maxp = pages.table.shape[1]
        remaining = budget - 1
        wants = (remaining > 0) & (nxt != eos)
        ask = real & wants
        ok, grant, pid, dest, free_top = _grant_admission_pages(
            pages, ask, np_)
        row = torch.full((n, maxp), -1, dtype=torch.int32, device=nxt.device)
        row[:, :np_] = torch.where(grant[:, None], pid, -1)
        row = _dup_row0(real, row)
        table = pages.table.index_put((slots.long(),), row)
        _scatter_fresh_kv(caches.kv, fresh, dest, S=S, np_=np_, ps=ps, n=n)
        _merge_fresh(caches.ssm, fresh_ssm, slots.long(), policy)

        activates = wants & (ok | (np_ == 0))
        pin_vals = torch.where(grant, pin.clamp(0, np_), 0)
        pages = _admit_state(state, pages, slots, nxt, pos0, remaining, eos,
                             _dup_row0(real, activates),
                             _dup_row0(real, pin_vals), table, free_top)
        return nxt, caches, state, pages, row

    return admit_step


def make_cached_admit_step(cfg, scfg: ServeConfig, n_prefix_pages: int, *,
                           policy=None):
    """admit_step(params, batch, caches, state, pages, slots, pos0, budget,
    eos, real, prefix_pids, pin) -> (first_tokens, caches, state, pages,
    rows) — shared-prefix admission.

    The cached twin of :func:`make_paged_admit_step` for rows whose prompt's
    first ``n_prefix_pages`` logical pages are already in the prefix cache:
    ``batch["tokens"]`` carries only the **uncached suffix**, the cached
    pages' K/V is gathered from the pool and attended to as a prefix context
    (:func:`repro_torch.models.prefix_prefill`, the prefix kernel on the
    ``"cuda"`` route), and only the suffix pages are popped.
    ``prefix_pids`` (n, n_prefix_pages) are the cached physical page ids,
    mapped **read-only** into the joining slot's table row (copy on write:
    the page holding the last prompt token is always private).  ``pin``
    (n,) counts the row's leading cache-owned logical pages.  Bucketing and
    padding rules are those of the cold step, and so is the SPMD layout:
    each rank gathers the prefix pages of its rows at its heads from its
    pool, which is the whole pool.
    """
    kp = int(n_prefix_pages)
    if kp < 1:
        raise ValueError("use the cold paged admission step for zero cached "
                         "pages")

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   pages: PageState, slots, pos0, budget, eos, real,
                   prefix_pids, pin):
        ps = _page_size(caches)
        Lp = kp * ps
        tokens = batch["tokens"]
        n, S = tokens.shape                       # S = suffix length
        rows = _bucket_rows(policy, n)
        pids = _take(prefix_pids, rows).long()

        def gather(a):
            # pool (nb, P+1, ps, Hkv, dh) -> (nb, rows, Lp, Hkv, dh)
            g = a[:, pids]                        # (nb, rows, kp, ps, ...)
            return g.reshape(g.shape[0], pids.shape[0], Lp, *g.shape[4:])

        prefix_kv = {p: (gather(view.k), gather(view.v))
                     for p, view in caches.kv.items()}
        logits, ys = prefix_prefill(params, _take(tokens, rows), prefix_kv,
                                    cfg, prefix_len=Lp, impl=scfg.attn_impl,
                                    policy=policy)
        del prefix_kv
        nxt = _dup_row0(real, _first_tokens(logits, cfg, scfg, policy, rows,
                                            n))
        ys, _ = _whole_fresh(ys, {}, policy, rows, n)

        np_ = pages_for(S, ps)                    # private pages
        maxp = pages.table.shape[1]
        remaining = budget - 1
        wants = (remaining > 0) & (nxt != eos)
        ask = real & wants
        ok, grant, pid, dest, free_top = _grant_admission_pages(
            pages, ask, np_)
        # table row: [shared prefix (read-only) | fresh suffix | -1 ...]
        row = torch.full((n, maxp), -1, dtype=torch.int32, device=nxt.device)
        row[:, :kp] = torch.where(grant[:, None], prefix_pids, -1)
        row[:, kp:kp + np_] = torch.where(grant[:, None], pid, -1)
        row = _dup_row0(real, row)
        table = pages.table.index_put((slots.long(),), row)
        _scatter_fresh_kv(caches.kv, ys, dest, S=S, np_=np_, ps=ps, n=n)

        activates = wants & ok
        pin_vals = torch.where(grant, pin.clamp(kp, kp + np_), 0)
        pages = _admit_state(state, pages, slots, nxt, pos0, remaining, eos,
                             _dup_row0(real, activates),
                             _dup_row0(real, pin_vals), table, free_top)
        return nxt, caches, state, pages, row

    return admit_step


def make_page_push():
    """push(pages, pids (K,)) -> pages — return evicted prefix-cache pages
    (the host's decision: refcount 0 and the LRU chose them) to the device
    free stack.  ``pids`` entries < 0 are padding and land on the scratch
    element."""

    def push(pages: PageState, pids):
        scratch = pages.free.shape[0] - 1
        valid = pids >= 0
        idx = torch.where(valid, pages.free_top + _cumsum(valid) - 1,
                          scratch).long()
        free = pages.free.index_put((idx,), pids.to(torch.int32))
        return pages._replace(
            free=free,
            free_top=pages.free_top + valid.sum(dtype=torch.int32))

    return push


# ---------------------------------------------------------------------------
# Speculative decode: on-device n-gram drafting + batched verify
# ---------------------------------------------------------------------------
#
# Each window proposes W-1 draft tokens per slot from an on-device n-gram
# index over the slot's committed history, scores [last token, drafts] in
# ONE verify pass (``models.verify_step``) and commits the longest prefix
# the model agrees with plus one bonus token.  Greedy acceptance compares
# argmax tokens, so the committed stream is token-identical to plain greedy
# decode.  Rejected drafts are rolled back by overwrite-before-attend (the
# next window rewrites every stale position before a query can attend to
# it); paged, pages mapped for the overshoot are kept as the next window's
# pages and recycled by ``_free_finished_pages`` when the slot finishes.


class DraftState(NamedTuple):
    """On-device n-gram drafter history, beside the caches.

    hist: (B, N) int32, the last ``N`` committed tokens per slot, newest at
          index ``N - 1``, front-padded with -1 (never a valid token, so
          padding cannot match).
    n:    (B,) int32, the count of valid entries (<= N).
    """

    hist: torch.Tensor
    n: torch.Tensor


def init_draft_state(batch: int, hist_len: int, *, device="cuda") -> DraftState:
    device = resolve_device(device)
    return DraftState(
        hist=torch.full((batch, hist_len), -1, dtype=torch.int32, device=device),
        n=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _propose_drafts(draft: DraftState, last, n_draft: int, ngram: int):
    """(B, n_draft) draft tokens: find the most recent earlier occurrence of
    the trailing ``ngram`` committed tokens and propose its continuation;
    slots with no match repeat the last token (the window runs at fixed
    width W regardless).  The continuation's indices are clipped to the
    history, as the reference clips them: a gather past it would raise on
    the card where JAX clamps."""
    hist, n = draft.hist, draft.n
    B, N = hist.shape
    dev = hist.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    m = torch.ones((B, N), dtype=torch.bool, device=dev)
    for g in range(ngram):
        # shifted[:, i] = hist[:, i - g] (-1 beyond the front): the candidate
        # n-gram ending at i matches the trailing n-gram ending at N-1
        shifted = hist if g == 0 else torch.cat(
            [torch.full((B, g), -1, dtype=hist.dtype, device=dev),
             hist[:, :N - g]], dim=1)
        m = m & (shifted == hist[:, N - 1 - g][:, None])
    # the candidate ends strictly before the trailing n-gram and spans only
    # valid history: i - ngram + 1 >= N - n
    m = m & (idx[None, :] < N - 1) & (idx[None, :] >= (N - n + ngram - 1)[:, None])
    match_idx = torch.where(m, idx[None, :], -1).amax(dim=1)          # (B,)
    found = (match_idx >= 0) & (n >= ngram + 1)
    cont = (match_idx[:, None] + 1 + torch.arange(
        n_draft, dtype=torch.int32, device=dev)[None, :]).clamp(0, N - 1)
    proposed = torch.gather(hist, 1, cont.long())
    fallback = last[:, None].expand(B, n_draft)
    return torch.where(found[:, None], proposed, fallback).to(torch.int32)


def _advance_draft(draft: DraftState, toks, c) -> DraftState:
    """Shift ``c[b]`` committed tokens (``toks[b, :c[b]]``) into each slot's
    history.  Gather indices never reach past position ``N - 1 + c[b]`` of
    the concatenation, so uncommitted window tokens are never read."""
    hist, n = draft.hist, draft.n
    N = hist.shape[1]
    ext = torch.cat([hist, toks.to(torch.int32)], dim=1)
    idx = torch.arange(N, device=hist.device)[None, :] + c.long()[:, None]
    return DraftState(hist=torch.gather(ext, 1, idx),
                      n=torch.clamp(n + c, max=N).to(torch.int32))


def _verify_rows(params, q_toks, caches, st: SlotState, cfg, scfg, mask,
                 policy, rows, tracer, **kw):
    """One verify window on the model's rows: the greedy token and the
    finite flag of each window position (B, W), all-gathered over the data
    axes when the model ran on the rank's ``rows``.  The verify call runs
    in ``tracer``'s ``serving.decode_model`` range."""
    with tracer.range("decode_model"):
        logits, caches = verify_step(params, _take(q_toks, rows), caches,
                                     _take(st.cur_pos, rows), cfg,
                                     impl=scfg.attn_impl, policy=policy,
                                     **kw)
    finite = torch.isfinite(logits).all(dim=-1)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    g = torch.argmax(logits, dim=-1).to(torch.int32)
    if rows is not None:
        g, finite = policy.gather_rows(g, finite)
    return g, finite, caches


def _spec_accept(q_toks, g, st: SlotState, active):
    """The acceptance algebra of the dense and paged spec chunks.

    ``g[b, w]`` is the greedy token given the prefix through
    ``q_toks[b, w]``: a sequential-greedy output iff drafts ``1..w`` all
    matched, which the cumulative-product scan checks, so wrong-context
    positions after the first mismatch can never be committed.  Returns
    (c, nxt, done, emitted):

      c       (B,) int32, tokens committed this window: the accepted draft
              prefix + 1 bonus token, cut at the first EOS and at the
              remaining budget; >= 1 for active slots.
      nxt     (B,) int32, the last committed token (the next window's root).
      done    (B,) bool, EOS committed or budget exhausted.
      emitted (B, W) bool, the prefix mask ``w < c``.

    ``torch.argmax`` refuses bool tensors on the card, so the EOS mask is
    cast first; like ``jnp.argmax`` it returns the first maximum.  The
    gather of the last committed token clips its index as the reference
    does.
    """
    W = g.shape[1]
    wi = torch.arange(W, dtype=torch.int32, device=g.device)
    acc = _i32(q_toks[:, 1:] == g[:, :-1])                         # (B, W-1)
    e = 1 + torch.cumprod(acc, dim=1).sum(dim=1)                    # in [1, W]
    is_eos = (st.eos[:, None] >= 0) & (g == st.eos[:, None])
    fe = torch.where(is_eos.any(dim=1), torch.argmax(_i32(is_eos), dim=1), W)
    # an EOS beyond the accepted prefix (fe >= e) is a wrong-context token
    # and is ignored: c = min(e, ...) cuts before it
    c = torch.minimum(torch.minimum(e, fe + 1), st.remaining.long())
    c = _i32(torch.where(active, c, 0))
    hit_eos = fe < c               # the EOS is the last committed token
    done = active & (hit_eos | (st.remaining - c <= 0))
    nxt = torch.gather(g, 1, (c - 1).clamp(0, W - 1).long()[:, None])[:, 0]
    nxt = torch.where(active, nxt, st.tokens)
    emitted = active[:, None] & (wi[None, :] < c[:, None])
    return c, nxt, done, emitted


def _spec_window_bad(finite, st: SlotState, active):
    """The NaN sentinel of a verify window: an active slot whose logits are
    non-finite at a committable position (``w < remaining``).  Past the
    budget the dense ring write was masked and the query may read stale
    slots, so garbage there is expected and never emitted.  ``finite``
    (B, W) flags the positions whose logits are all finite.

    The check runs on the raw logits, before the additive vocab mask puts
    -inf on the padding, as the decode chunks check.  (The reference's spec
    chunks check after the mask, so with ``vocab_padded > vocab`` every
    active slot is flagged on every window; see ROADMAP.md Queue 3.)"""
    wi = torch.arange(finite.shape[1], dtype=torch.int32,
                      device=finite.device)
    committable = wi[None, :] < st.remaining[:, None]
    return active & ~(finite | ~committable).all(dim=1)


def make_spec_decode_chunk(cfg, scfg: ServeConfig, n_windows: int,
                           window: int, ngram: int, *, policy=None,
                           tracer=NULL_TRACER):
    """spec_chunk(params, caches, state, draft) ->
    (caches, state, draft, tokens (Tw, B, W), emitted (Tw, B, W),
    poisoned (B,)).

    The speculative twin of :func:`make_decode_chunk`: ``n_windows``
    draft-and-verify windows of width ``window`` per dispatch, greedy only
    (acceptance compares argmax tokens).  ``emitted`` is a per-window
    prefix mask (the committed tokens are ``tokens[t, b, :c]``); the NaN
    sentinel discards the whole window for a slot whose committable logits
    come back non-finite.  The dense ring writes are masked at the
    remaining budget (``write_limit``) so overshoot writes can never wrap
    the ring onto live context.  The caches are updated in place; the
    slot state and the draft come back as new tensors.  Under an SPMD
    policy the drafts and acceptance are taken whole on every rank, the
    verify on the rank's rows (its window's tokens and flags gathered).
    """
    if not scfg.greedy:
        raise ValueError("speculative decode requires greedy selection")
    W = int(window)

    def spec_chunk(params, caches: Caches, state: SlotState,
                   draft: DraftState):
        mask = scfg.logit_mask(cfg, state.tokens.device)
        rows = _slot_rows(policy, state.tokens.shape[0])
        st, dr = state, draft
        poisoned = torch.zeros_like(state.active)
        toks, emitted = [], []
        for _ in range(n_windows):
            drafts = _propose_drafts(dr, st.tokens, W - 1, ngram)
            q_toks = torch.cat([st.tokens[:, None], drafts], dim=1)
            g, finite, caches = _verify_rows(
                params, q_toks, caches, st, cfg, scfg, mask, policy, rows,
                tracer, write_limit=_take(st.remaining, rows))     # (B, W)
            bad = _spec_window_bad(finite, st, st.active)
            active = st.active & ~bad
            c, nxt, done, emit = _spec_accept(q_toks, g, st, active)
            dr = _advance_draft(dr, g, c)
            st = SlotState(tokens=nxt, cur_pos=st.cur_pos + c,
                           active=active & ~done, remaining=st.remaining - c,
                           eos=st.eos)
            poisoned = poisoned | bad
            toks.append(g)
            emitted.append(emit)
        return (caches, st, dr, torch.stack(toks), torch.stack(emitted),
                poisoned)

    return spec_chunk


def make_paged_spec_decode_chunk(cfg, scfg: ServeConfig, n_windows: int,
                                 window: int, ngram: int, page_size: int, *,
                                 policy=None, tracer=NULL_TRACER):
    """spec_chunk(params, caches, state, pages, draft) ->
    (caches, state, pages, draft, tokens (Tw, B, W), emitted, poisoned,
    ctr (4,) int32).

    ``ctr`` = (pages popped, pages pushed, fault-denied slots, draft tokens
    accepted), the device-counter vector of :func:`make_paged_decode_chunk`
    with the accept count in the last entry, so the batcher learns
    per-window acceptance from the chunk's one fetch.

    The page fault before each verify maps **every logical page the
    window's committable span touches** (up to ``(W - 2) // page_size + 2``
    pages), all or nothing per slot: a slot that cannot map its whole span
    is denied and requeued like a single-page OOM, so a half-mapped window
    never commits tokens whose K/V landed on the trash page.  Needs are
    cumsum-ranked across slots, so denials cut a suffix and pops stay
    contiguous at the top of the stack.  The table is written once per span
    entry, in order, as in the reference: span entries past the table are
    clipped onto its last column, and a later entry's write there wins
    (ROADMAP.md Queue 3 logs what that leaks).  Overshoot pages are kept
    (they are the next window's) and recycled by
    :func:`_free_finished_pages` when the slot finishes.  The caches are
    updated in place; slot, page and draft state come back as new tensors.
    The SPMD layout is :func:`make_paged_decode_chunk`'s, the verify window
    on the rank's rows.
    """
    if not scfg.greedy:
        raise ValueError("speculative decode requires greedy selection")
    W = int(window)
    ps = int(page_size)
    # logical pages [cur, cur + W - 1] can span: the first may be entered
    # mid-page, every later one is full
    max_span = (W - 2) // ps + 2

    def spec_chunk(params, caches: Caches, state: SlotState,
                   pages: PageState, draft: DraftState):
        dev = state.tokens.device
        mask = scfg.logit_mask(cfg, dev)
        n_pages = pages.free.shape[0] - 1
        B = state.tokens.shape[0]
        maxp = pages.table.shape[1]
        bidx = torch.arange(B, device=dev)
        rows = _slot_rows(policy, B)
        span_off = torch.arange(max_span, dtype=torch.int32, device=dev)
        st, pg, dr = state, pages, draft
        poisoned = torch.zeros_like(state.active)
        ctr = torch.zeros((4,), dtype=torch.int32, device=dev)
        toks, emitted = [], []
        for _ in range(n_windows):
            # -- multi-page fault over the window's committable span ------
            weff = torch.clamp(st.remaining, max=W)  # positions that can
            l0 = st.cur_pos // ps                     # ever be committed
            l1 = (st.cur_pos + torch.clamp(weff, min=1) - 1) // ps
            span = l0[:, None] + span_off[None, :]
            in_span = span <= l1[:, None]
            col = span.clamp(0, maxp - 1).long()
            cur = torch.gather(pg.table, 1, col)      # (B, max_span)
            need = st.active[:, None] & in_span & (cur < 0)
            need_cnt = need.sum(dim=1, dtype=torch.int32)
            base = _cumsum(need_cnt) - need_cnt
            allocated = n_pages - pg.free_top
            fits = ((base + need_cnt <= pg.free_top)
                    & (allocated + base + need_cnt <= pg.quota))
            got = (need_cnt > 0) & fits
            oom = st.active & (need_cnt > 0) & ~fits
            rank_in = torch.cumsum(_i32(need), 1, dtype=torch.int32) - _i32(need)
            flat_rank = base[:, None] + rank_in
            pop = need & got[:, None]
            pid = pg.free[(pg.free_top - 1 - flat_rank).clamp(0, n_pages).long()]
            # one write per span entry, in order (see the docstring)
            table = pg.table.clone()
            for sp in range(max_span):
                table[bidx, col[:, sp]] = torch.where(pop[:, sp], pid[:, sp],
                                                      cur[:, sp])
            popped = pop.sum(dtype=torch.int32)
            free_top = pg.free_top - popped
            active = st.active & ~oom
            # -- draft + batched verify against the (updated) table -------
            drafts = _propose_drafts(dr, st.tokens, W - 1, ngram)
            q_toks = torch.cat([st.tokens[:, None], drafts], dim=1)
            g, finite, caches = _verify_rows(
                params, q_toks, caches, st, cfg, scfg, mask, policy, rows,
                tracer, page_table=_take(table, rows))
            bad = _spec_window_bad(finite, st, active)
            active = active & ~bad
            c, nxt, done, emit = _spec_accept(q_toks, g, st, active)
            dr = _advance_draft(dr, g, c)
            # -- recycle pages of finished / denied / poisoned slots ------
            table, free, pushed_top, pinned = _free_finished_pages(
                table, pg.free, free_top, done | oom | bad, pg.pinned)
            ctr = ctr + torch.stack([
                popped, pushed_top - free_top, oom.sum(dtype=torch.int32),
                torch.clamp(c - 1, min=0).sum(dtype=torch.int32)])
            st = SlotState(tokens=nxt, cur_pos=st.cur_pos + c,
                           active=active & ~done, remaining=st.remaining - c,
                           eos=st.eos)
            pg = PageState(table=table, free=free, free_top=pushed_top,
                           quota=pg.quota, pinned=pinned)
            poisoned = poisoned | bad
            toks.append(g)
            emitted.append(emit)
        return (caches, st, pg, dr, torch.stack(toks), torch.stack(emitted),
                poisoned, ctr)

    return spec_chunk


# ---------------------------------------------------------------------------
# CUDA graphs of the plain decode chunk
# ---------------------------------------------------------------------------


def chunk_graph_route(device, cfg, scfg: ServeConfig, *, speculative: bool,
                      policy=None) -> bool:
    """Whether a batcher replays its decode chunks as CUDA graphs
    (:class:`ChunkGraphs`): the dense family's plain greedy chunk on one
    CUDA device.  Everything else runs eagerly: the CPU; the MoE (its
    decode opens the ``moe.expert_products`` range, which a replay does
    not), SSM, hybrid, VLM and audio families; speculative chunks;
    sampling; tensor-parallel shards (host threads and host sums between
    them) and any activation policy, SPMD's gloo collectives among them."""
    return (torch.device(device).type == "cuda" and cfg.family == "dense"
            and not speculative and scfg.greedy and policy is None)


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple        # the static slot (and page) state a replay reads
    outputs: tuple       # the chunk's outputs: the graph's static tensors
    tally: dict          # the launches a replay makes, by wrapper and route


class ChunkGraphs:
    """One batcher's CUDA graphs of its plain decode chunk, one a T bucket.

    The first chunk of a bucket runs eagerly: it builds the kernel
    library, sets the kernels' shared-memory attributes and warms cuBLAS.
    The bucket's second use captures the unchanged chunk program on static
    copies of the slot (and page) state, which executes nothing, and
    replays it at once; every later use copies the batcher's state into
    those copies and replays.  The caches and params are read and written
    where they lie.  The outputs are the graph's static tensors: what the
    batcher writes into them between chunks (admissions, releases, the
    audit's repairs, a new ``quota``) reaches the next replay through its
    copy-in.  The buckets share one memory pool.  A chunk whose key (the
    shapes of the state, pages and caches, the addresses of the caches and
    params) differs from the graphs' drops them all.

    The kernel wrappers count their launches in Python, which a replay
    does not run: the capture counts one chunk's launches, the ones its
    own replay runs, into a tally, and each later replay adds the tally
    again, so every ``launches`` counter reads what the card ran."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self._key = None
        self._graphs: dict = {}
        self._seen: set = set()
        self._pool = None

    def __call__(self, chunk, T: int, params, caches, *state):
        """``chunk(params, caches, *state)``'s outputs, and how the chunk
        ran: ``"eager"``, ``"capture"`` (captured, then replayed) or
        ``"replay"``.  ``state`` is the slot state, then (paged) the page
        state."""
        key = (tuple((t.data_ptr(), t.shape) for t in leaves((params, caches))
                     if t is not None),
               tuple(t.shape for t in leaves(state)))
        if key != self._key:
            self.clear()
            self._key = key
        with torch.cuda.device(state[0].tokens.device):
            return self._run(chunk, T, params, caches, state)

    def _run(self, chunk, T, params, caches, state):
        got = self._graphs.get(T)
        if got is not None:
            for dst, src in zip(got.inputs, leaves(state)):
                if dst is not src:
                    dst.copy_(src)
            got.graph.replay()
            add_launches(got.tally)
            return got.outputs, "replay"
        if T not in self._seen:
            self._seen.add(T)
            return chunk(params, caches, *state), "eager"
        static = tuple(type(s)(*(t.clone() for t in s)) for s in state)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        tally = open_launch_tally()
        # a collection inside the capture would destroy whatever graphs
        # died in a reference cycle (another batcher's), a call the capture
        # forbids; it waits until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                outputs = chunk(params, caches, *static)
        finally:
            close_launch_tally(tally)
            if collecting:
                gc.enable()
        self._graphs[T] = _Captured(graph, tuple(leaves(static)), outputs,
                                    tally)
        graph.replay()
        return outputs, "capture"


# ---------------------------------------------------------------------------
# Tensor-parallel programs
# ---------------------------------------------------------------------------


def tp_program(build_local, cfg, group):
    """One tensor-sharded serving program: the counterpart of the
    reference's ``_tp_program`` (a fully-manual ``shard_map`` of the
    single-device program).

    ``build_local(local_cfg)`` returns the program built by the *same*
    ``make_*`` the single-device path uses, on the shard-local model
    (``distributed.sharding.tp_local_cfg``: heads and ``d_ff`` divided by
    tp), with ``policy=TP_POLICY``.  The returned callable takes the
    single-device program's arguments, each either a
    :class:`~repro_torch.distributed.PerShard` (params per
    ``tp_param_specs``, caches per ``tp_cache_specs``, each shard's replica
    of the slot, page and draft state, its generator) or one value every
    shard reads (token batches, slot indices), and runs the ``group``'s
    shards in lockstep: each updates its own cache and replicas in place,
    and the policy's two sums a layer keep every replicated output
    identical across shards.  It returns the program's output tuple with
    each entry a ``PerShard``; the caller fetches shard 0's.  One call is
    one dispatch, as at tp=1.
    """
    from ..distributed.sharding import PerShard, tp_local_cfg

    fn = build_local(tp_local_cfg(cfg, group.tp))

    def program(*args):
        shard_args = [[a[r] if isinstance(a, PerShard) else a for a in args]
                      for r in range(group.tp)]
        outs = group.run(fn, shard_args)
        return tuple(PerShard(o[i] for o in outs)
                     for i in range(len(outs[0])))

    return program


# ---------------------------------------------------------------------------
# Host generate loop (chunked)
# ---------------------------------------------------------------------------


def _to_device(a, dev, dtype=None):
    """A numpy array or tensor as a tensor on ``dev``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=dev, dtype=dtype)


def generate(params, cfg, prompt_tokens, *, n_new: int,
             scfg: Optional[ServeConfig] = None, extras=None, seed: int = 0,
             device="cuda"):
    """Prefill the prompt, then decode ``n_new`` tokens through the chunked
    path: the remaining budget is covered by power-of-two chunk buckets.

    prompt_tokens: (B, S) int32 (numpy or tensor).  ``extras`` carries the
    family's prompt context (see :func:`make_prefill_step`): the VLM's
    ``extra_embeds`` and ``positions`` (decode then starts at ``S +
    n_patches``), the audio family's ``frames``.  ``params`` must live on
    ``device``.  Returns (B, n_new) int32 on ``device``.
    """
    dev = resolve_device(device)
    tokens = _to_device(prompt_tokens, dev, torch.int32)
    B, S = tokens.shape
    scfg = scfg or ServeConfig(max_len=S + n_new)
    batch = {"tokens": tokens,
             **{k: _to_device(v, dev) for k, v in (extras or {}).items()}}
    logits, caches = make_prefill_step(cfg, scfg)(params, batch)
    mask = scfg.logit_mask(cfg, dev)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    offset = S
    if cfg.family == "vlm" and "extra_embeds" in batch:
        offset = S + batch["extra_embeds"].shape[1]

    out = [tok[:, None]]
    left = n_new - 1
    state = SlotState(
        tokens=tok,
        cur_pos=torch.full((B,), offset, dtype=torch.int32, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        remaining=torch.full((B,), max(left, 0), dtype=torch.int32, device=dev),
        eos=torch.full((B,), -1, dtype=torch.int32, device=dev),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    while left > 0:
        T = chunk_bucket(min(left, max(scfg.chunk, 1)))
        caches, state, toks, _, _ = make_decode_chunk(cfg, scfg, T)(
            params, caches, state, gen)
        out.append(toks.T)
        left -= T
    return torch.cat(out, dim=1)
