"""Inference engine: prefill, chunked decode and admission steps, and a host
``generate`` loop, on dense KV caches and on the paged pool.

Counterpart of the dense and paged parts of ``repro.serving.engine``.  The contract is
the reference's: :func:`make_decode_chunk` runs ``n_steps`` decode
iterations with the slot bookkeeping (:class:`SlotState`: active mask,
positions, EOS and budget detection) on the device, so a batcher issues one
dispatch and one host sync per chunk instead of per token.  Nothing inside
the T-step loop reads a value back to the host.

Where JAX jits these programs with ``donate_argnums`` so XLA updates the
ring-buffer KV in place, the port updates the caches **in place** directly
(``index_put_`` on views of the stacked cache); PyTorch runs eagerly, so the
reference's ``ProgramRegistry`` of compiled programs has no counterpart.

Invariant: a slot that deactivates mid-chunk (EOS or token budget) keeps
decoding with its position frozen — it overwrites its *own* ring slot with
dead values, which is safe because admission re-seeds the slot's cache from
prefill before it is reused.  (Paged: a finished slot's table row is
cleared in the same step, so its later writes land on the trash page.)

The paged steps keep the page allocator on the device, as the reference
does: the free stack, its pointer ``free_top`` and the lease ``quota`` are
tensors; grants are cumsum-ranked on the device; the host learns
``free_top`` only from the chunk's single fetch.  Two torch hazards are
handled explicitly where JAX's semantics are implicit: an index past the
page table (a stopped slot at ``cur_pos == max_len`` with ``max_len %
page_size == 0``) is clamped and masked, since torch raises where JAX
clamps a gather and drops a scatter; and duplicate-index scatters only
ever write identical values or land on a scratch element or the trash
page, since ``index_put_`` does not say which duplicate wins.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import decode_step, prefill, prefix_prefill
from ..models.attention import check_attn_impl
from ..models.transformer import Caches, prefill_kv
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


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg, scfg: ServeConfig):
    """prefill_step(params, batch) -> (last-token logits, Caches).

    batch: {"tokens": (B, S) int32}."""

    def prefill_step(params, batch):
        return prefill(params, batch["tokens"], cfg, max_len=scfg.max_len,
                       impl=scfg.attn_impl)

    return prefill_step


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


def make_decode_chunk(cfg, scfg: ServeConfig, n_steps: int):
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
    """

    def decode_chunk(params, caches: Caches, state: SlotState,
                     generator: Optional[torch.Generator] = None):
        mask = scfg.logit_mask(cfg, state.tokens.device)
        st = state
        poisoned = torch.zeros_like(state.active)
        toks, emitted = [], []
        for _ in range(n_steps):
            logits, caches = decode_step(params, st.tokens, caches, st.cur_pos,
                                         cfg, impl=scfg.attn_impl)
            bad = st.active & ~torch.isfinite(logits).all(dim=-1)
            active = st.active & ~bad
            nxt = select_token(logits, mask, scfg, generator)
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


def make_admit_step(cfg, scfg: ServeConfig):
    """admit_step(params, batch, caches, state, slots, pos0, budget, eos) ->
    (first_tokens (n,), caches, state).

    Right-sized admission: ``batch["tokens"]`` is (n, S) for the *bucketed*
    number of joining requests — prefill runs over n rows, not the full slot
    count — and the fresh caches are scattered into the resident tree per
    slot.  The resident caches and slot state are updated **in place**
    (``index_put_``; the reference donates them instead) and returned.

    Duplicate entries in ``slots`` are allowed only when they carry
    identical rows (the batcher pads a partial bucket by repeating row 0):
    which duplicate write wins is then irrelevant.
    """
    prefill_step = make_prefill_step(cfg, scfg)

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   slots, pos0, budget, eos):
        logits, fresh = prefill_step(params, batch)
        mask = scfg.logit_mask(cfg, logits.device)
        # admission is greedy: the prompt's continuation token
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        idx = slots.long()
        for p, old in caches.kv.items():
            new = fresh.kv[p]
            for o, n in zip(old, new):
                o[:, idx] = n.to(o.dtype)
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
                            page_size: int):
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
            logits, caches = decode_step(params, st.tokens, caches,
                                         st.cur_pos, cfg,
                                         impl=scfg.attn_impl,
                                         page_table=table)
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            active = active & ~bad
            nxt = select_token(logits, mask, scfg, generator)
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
    a grant."""
    n_pages = pages.free.shape[0] - 1
    cum = _cumsum(ask) * np_
    allocated = n_pages - pages.free_top
    ok = (cum <= pages.free_top) & (allocated + cum <= pages.quota)
    grant = ask & ok
    ranks = ((_cumsum(grant) - 1)[:, None] * np_
             + torch.arange(np_, dtype=torch.int32, device=ask.device)[None, :])
    pid = pages.free[(pages.free_top - 1 - ranks).clamp(0, n_pages).long()]
    dest = torch.where(grant[:, None], pid, n_pages)
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


def make_paged_admit_step(cfg, scfg: ServeConfig):
    """admit_step(params, batch, caches, state, pages, slots, pos0, budget,
    eos, real, pin) -> (first_tokens (n,), caches, state, pages, rows).

    Paged admission: right-sized bucketed prefill as in
    :func:`make_admit_step`, but the fresh K/V is scattered into **freshly
    popped pool pages** and the joining slots' page-table rows are
    rewritten.  ``real`` (n,) bool marks genuine rows — bucket padding
    duplicates row 0 and neither pops pages nor writes conflicting values.
    A row that never activates (immediate EOS, zero budget, allocation
    denied) gets no pages and a cleared table row.  ``pin`` (n,) int32 is
    the prefix-cache pin plan (how many leading logical pages the host will
    insert into the shared cache after the sync), recorded in
    ``PageState.pinned``.  ``rows`` returns the written table rows so the
    host learns the physical ids it is about to share.  Caches and slot
    state are updated in place; the page state comes back new.
    """

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   pages: PageState, slots, pos0, budget, eos, real, pin):
        ps = _page_size(caches)
        tokens = batch["tokens"]
        n, S = tokens.shape
        # the prompt's K/V in absolute-position order, ready to pack
        logits, fresh = prefill_kv(params, tokens, cfg, impl=scfg.attn_impl)
        mask = scfg.logit_mask(cfg, logits.device)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        nxt = _dup_row0(real, torch.argmax(logits, dim=-1).to(torch.int32))

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

        activates = wants & (ok | (np_ == 0))
        pin_vals = torch.where(grant, pin.clamp(0, np_), 0)
        pages = _admit_state(state, pages, slots, nxt, pos0, remaining, eos,
                             _dup_row0(real, activates),
                             _dup_row0(real, pin_vals), table, free_top)
        return nxt, caches, state, pages, row

    return admit_step


def make_cached_admit_step(cfg, scfg: ServeConfig, n_prefix_pages: int):
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
    padding rules are those of the cold step.
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
        pids = prefix_pids.long()

        def gather(a):
            # pool (nb, P+1, ps, Hkv, dh) -> (nb, n, Lp, Hkv, dh)
            g = a[:, pids]                        # (nb, n, kp, ps, Hkv, dh)
            return g.reshape(g.shape[0], n, Lp, *g.shape[4:])

        prefix_kv = {p: (gather(view.k), gather(view.v))
                     for p, view in caches.kv.items()}
        logits, ys = prefix_prefill(params, tokens, prefix_kv, cfg,
                                    prefix_len=Lp, impl=scfg.attn_impl)
        del prefix_kv
        mask = scfg.logit_mask(cfg, logits.device)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        nxt = _dup_row0(real, torch.argmax(logits, dim=-1).to(torch.int32))

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
# Host generate loop (chunked)
# ---------------------------------------------------------------------------


def generate(params, cfg, prompt_tokens, *, n_new: int,
             scfg: Optional[ServeConfig] = None, seed: int = 0,
             device="cuda"):
    """Prefill the prompt, then decode ``n_new`` tokens through the chunked
    path: the remaining budget is covered by power-of-two chunk buckets.

    prompt_tokens: (B, S) int32 (numpy or tensor).  ``params`` must live on
    ``device``.  Returns (B, n_new) int32 on ``device``.
    """
    dev = resolve_device(device)
    if isinstance(prompt_tokens, torch.Tensor):
        tokens = prompt_tokens.to(device=dev, dtype=torch.int32)
    else:
        tokens = torch.from_numpy(np.asarray(prompt_tokens, dtype=np.int32)).to(dev)
    B, S = tokens.shape
    scfg = scfg or ServeConfig(max_len=S + n_new)
    logits, caches = make_prefill_step(cfg, scfg)(params, {"tokens": tokens})
    mask = scfg.logit_mask(cfg, dev)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)

    out = [tok[:, None]]
    left = n_new - 1
    state = SlotState(
        tokens=tok,
        cur_pos=torch.full((B,), S, dtype=torch.int32, device=dev),
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
