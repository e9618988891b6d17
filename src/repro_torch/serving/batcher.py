"""Continuous batching over fixed decode slots on dense KV caches.

Counterpart of the dense mode of ``repro.serving.batcher``.  The batcher
multiplexes a dynamic request stream onto B fixed slots:

* new requests are prefilled **right-sized** (the joining rows only,
  bucketed to powers of two) and their caches scattered into free slots —
  one admission dispatch;
* decode runs in **chunks**: one call advances all slots T steps with
  EOS/max-token detection on the device, so the host pays one dispatch and
  one blocking sync per T tokens instead of per token.  T adapts to queue
  pressure (short chunks while requests wait, long chunks when the queue is
  dry) over the same power-of-two buckets;
* the caches and slot state are updated in place by both steps;
* slots free on EOS/max-tokens and are immediately refillable.

A "dispatch" is one call of the admission or chunk step, and a "host sync"
one blocking device-to-host fetch: ``(toks, emitted, poisoned)`` come back
packed in one tensor with one ``.cpu()`` per chunk, and the first tokens
with one ``.cpu()`` per admission — the same counts the reference keeps.

Invariants:

* ``slot_req[i] is not None`` ⟺ slot i is active on the device; the host
  mirror is reconciled from the fetched ``emitted`` mask after every chunk.
* A slot that finishes mid-chunk keeps decoding with its position frozen,
  overwriting only its own ring slot; admission re-seeds the cache before
  reuse (see ``serving.engine``).
* Prompts are left-padded with token 0 to ``prompt_len`` and the padding is
  attended to at positions ``0..prompt_len-1``, exactly as in the reference.

**Deadlines**: a ``Request.deadline`` (in the ``clock`` timebase) already
past at admission time sheds the request (``dropped`` /
``stats.deadline_drops``).

**Fault guard**: every chunk carries the non-finite logit sentinel — a slot
whose logits go NaN/inf is deactivated on the device before a poisoned token
can be emitted, and its request is requeued with its pre-fault tokens
intact (``stats.poisoned_slots``).

The paged pool, prefix cache, speculative decode, overlap, tensor
parallelism, watchdog and page-table audit raise ``NotImplementedError`` at
construction until the ROADMAP items that port them land.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.attention import check_attn_impl
from ..models.transformer import Caches, init_caches
from ..obs import MetricsRegistry, Telemetry
from .config import ServingConfig, config_from_legacy_kwargs
from .engine import (
    ServeConfig,
    SlotState,
    chunk_bucket,
    init_slot_state,
    make_admit_step,
    make_decode_chunk,
)
from .kv_cache import tree_bytes

# ServingConfig modes this slice does not run yet, with the ROADMAP item
# (ROADMAP.md, Queue 1) that ports each
_UNPORTED = (
    ("paged", lambda c: c.paged, "item 7 (paged pool)"),
    ("prefix_cache", lambda c: bool(c.prefix_cache), "item 9 (prefix sharing)"),
    ("speculative", lambda c: c.speculative,
     "item 10 (speculative decode and overlap)"),
    ("overlap", lambda c: c.overlap, "item 10 (speculative decode and overlap)"),
    ("tp > 1", lambda c: c.tp > 1, "item 12 (tensor parallel)"),
    ("watchdog_s", lambda c: c.watchdog_s is not None, "item 11 (fault guards)"),
    ("audit", lambda c: c.audit, "item 11 (fault guards)"),
)


@dataclasses.dataclass
class Request:
    """One generation request.

    ``namespace`` keys the shared-prefix cache of the reference (not ported
    yet; carried so requests mean the same in both packages).  ``deadline``
    (same clock as the batcher's ``clock`` callable) lets the batcher shed
    the request instead of starting it hopelessly late — ``dropped`` marks
    that outcome (``done`` is set too, with no output).
    """

    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    namespace: Optional[str] = None
    deadline: Optional[float] = None
    dropped: bool = False
    # set when the request was requeued mid-flight and re-admitted
    resumed: bool = False


# Every BatcherStats counter, in declaration order.  Each name is a view
# over the ``serving.<name>`` counter in the batcher's MetricsRegistry.  The
# names of modes the port does not run yet stay (at 0) so both packages
# report the same counter set.
_STATS_FIELDS: Tuple[str, ...] = (
    "steps",                    # device decode steps executed (Σ chunk T)
    "chunks",                   # decode_chunk dispatches
    "prefills",                 # admission dispatches
    "completed",
    "slot_busy_steps",
    "slot_total_steps",
    "dispatches",               # all dispatches (admit + chunk)
    "host_syncs",               # blocking device→host fetches
    "decode_tokens",            # tokens emitted by decode chunks
    "admit_tokens",             # first tokens emitted at admission
    "cache_bytes",              # resident cache-tree size (updated in place)
    "admit_scatter_bytes",      # bytes scattered at admission (vs. full-tree)
    # paged mode
    "oom_requeues",             # requests requeued after a denied page fault
    "oom_discarded_tokens",     # emitted tokens thrown away by requeues
    "oom_resumed",              # OOM requeues that kept their tokens
    "resumed_tokens_kept",      # tokens kept across requeues (any cause)
    "pages_in_use",             # device-allocated pages after the last sync
    "peak_pages_in_use",
    "peak_resident",            # most simultaneously-resident requests
    # device counters (ride back inside the per-chunk sync, paged modes)
    "device_pages_popped",      # pages popped off the free stack in-scan
    "device_pages_pushed",      # pages pushed back by in-scan frees
    "fault_denied_slots",       # slot-steps denied a page grant in-scan
    "device_draft_accepted",    # draft tokens accepted, counted on-device
    # prefix cache
    "prefix_hits",              # admissions that mapped >= 1 cached page
    "prefill_tokens_skipped",   # prompt tokens served from shared pages
    "prefix_inserts",           # pages newly indexed into the cache
    "prefix_evictions",         # cached pages reclaimed to the free stack
    "shared_pages",             # cache-owned pages right now (gauge)
    # deadlines
    "deadline_drops",           # requests shed before start (past deadline)
    # fault guards (NaN sentinel / watchdog / page-table audit)
    "poisoned_slots",           # slots retired by the non-finite sentinel
    "watchdog_trips",           # chunks that exceeded watchdog_s
    "audit_repairs",            # page-table entries the audit cleared
    "quarantined_pages",        # pool pages permanently out of circulation
    # speculative decode
    "spec_windows",             # draft-and-verify windows with >= 1 commit
    "drafted_tokens",           # draft tokens proposed in those windows
    "accepted_tokens",          # draft tokens the verify pass accepted
    # prefill/decode overlap
    "overlap_rounds",           # rounds with chunk + admission both in flight
    # prefix cache: resumed rows whose shifted padding missed the cache
    "resume_prefix_misses",
    # tensor parallelism
    "remeshes",                 # live tp-width migrations (hypervisor resizes)
)
_STATS_FIELD_SET = frozenset(_STATS_FIELDS)


class BatcherStats:
    """The batcher's counter bundle, backed by a ``MetricsRegistry``: each
    field is a *view* over the ``serving.<field>`` counter in a registry
    (optionally per-tenant labeled), so ``batcher.stats.chunks`` and
    ``registry.counter("serving.chunks", tenant).value`` are the same
    number."""

    __slots__ = ("_registry", "_tenant")

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 tenant: Optional[str] = None, **overrides: int):
        object.__setattr__(self, "_registry",
                           registry if registry is not None
                           else MetricsRegistry())
        object.__setattr__(self, "_tenant", tenant)
        for name in _STATS_FIELDS:
            self._registry.counter(f"serving.{name}", self._tenant)
        for name, value in overrides.items():
            if name not in _STATS_FIELD_SET:
                raise TypeError(
                    f"BatcherStats got an unexpected field {name!r}")
            setattr(self, name, value)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def __getattr__(self, name: str) -> int:
        if name in _STATS_FIELD_SET:
            return self._registry.counter(
                f"serving.{name}", self._tenant).value
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in _STATS_FIELD_SET:
            self._registry.counter(
                f"serving.{name}", self._tenant).value = value
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in _STATS_FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"BatcherStats({body})"

    @property
    def prefix_tokens_saved(self) -> int:
        return self.prefill_tokens_skipped

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.drafted_tokens, 1)

    @property
    def occupancy(self) -> float:
        return self.slot_busy_steps / max(self.slot_total_steps, 1)

    @property
    def tokens(self) -> int:
        """Tokens actually *delivered* (restarted requests' discarded
        emissions excluded)."""
        return self.decode_tokens + self.admit_tokens \
            - self.oom_discarded_tokens

    @property
    def dispatches_per_token(self) -> float:
        return self.dispatches / max(self.tokens, 1)

    @property
    def syncs_per_token(self) -> float:
        return self.host_syncs / max(self.tokens, 1)

    @property
    def decode_dispatches_per_token(self) -> float:
        """Dispatches on the pure-decode path: 1/T when chunks run full."""
        return self.chunks / max(self.decode_tokens, 1)


class ContinuousBatcher:
    """Fixed-slot continuous batcher for one tenant's model, dense mode.

    Construct with a validated :class:`~repro_torch.serving.config.ServingConfig`::

        ContinuousBatcher(params, cfg, ServingConfig(slots=4, prompt_len=8,
                                                     max_len=32))

    ``device`` (default ``"cuda"``) is where the caches live and the steps
    run; ``params`` are moved there.  Without a GPU, pass ``device="cpu"``.
    The legacy keyword constructor (``ContinuousBatcher(params, cfg,
    slots=4, ...)``) still works and emits a ``DeprecationWarning``.
    """

    def __init__(self, params, cfg, config: Optional[ServingConfig] = None,
                 *, device="cuda", clock: Optional[Callable[[], float]] = None,
                 telemetry: Optional[Telemetry] = None, **legacy):
        if config is None:
            offending = ", ".join(sorted(legacy)) if legacy else "<none>"
            warnings.warn(
                f"ContinuousBatcher(**kwargs) is deprecated — move the "
                f"legacy kwarg(s) [{offending}] onto a ServingConfig: "
                f"ContinuousBatcher(params, cfg, ServingConfig(...))",
                DeprecationWarning, stacklevel=2)
            config = config_from_legacy_kwargs(**legacy)
        elif legacy:
            raise TypeError(
                f"pass either a ServingConfig or legacy kwargs, not both "
                f"(got config and {sorted(legacy)})")
        for name, enabled, item in _UNPORTED:
            if enabled(config):
                raise NotImplementedError(
                    f"ServingConfig {name} is not ported yet: ROADMAP.md "
                    f"Queue 1 {item}")
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.config = config
        slots = config.slots
        self.B = slots
        self.prompt_len = config.prompt_len
        self.chunk = max(1, config.chunk)
        self.scfg = ServeConfig(max_len=config.max_len,
                                attn_impl=config.attn_impl, chunk=self.chunk)
        if cfg.sliding_window:
            check_attn_impl(config.attn_impl, "sliding_window")
        self._clock = clock if clock is not None else time.monotonic
        self._has_deadlines = False
        self.queue: Deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.state: SlotState = init_slot_state(slots, device=self.device)
        self.caches: Caches = init_caches(cfg, slots, config.max_len,
                                          device=self.device)
        self._admit_fn = make_admit_step(cfg, self.scfg)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._tracer = self.telemetry.tracer
        self._track = self.telemetry.track
        self.stats = BatcherStats(registry=self.telemetry.registry,
                                  tenant=self.telemetry.tenant,
                                  cache_bytes=tree_bytes(self.caches))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)

    # -- request intake ------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt.shape[0] > self.prompt_len:
            raise ValueError(
                f"prompt of {req.prompt.shape[0]} tokens exceeds "
                f"prompt_len={self.prompt_len}")
        if req.deadline is not None:
            self._has_deadlines = True
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _shed_expired(self) -> None:
        """Drop queued requests whose deadline has already passed."""
        if not self._has_deadlines:
            return
        now = self._clock()
        kept: Deque[Request] = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                req.done = True
                req.dropped = True
                self.stats.deadline_drops += 1
            else:
                kept.append(req)
        self.queue = kept

    # -- fault guard: requeue -------------------------------------------
    def _requeue_slot(self, slot: int, req: Request) -> bool:
        """Retire ``slot``'s request to the queue head.  Generated tokens
        are KEPT when prompt+output still fit the prompt bucket
        (re-admission prefills the concatenation and decoding resumes);
        otherwise the request restarts from its prompt and the discarded
        emissions stay out of ``stats.tokens``.  Returns True when the
        tokens were kept."""
        self.slot_req[slot] = None
        kept = bool(req.out) and \
            len(req.prompt) + len(req.out) <= self.prompt_len
        if kept:
            self.stats.resumed_tokens_kept += len(req.out)
            req.resumed = True
        else:
            self.stats.oom_discarded_tokens += len(req.out)
            req.out.clear()
        self.queue.appendleft(req)
        return kept

    # -- admission: right-sized prefill + per-slot scatter ---------------
    def _padded_row(self, req: Request) -> np.ndarray:
        """The request's prompt-bucket row: prompt (plus any tokens kept by
        a requeue) left-padded with 0s to ``prompt_len``."""
        row = np.zeros((self.prompt_len,), dtype=np.int32)
        toks = np.asarray(req.prompt, dtype=np.int32)
        if req.out:
            toks = np.concatenate(
                [toks, np.asarray(req.out, dtype=np.int32)])
        row[self.prompt_len - len(toks):] = toks
        return row

    def _admit(self) -> None:
        self._shed_expired()
        free = self._free_slots()
        if not free or not self.queue:
            return
        self._admit_dense(free)

    def _admit_dense(self, free: List[int]) -> None:
        """Dense-ring admission: one bucketed prefill, per-slot scatter."""
        joins = []
        while free and self.queue:
            joins.append({"slot": free.pop(0), "req": self.queue.popleft()})
        n = len(joins)
        nb = min(1 << (n - 1).bit_length() if n > 1 else 1, self.B)
        toks = np.zeros((nb, self.prompt_len), dtype=np.int32)
        slots = np.zeros((nb,), dtype=np.int32)
        budget = np.zeros((nb,), dtype=np.int32)
        eos = np.full((nb,), -1, dtype=np.int32)
        for j, join in enumerate(joins):
            slot, req = join["slot"], join["req"]
            toks[j] = self._padded_row(req)
            slots[j] = slot
            budget[j] = req.max_new - len(req.out)
            if req.eos is not None:
                eos[j] = req.eos
        # pad a partial bucket by repeating row 0: duplicate-index scatters
        # then write identical values, whichever write wins
        for j in range(n, nb):
            toks[j] = toks[0]
            slots[j] = slots[0]
            budget[j] = budget[0]
            eos[j] = eos[0]
        pos0 = np.full((nb,), self.prompt_len, dtype=np.int32)
        dev = self.device
        nxt, self.caches, self.state = self._admit_fn(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)},
            self.caches, self.state, torch.from_numpy(slots).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(budget).to(dev),
            torch.from_numpy(eos).to(dev),
        )
        self.stats.prefills += 1
        self.stats.dispatches += 1
        self.stats.admit_scatter_bytes += int(
            self.stats.cache_bytes * nb / max(self.B, 1)
        )
        self._finish_admit(joins, nxt)

    def _finish_admit(self, joins: List[Dict[str, Any]], nxt) -> None:
        """Post-dispatch half of one admission: read the first tokens (one
        host sync), append them, complete done-at-admission requests."""
        nxt_np = nxt.cpu().numpy()
        self.stats.host_syncs += 1
        for j, join in enumerate(joins):
            slot, req = join["slot"], join["req"]
            tok = int(nxt_np[j])
            req.out.append(tok)
            self.stats.admit_tokens += 1
            hit_eos = req.eos is not None and tok == req.eos
            if len(req.out) >= req.max_new or hit_eos:
                req.done = True
                self.stats.completed += 1
                continue
            self.slot_req[slot] = req
        self.stats.peak_resident = max(
            self.stats.peak_resident,
            sum(r is not None for r in self.slot_req))

    # -- chunk sizing: adaptive to queue pressure ------------------------
    def _pick_chunk(self, active: List[int]) -> int:
        """Queue pressure → short chunks (the earliest completion bounds
        admission latency); dry queue → chunks up to the longest remaining
        budget.  Sizes snap to power-of-two buckets."""
        rem = [self.slot_req[i].max_new - len(self.slot_req[i].out)
               for i in active]
        horizon = min(rem) if self.queue else max(rem)
        return chunk_bucket(max(1, min(horizon, self.chunk)))

    def _dispatch_chunk(self, active: List[int]) -> Dict[str, Any]:
        """Dispatch one decode chunk of T steps without syncing; returns the
        pending record for :meth:`_finish_chunk`."""
        T = self._pick_chunk(active)
        t0 = self._clock()
        chunk = make_decode_chunk(self.cfg, self.scfg, T)
        self.caches, self.state, toks, emitted, poisoned = chunk(
            self.params, self.caches, self.state, self._gen)
        self.stats.steps += T
        # one packed (2T+1, B) tensor so the chunk costs one fetch
        fetch = torch.cat([toks, emitted.to(torch.int32),
                           poisoned[None].to(torch.int32)])
        self.stats.chunks += 1
        self.stats.dispatches += 1
        if self._tracer.enabled:
            self._tracer.complete("dispatch", self._track, t0,
                                  self._clock() - t0,
                                  {"T": T, "active": len(active)})
        return {"fetch": fetch, "t0": t0, "T": T, "active": active}

    def _finish_chunk(self, pending: Dict[str, Any]) -> None:
        """Sync one dispatched chunk and run the host bookkeeping: token
        emission, completion, poison requeues."""
        T, active = pending["T"], pending["active"]
        t_sync0 = self._clock() if self._tracer.enabled else 0.0
        fetched = pending["fetch"].cpu().numpy()          # ONE host sync
        elapsed = self._clock() - pending["t0"]
        if self._tracer.enabled:
            t_end = pending["t0"] + elapsed
            self._tracer.complete("host_sync", self._track, t_sync0,
                                  t_end - t_sync0)
            self._tracer.complete("chunk", self._track, pending["t0"],
                                  elapsed, {"T": T, "slots": len(active)})
        toks_np, emit_np, poison_np = fetched[:T], fetched[T:2 * T], fetched[2 * T]
        self.stats.host_syncs += 1
        self.stats.slot_total_steps += self.B * T
        self.stats.slot_busy_steps += int(emit_np.sum())
        for i in active:
            req = self.slot_req[i]
            for t in range(T):
                if not emit_np[t, i]:
                    break
                req.out.append(int(toks_np[t, i]))
                self.stats.decode_tokens += 1
            self._maybe_complete(i, req)
        # non-finite sentinel: the device deactivated the flagged slots
        # before selecting or emitting a token; requeue the victims
        for i in active:
            req = self.slot_req[i]
            if req is not None and bool(poison_np[i]):
                self.stats.poisoned_slots += 1
                self._tracer.instant("poisoned_slot", self._track,
                                     args={"slot": i})
                self._requeue_slot(i, req)

    def _maybe_complete(self, slot: int, req: Request) -> None:
        """Retire ``slot`` if its request just hit EOS or its budget."""
        hit_eos = req.eos is not None and req.out and req.out[-1] == req.eos
        if len(req.out) >= req.max_new or hit_eos:
            req.done = True
            self.slot_req[slot] = None
            self.stats.completed += 1

    # -- one scheduling round ---------------------------------------------
    def step(self) -> None:
        """One scheduling round: admit, then decode one chunk — two
        dispatches, two syncs, strictly ordered."""
        with self._tracer.span("round", self._track):
            with self._tracer.span("admission", self._track):
                self._admit()
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                return
            self._finish_chunk(self._dispatch_chunk(active))

    def run(self, *, max_steps: int = 10_000) -> BatcherStats:
        while (self.queue or any(r is not None for r in self.slot_req)) and \
                self.stats.steps < max_steps:
            before = self.stats.dispatches
            self.step()
            if self.stats.dispatches == before and \
                    not any(r is not None for r in self.slot_req):
                break   # starved: queued work cannot be admitted
        return self.stats


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
