"""Continuous batching over fixed decode slots, on dense KV caches or on the
paged pool with shared-prefix admission, with optional speculative decode
and admission/decode overlap.

Counterpart of the dense, paged, prefix, speculative and overlap modes of
``repro.serving.batcher``.  The batcher
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
* slots free on EOS/max-tokens and are immediately refillable;
* ``speculative=True`` makes the chunk unit a draft-and-verify window of
  ``draft_window`` tokens (an on-device n-gram drafter, one verify pass,
  greedy acceptance), token-identical to plain greedy decode;
* ``overlap=True`` dispatches the decode chunk first and runs admission
  behind it, so the host plans admission while the card decodes.

The model is a pure-attention family (dense MLP or Mixture-of-Experts) or
the attention-free SSM (Mamba-2) family, whose per-slot state (conv window
and f32 SSM state) rides in ``caches.ssm`` and is scattered at admission
like the rings.  As in the reference, paged mode needs an attention layer,
the prefix cache and speculative decode need a pure-attention arch, and
speculative decode refuses a sliding window (mixtral).

A "dispatch" is one call of the admission or chunk step (or of the page
push that returns evicted prefix-cache pages), and a "host sync" one
blocking device-to-host fetch: ``(toks, emitted, poisoned)`` — plus, paged,
``active``, ``free_top`` and the device counters — come back packed in one
tensor with one fetch per chunk, and the first tokens (paged: with the
written table rows) with one fetch per admission — the same counts the
reference keeps.  On the card a fetch is an asynchronous copy into pinned
host memory enqueued right behind its step, with an event recorded after
it; the merge point waits for that event only.

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

**Fault guards**: every chunk carries the non-finite logit sentinel — a
slot whose logits go NaN/inf is deactivated on the device before a poisoned
token can be emitted, and its request is requeued with its pre-fault tokens
intact (``stats.poisoned_slots``).  An optional **watchdog**
(``watchdog_s``) bounds the wall time of one chunk dispatch+sync and
retires the most suspect slot instead of stalling every other request
(``stats.watchdog_trips``).  An opt-in **page-table audit** (``audit=True``,
paged mode) rides the chunk's one fetch: the page table joins the packed
vector, is checked against the no-double-mapping invariant (shared prefix
pages are exempt: they are read-only and multi-mapped by design), and
violating entries are cleared, double-mapped physical pages quarantined out
of circulation for good, and the slots whose KV integrity is suspect
requeued (``stats.audit_repairs`` / ``stats.quarantined_pages``).  A chunk
with nothing to repair costs no extra sync.  ``inject_stall`` and
``inject_kv_corruption`` are seeded-chaos hooks for tests and
``chip_smoke.py``.

Tensor parallelism raises ``NotImplementedError`` at construction until the
ROADMAP item that ports it lands.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, tree_to_device
from ..models.attention import check_attn_impl
from ..models.transformer import (
    Caches, init_caches, init_paged_caches, period_structure,
)
from ..obs import MetricsRegistry, Telemetry
from .config import ServingConfig, config_from_legacy_kwargs
from .engine import (
    DraftState,
    PageState,
    ServeConfig,
    SlotState,
    chunk_bucket,
    init_draft_state,
    init_page_state,
    init_slot_state,
    make_admit_step,
    make_cached_admit_step,
    make_decode_chunk,
    make_page_push,
    make_paged_admit_step,
    make_paged_decode_chunk,
    make_paged_spec_decode_chunk,
    make_spec_decode_chunk,
)
from .kv_cache import PagedKVPool, PageQuotaError, pages_for, tree_bytes
from .prefix_cache import PrefixCache, PrefixNode

# ServingConfig modes this slice does not run yet, with the ROADMAP item
# (ROADMAP.md, Queue 1) that ports each
_UNPORTED = (
    ("tp > 1", lambda c: c.tp > 1, "item 12 (tensor parallel)"),
)


class _Fetch:
    """One blocking device-to-host fetch of a packed result.  On the card the
    copy into pinned host memory is enqueued at dispatch, right behind the
    step on the same stream, with an event recorded after it: :meth:`wait`
    (the host sync) then waits for that step and its copy only, not for
    work enqueued later (an admission dispatched behind a chunk).  A CPU
    tensor is already on the host."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
            t = host
        self._host = t

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class Request:
    """One generation request.

    ``namespace`` keys the shared-prefix cache: requests share cached prompt
    pages only within a namespace, and the default ``None`` never shares.
    Prompts are left-padded to the batcher's ``prompt_len`` bucket, so only
    prompts of equal *total* length align positions and can share a prefix.
    ``deadline`` (same clock as the batcher's ``clock`` callable) lets the
    batcher shed the request instead of starting it hopelessly late —
    ``dropped`` marks that outcome (``done`` is set too, with no output).
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
    # set when the request was requeued mid-flight and re-admitted: its row
    # is left-padded differently than the original prompt, which shifts page
    # alignment for the prefix cache
    resumed: bool = False
    # prefix-cache nodes this request currently pins (internal)
    _prefix_nodes: List[PrefixNode] = dataclasses.field(
        default_factory=list, repr=False)


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
    """Fixed-slot continuous batcher for one tenant's model: dense rings, or
    the paged pool with optional shared-prefix admission.

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
        self.params = tree_to_device(params, self.device)
        self.cfg = cfg
        self.config = config
        slots = config.slots
        self.B = slots
        self.prompt_len = config.prompt_len
        self.chunk = max(1, config.chunk)
        self.scfg = ServeConfig(max_len=config.max_len,
                                attn_impl=config.attn_impl, chunk=self.chunk)
        # structural and capability rules were checked by ServingConfig; the
        # model-dependent rules live here, where cfg is known
        if cfg.sliding_window:
            check_attn_impl(config.attn_impl, "sliding_window")
        prefix_cache = config.prefix_cache
        if prefix_cache and (
                any(s.mixer != "attn" for s in period_structure(cfg))
                or cfg.family in ("audio", "vlm") or cfg.sliding_window):
            raise ValueError(
                "prefix caching requires a pure-attention, non-sliding-window "
                "arch (SSM state is not positional; audio/vlm prompts shift "
                "positions)")
        if config.speculative and (
                any(s.mixer != "attn" for s in period_structure(cfg))
                or cfg.family in ("audio", "vlm") or cfg.sliding_window):
            raise ValueError(
                "speculative decode requires a pure-attention, "
                "non-sliding-window text arch (SSM state cannot be rolled "
                "back to the accepted prefix)")
        self.paged = bool(config.paged)
        self._clock = clock if clock is not None else time.monotonic
        self._has_deadlines = False
        self.queue: Deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.state: SlotState = init_slot_state(slots, device=self.device)
        self.prefix: Optional[PrefixCache] = None
        if isinstance(prefix_cache, PrefixCache):
            if prefix_cache.page_size != config.page_size:
                raise ValueError("the prefix cache's page_size differs from "
                                 "the batcher's")
            self.prefix = prefix_cache
        elif prefix_cache:
            self.prefix = PrefixCache(config.page_size)
        self.pages: Optional[PageState] = None
        if self.paged:
            self.page_size = max(1, config.page_size)
            self.max_pages = pages_for(config.max_len, self.page_size)
            # default pool == dense capacity; a smaller n_pages
            # over-subscribes
            self.n_pages = config.n_pages if config.n_pages is not None \
                else slots * self.max_pages
            self.reserve_pages = config.reserve_pages
            self._page_limit = min(config.page_quota, self.n_pages) \
                if config.page_quota is not None else self.n_pages
            self.kv_pool = PagedKVPool(self.n_pages, self.page_size)
            self.caches: Caches = init_paged_caches(
                cfg, slots, self.n_pages, self.page_size, device=self.device)
            if not self.caches.kv:
                raise ValueError("paged mode needs at least one attn layer")
            self.pages = init_page_state(slots, self.n_pages, self.max_pages,
                                         quota=self._page_limit,
                                         device=self.device)
            self._admit_fn = make_paged_admit_step(cfg, self.scfg)
            self._push_fn = make_page_push()
        else:
            self.caches = init_caches(cfg, slots, config.max_len,
                                      device=self.device)
            self._admit_fn = make_admit_step(cfg, self.scfg)
        # speculative decode: the chunk unit becomes a draft-and-verify
        # window; the drafter history is device state beside the caches
        self._spec = bool(config.speculative)
        self._draft_window = config.draft_window
        self._draft_ngram = config.draft_ngram
        self._draft_hist = config.draft_hist
        self.draft: Optional[DraftState] = (
            init_draft_state(slots, config.draft_hist, device=self.device)
            if self._spec else None)
        self._overlap = bool(config.overlap)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._tracer = self.telemetry.tracer
        self._track = self.telemetry.track
        self.stats = BatcherStats(registry=self.telemetry.registry,
                                  tenant=self.telemetry.tenant,
                                  cache_bytes=tree_bytes(self.caches))
        # fault guards: watchdog_s bounds the wall time of one chunk
        # dispatch+sync (None = off); audit=True cross-checks the fetched
        # page tables against the no-double-mapping invariant every chunk
        self._watchdog_s = config.watchdog_s
        self._audit = bool(config.audit) and self.paged
        self._stall: Optional[tuple] = None      # inject_stall chaos hook
        self._quarantined: set = set()           # page ids out of circulation
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._stalled = 0           # consecutive zero-emission paged chunks
        self._admitted_pages_since_sync = 0
        # page pushes (cache evictions, guard releases): dispatches with no
        # host sync
        self.page_pushes = 0
        # over-subscription throttle: after a denied page fault, cap
        # residency at the survivors so restarted requests stop thrashing
        # the ones still making progress; recover one slot per clean round
        self._resident_cap = slots

    # -- request intake ------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt.shape[0] > self.prompt_len:
            raise ValueError(
                f"prompt of {req.prompt.shape[0]} tokens exceeds "
                f"prompt_len={self.prompt_len}")
        if self.paged and self._request_pages(req) > self.n_pages:
            raise ValueError(
                f"request {req.rid} needs {self._request_pages(req)} pages, "
                f"more than the whole pool of {self.n_pages}")
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

    # -- paged-mode ledger ----------------------------------------------
    def _request_pages(self, req: Request) -> int:
        """Ledger reservation for one request: its worst-case footprint
        (bucketed prompt + full decode budget) when reserving, prompt pages
        only when running over-subscribed."""
        toks = self.prompt_len + (req.max_new if self.reserve_pages else 0)
        return pages_for(toks, self.page_size)

    def set_page_limit(self, n_pages: int) -> None:
        """Adjust the tenant's ``kv_pages`` lease cap mid-run.  Takes effect
        on the next dispatch; shrinking below the current allocation only
        blocks further growth — resident pages drain as their slots
        complete.  With a prefix cache, a shrink **evicts unpinned cache
        entries first**, so the cache pays for the smaller lease before live
        requests start faulting against it."""
        if not self.paged:
            raise ValueError("page limits only apply to paged batchers")
        self._page_limit = max(0, min(int(n_pages), self.n_pages))
        self.pages = self.pages._replace(quota=torch.tensor(
            self._page_limit, dtype=torch.int32, device=self.device))
        if self.prefix is not None:
            est = self.stats.pages_in_use + self._admitted_pages_since_sync
            if est > self._page_limit:
                self._evict_cached(est - self._page_limit)

    # -- mid-run migration (Hypervisor resize between chunks) -----------
    def live_state(self) -> Dict[str, Any]:
        """Current device state, for ``TwoStageCompiler.reconfigure``
        migration: caches and slot state, plus the page tables and free
        stack when paged and the draft state when speculative.  Register
        this *method* (not its result) with ``ServingExecutor.register_state``:
        the steps replace these objects.  The steps also update the caches
        in place and return before the card has run them, so this first
        waits for everything queued on the stream (an in-flight chunk, its
        packed fetch, an admission or page push behind it): a resize that
        lands between chunks never reads or moves a tensor a queued kernel
        still writes."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        out = {"caches": self.caches, "slots": self.state}
        if self.paged:
            out["pages"] = self.pages
        if self._spec:
            out["draft"] = self.draft
        return out

    def adopt_state(self, state: Dict[str, Any]) -> None:
        """Adopt a migrated state tree; decode resumes at the same token.
        The params and the sampling generator stay where they are, so the
        tree must lie on the batcher's device (on one card every logical
        core is that device)."""
        dev, here = state["slots"].active.device, self.state.active.device
        if dev != here:
            raise ValueError(
                f"migrated state lies on {dev}, the batcher's params on "
                f"{here}; moving a live batcher to another device "
                f"needs remesh, which is not ported yet (ROADMAP.md Queue 1 "
                f"item 12)")
        self.caches = state["caches"]
        self.state = state["slots"]
        if self.paged:
            self.pages = state["pages"]
        if self._spec:
            self.draft = state["draft"]

    def _evict_cached(self, n: int) -> int:
        """Reclaim up to ``n`` pages from the prefix cache (LRU, refcount-0
        only): drop them from the shared ledger and push them back onto the
        device free stack.  Returns how many pages came back."""
        if self.prefix is None or n <= 0:
            return 0
        pids = self.prefix.evict(n)
        if not pids:
            return 0
        self.kv_pool.drop_shared(pids)
        self.stats.prefix_evictions += len(pids)
        self.stats.shared_pages = self.kv_pool.shared
        self._push_pages(pids)
        self.stats.pages_in_use = max(0, self.stats.pages_in_use - len(pids))
        return len(pids)

    def _page_shortfall(self, need: int, pop_need: Optional[int] = None,
                        ) -> int:
        """Pages missing before ``need`` can be admitted: the worst deficit
        over the lease bound, the ledger bound, and (without reservations)
        the device free-stack estimate for ``pop_need`` (the pages the
        admission will actually pop; defaults to ``need``).  0 means the
        admission fits.  Every evicted cache page relieves all three bounds
        at once, so this is how many pages an eviction pass must reclaim."""
        if pop_need is None:
            pop_need = need
        short = max(0, self.kv_pool.used + need - self._page_limit)
        short = max(short, need - self.kv_pool.available)
        if not self.reserve_pages:
            # the ledger reserved prompt pages only; residents' decode pages
            # live on the device.  Bound admission by the device allocation
            # seen at the last sync (plus prompts admitted since), keeping
            # one page of headroom whenever someone is resident so at least
            # one slot can take its decode-time fault and progress.
            device_avail = (self.n_pages - self.stats.pages_in_use
                            - self._admitted_pages_since_sync)
            short = max(
                short,
                pop_need + int(any(r is not None for r in self.slot_req))
                - device_avail)
        return short

    def _pages_available(self, need: int, pop_need: Optional[int] = None,
                         ) -> bool:
        return self._page_shortfall(need, pop_need) == 0

    # -- fault guard: requeue -------------------------------------------
    def _requeue_slot(self, slot: int, req: Request) -> bool:
        """Retire ``slot``'s request to the queue head.  Generated tokens
        are KEPT when prompt+output still fit the prompt bucket
        (re-admission prefills the concatenation and decoding resumes);
        otherwise the request restarts from its prompt and the discarded
        emissions stay out of ``stats.tokens``.  Returns True when the
        tokens were kept."""
        self.slot_req[slot] = None
        if self.paged:
            if self.prefix is not None:
                self._release_prefix(req)
            self.kv_pool.free(req.rid)
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

    def _push_pages(self, pids: List[int]) -> None:
        """Push ``pids`` onto the device free stack: one dispatch, no sync;
        the id vector is padded to a power-of-two width with -1 (no-ops)."""
        width = 1 << (len(pids) - 1).bit_length() if len(pids) > 1 else 1
        vec = np.full((width,), -1, dtype=np.int32)
        vec[: len(pids)] = pids
        self.pages = self._push_fn(self.pages,
                                   torch.from_numpy(vec).to(self.device))
        self.stats.dispatches += 1
        self.page_pushes += 1

    # -- fault guards: watchdog, page-table audit ------------------------
    def inject_stall(self, slot: int, seconds: float) -> None:
        """Chaos hook: add ``seconds`` to the next chunk's measured wall
        time and blame ``slot``, so tests can trip the watchdog
        deterministically without a real hang."""
        self._stall = (int(slot), float(seconds))

    def inject_kv_corruption(self, slot: int, *,
                             pid: Optional[int] = None) -> None:
        """Chaos hook: overwrite ``slot``'s first mapped page-table entry
        with ``pid`` (default: an out-of-range id), simulating a flipped bit
        in the table; another slot's physical id forges a double mapping.
        One unguarded host read of the row, then one in-place write on the
        device, between steps.  ``audit=True`` detects and self-heals either
        on the next chunk's sync."""
        if not self.paged:
            raise ValueError("page corruption applies to paged batchers")
        row = self.pages.table[slot].cpu().numpy()
        mapped = np.nonzero(row >= 0)[0]
        j = int(mapped[0]) if mapped.size else 0
        bad = int(pid) if pid is not None else self.n_pages + 7
        self.pages.table[slot, j] = bad

    def _host_release_slot(self, slot: int) -> None:
        """Host-side analogue of the in-chunk finish path: deactivate
        ``slot`` on the device and (paged) push its private pages back to
        the free stack, clearing its table row.  Cache-owned (pinned) pages
        are left to the refcount ledger; quarantined and out-of-range ids
        are never pushed."""
        active = self.state.active.clone()
        active[slot] = False
        self.state = self.state._replace(active=active)
        if not self.paged:
            return
        fetched = _Fetch(torch.cat([self.pages.table[slot],
                                    self.pages.pinned[slot:slot + 1]])).wait()
        self.stats.host_syncs += 1
        row, pin = fetched[:-1], int(fetched[-1])
        pids = [int(p) for p in row[pin:]
                if 0 <= p < self.n_pages and int(p) not in self._quarantined]
        table, pinned = self.pages.table.clone(), self.pages.pinned.clone()
        table[slot] = -1
        pinned[slot] = 0
        self.pages = self.pages._replace(table=table, pinned=pinned)
        if pids:
            self._push_pages(pids)
            self.stats.pages_in_use = max(
                0, self.stats.pages_in_use - len(pids))

    def _watchdog_trip(self, stall_slot: Optional[int]) -> None:
        """A chunk exceeded ``watchdog_s``: retire the most suspect slot (the
        injected one when the stall was synthetic, else the slot with the
        most generated tokens, the longest-running lane) and requeue its
        request, instead of letting one wedged lane stall every request on
        this batcher.  Tokens emitted before the trip are kept whenever they
        still fit the prompt bucket."""
        self.stats.watchdog_trips += 1
        self._tracer.instant("watchdog_trip", self._track)
        candidates = [i for i, r in enumerate(self.slot_req)
                      if r is not None]
        if stall_slot is not None and self.slot_req[stall_slot] is not None:
            victim = stall_slot
        elif candidates:
            victim = max(candidates,
                         key=lambda i: (len(self.slot_req[i].out), -i))
        else:
            return
        req = self.slot_req[victim]
        self._host_release_slot(victim)
        self._requeue_slot(victim, req)

    def _run_audit(self, table_np: np.ndarray) -> None:
        """Cross-check the fetched page tables against the no-double-mapping
        invariant: every physical id maps at most one (slot, logical) entry
        unless it is cache-owned (shared prefix pages are read-only and
        legitimately multi-mapped).  Violations self-heal: out-of-range
        entries are cleared, a double-mapped private page is unmapped
        everywhere and **quarantined** (never returned to the free stack;
        billed to a ``"__quarantine__"`` ledger owner so admission control
        sees the shrunken pool), and every slot that lost a mapping is
        requeued: its KV integrity is suspect, but its emitted tokens are
        host-side and kept.  ``table_np`` is the table as the chunk left it;
        the repairs act on the live table, which overlap admission may have
        written since."""
        shared = self.kv_pool.shared_ids()
        owner: Dict[int, tuple] = {}
        clear: set = set()               # (slot, logical) entries to wipe
        corrupt: set = set()             # pool pids leaving circulation
        suspects: set = set()            # slots whose KV integrity is gone
        B, maxp = table_np.shape
        for i in range(B):
            for j in range(maxp):
                pid = int(table_np[i, j])
                if pid < 0:
                    continue
                if pid >= self.n_pages or pid in self._quarantined:
                    clear.add((i, j))
                    suspects.add(i)
                    continue
                if pid in shared:
                    continue
                prev = owner.get(pid)
                if prev is None:
                    owner[pid] = (i, j)
                else:
                    clear.add(prev)
                    clear.add((i, j))
                    corrupt.add(pid)
                    suspects.add(prev[0])
                    suspects.add(i)
        if not clear:
            return
        entries = sorted(clear)
        dev = self.device
        rows = torch.tensor([e[0] for e in entries], dtype=torch.long,
                            device=dev)
        cols = torch.tensor([e[1] for e in entries], dtype=torch.long,
                            device=dev)
        self.pages = self.pages._replace(table=self.pages.table.index_put(
            (rows, cols), torch.tensor(-1, dtype=torch.int32, device=dev)))
        self.stats.audit_repairs += len(entries)
        self._tracer.instant("audit_repair", self._track,
                             args={"entries": len(entries)})
        new_q = corrupt - self._quarantined
        self._quarantined |= corrupt
        self.stats.quarantined_pages = len(self._quarantined)
        if new_q:
            try:
                self.kv_pool.alloc("__quarantine__", len(new_q))
            except PageQuotaError:
                pass        # ledger over-subscribed; the device governs
        for i in sorted(suspects):
            req = self.slot_req[i]
            if req is None:
                continue
            self._host_release_slot(i)
            self._requeue_slot(i, req)
        # leak reconciliation: the corrupt entry overwrote some page's only
        # mapping, orphaning it: neither mapped, free, shared, nor
        # quarantined.  Its owner was just requeued, so the contents are
        # dead, and the page itself is fine (the *table* was corrupt), so
        # orphans go back on the free stack: corruption never shrinks the
        # pool beyond the quarantined pages.
        pg = self.pages
        fetched = _Fetch(torch.cat([pg.table.reshape(-1), pg.free,
                                    pg.free_top.reshape(1)])).wait()
        self.stats.host_syncs += 1
        tab = fetched[: B * maxp]
        free_np, top = fetched[B * maxp:-1], int(fetched[-1])
        known = set(tab[tab >= 0].tolist())
        known |= set(free_np[:top].tolist())
        known |= shared | self._quarantined
        leaked = [p for p in range(self.n_pages) if p not in known]
        if leaked:
            self._push_pages(leaked)
            self.stats.audit_repairs += len(leaked)

    # -- admission: right-sized prefill + per-slot scatter ---------------
    def _padded_row(self, req: Request) -> np.ndarray:
        """The request's prompt-bucket row: prompt (plus any tokens kept by
        a requeue) left-padded with 0s to ``prompt_len``.  Memoised per
        (request, emitted-token count): the witness scan asks for every
        queued request's row each admission round."""
        cached = getattr(req, "_row_cache", None)
        if cached is not None and cached[0] == len(req.out):
            return cached[1]
        row = np.zeros((self.prompt_len,), dtype=np.int32)
        toks = np.asarray(req.prompt, dtype=np.int32)
        if req.out:
            toks = np.concatenate(
                [toks, np.asarray(req.out, dtype=np.int32)])
        row[self.prompt_len - len(toks):] = toks
        req._row_cache = (len(req.out), row)
        return row

    def _release_prefix(self, req: Request) -> None:
        """Unpin the request's cached-prefix pages (tree refcounts + ledger
        refcounts).  Refcount-0 pages stay cached until an eviction."""
        if req._prefix_nodes:
            self.prefix.release(req._prefix_nodes)
            self.kv_pool.release([n.page_id for n in req._prefix_nodes])
            req._prefix_nodes = []

    def _queue_path_counts(self) -> Dict[Any, int]:
        """How many pending requests carry each page-aligned prefix path —
        the round's sharing witness for the insert heuristic.  Bounded to
        the queue's first 16·B entries so a deep backlog doesn't make
        admission O(queue²)."""
        counts: Dict[Any, int] = {}
        if self.prefix is None:
            return counts
        ps = self.page_size
        max_share = self.prefix.max_shareable(self.prompt_len)
        for n_seen, r in enumerate(self.queue):
            if n_seen >= 16 * self.B:
                break
            if r.namespace is None:
                continue
            row = self._padded_row(r)
            for i in range(max_share):
                key = (r.namespace, i, row[:(i + 1) * ps].tobytes())
                counts[key] = counts.get(key, 0) + 1
        return counts

    def _plan_join(self, req: Request, planned_paths: set,
                   witness: Dict[Any, int]):
        """Prefix-cache plan for one joining request: the cached page path
        (hits), and how many of the following full pages this admission
        will insert.  Inserts are contiguous from the hit depth, capped at
        the deepest prefix with **recurrence evidence** — shared by another
        pending request (queue witness) or seen in an earlier lookup (ghost
        index) — and skip paths another join of this round already claimed
        (its physical ids are unknown until that dispatch's sync)."""
        if self.prefix is None or req.namespace is None:
            return [], 0
        row = self._padded_row(req)
        max_share = self.prefix.max_shareable(self.prompt_len)
        nodes = self.prefix.lookup(req.namespace, row, max_pages=max_share)
        if req.resumed and not nodes:
            # a resumed row (prompt + kept tokens) is left-padded otherwise
            # than the original prompt and cannot hit the original's pages
            self.stats.resume_prefix_misses += 1
        seen_depth = self.prefix.note_seen(req.namespace, row,
                                           max_pages=max_share)
        ps = self.page_size
        queue_depth = 0
        for i in range(max_share):
            key = (req.namespace, i, row[:(i + 1) * ps].tobytes())
            if witness.get(key, 0) < 2:     # this request counts once
                break
            queue_depth = i + 1
        worth = max(seen_depth, queue_depth, len(nodes))
        inserts = 0
        for i in range(len(nodes), min(max_share, worth)):
            path = (req.namespace, tuple(int(t) for t in row[:(i + 1) * ps]))
            if path in planned_paths:
                break
            planned_paths.add(path)
            inserts += 1
        return nodes, inserts

    def _admit(self, *, defer: bool = False) -> List[Dict[str, Any]]:
        """Admission planning and prefill dispatch.  With ``defer=False`` the
        post-dispatch host work (first tokens, done-at-admission requests,
        prefix inserts, draft seeding) runs inline and ``[]`` is returned;
        with ``defer=True`` each dispatch comes back as a pending record for
        :meth:`_finish_admit`: the overlap path dispatches admission behind
        the in-flight chunk and merges both at one point per round."""
        self._shed_expired()
        free = self._free_slots()
        if not free or not self.queue:
            return []
        if not self.paged:
            return self._admit_dense(free, defer=defer)
        joins: List[Dict[str, Any]] = []
        planned_paths: set = set()
        witness = self._queue_path_counts()
        resident = sum(r is not None for r in self.slot_req)
        prompt_pages = pages_for(self.prompt_len, self.page_size)
        while free and self.queue:
            if resident + len(joins) >= self._resident_cap:
                break
            req = self.queue[0]
            nodes, inserts = self._plan_join(req, planned_paths, witness)
            k = len(nodes)
            if nodes:
                # pin the hit path now: the pressure eviction below must
                # never reclaim pages this join is about to map
                self.prefix.acquire(nodes)
                self.kv_pool.acquire([n.page_id for n in nodes])
                req._prefix_nodes = list(nodes)
            # admission by page availability, head of line: the queue head
            # joins only when its reservation (minus cache-served pages)
            # fits the pool and the lease; under pressure LRU cache entries
            # are evicted back to the free stack before giving up
            need = self._request_pages(req) - k
            pop = prompt_pages - k
            short = self._page_shortfall(need, pop)
            if short:
                self._evict_cached(short)
                if not self._pages_available(need, pop):
                    if nodes:
                        self._release_prefix(req)
                    break
            self.kv_pool.alloc(req.rid, need)
            if nodes:
                self.stats.prefix_hits += 1
                self.stats.prefill_tokens_skipped += k * self.page_size
            self._admitted_pages_since_sync += pop
            joins.append({"slot": free.pop(0), "req": self.queue.popleft(),
                          "k": k, "pin": k + inserts, "pop": pop,
                          "nodes": nodes})
        if not joins:
            return []
        # one dispatch per cached-prefix depth: the suffix length differs
        by_depth: Dict[int, List[Dict[str, Any]]] = {}
        for join in joins:
            by_depth.setdefault(join["k"], []).append(join)
        pending = [self._dispatch_paged(by_depth[k], k)
                   for k in sorted(by_depth)]
        self.stats.shared_pages = self.kv_pool.shared
        if defer:
            return pending
        for rec in pending:
            self._finish_admit(rec)
        return []

    def _admit_dense(self, free: List[int], *,
                     defer: bool = False) -> List[Dict[str, Any]]:
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
        rec = {"kind": "dense", "joins": joins, "fetch": _Fetch(nxt)}
        if defer:
            return [rec]
        self._finish_admit(rec)
        return []

    def _dispatch_paged(self, group: List[Dict[str, Any]],
                        k: int) -> Dict[str, Any]:
        """One paged admission dispatch for joins sharing ``k`` cached prefix
        pages: the cold step at k == 0, the cached-suffix step otherwise.
        Both return the written table rows, from which the planned inserts
        learn their physical ids.  Returns the pending record for
        :meth:`_finish_admit` (no host sync here)."""
        n = len(group)
        nb = min(1 << (n - 1).bit_length() if n > 1 else 1, self.B)
        ps = self.page_size
        S = self.prompt_len - k * ps
        toks = np.zeros((nb, S), dtype=np.int32)
        slots = np.zeros((nb,), dtype=np.int32)
        budget = np.zeros((nb,), dtype=np.int32)
        eos = np.full((nb,), -1, dtype=np.int32)
        pin = np.zeros((nb,), dtype=np.int32)
        pids = np.zeros((nb, max(k, 1)), dtype=np.int32)
        rows = [self._padded_row(join["req"]) for join in group]
        for j, join in enumerate(group):
            req = join["req"]
            toks[j] = rows[j][k * ps:]
            slots[j] = join["slot"]
            budget[j] = req.max_new - len(req.out)
            if req.eos is not None:
                eos[j] = req.eos
            pin[j] = join["pin"]
            if k:
                pids[j] = [node.page_id for node in join["nodes"]]
        for j in range(n, nb):        # duplicate-pad with row 0 (see above)
            toks[j] = toks[0]
            slots[j] = slots[0]
            budget[j] = budget[0]
            eos[j] = eos[0]
            pin[j] = pin[0]
            pids[j] = pids[0]
        pos0 = np.full((nb,), self.prompt_len, dtype=np.int32)
        real = np.zeros((nb,), dtype=bool)
        real[:n] = True
        dev = self.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        args = (self.params, {"tokens": t(toks)}, self.caches, self.state,
                self.pages, t(slots), t(pos0), t(budget), t(eos), t(real))
        if k:
            fn = make_cached_admit_step(self.cfg, self.scfg, k)
            nxt, self.caches, self.state, self.pages, out_rows = fn(
                *args, t(pids), t(pin))
        else:
            nxt, self.caches, self.state, self.pages, out_rows = \
                self._admit_fn(*args, t(pin))
        self.stats.prefills += 1
        self.stats.dispatches += 1
        self.stats.admit_scatter_bytes += int(
            self.stats.cache_bytes * nb * S
            / max(self.B * self.prompt_len, 1)
        )
        # first tokens and written rows come back packed: one fetch
        fetch = _Fetch(torch.cat([nxt[:, None], out_rows], dim=1))
        return {"kind": "paged", "joins": group, "k": k, "fetch": fetch,
                "rows": rows}

    def _finish_admit(self, rec: Dict[str, Any]) -> None:
        """Post-dispatch half of one admission: read the first tokens (one
        host sync per record), append them, complete done-at-admission
        requests, run the planned prefix inserts, and seed the drafter
        history of the slots that stay resident."""
        k = rec.get("k", 0)
        fetched = rec["fetch"].wait()                   # ONE host sync
        if rec["kind"] == "paged":
            nxt_np, rows_np = fetched[:, 0], fetched[:, 1:]
        else:
            nxt_np, rows_np = fetched, None
        self.stats.host_syncs += 1
        seeds: List[Tuple[int, Request]] = []
        for j, join in enumerate(rec["joins"]):
            slot, req = join["slot"], join["req"]
            tok = int(nxt_np[j])
            req.out.append(tok)
            self.stats.admit_tokens += 1
            hit_eos = req.eos is not None and tok == req.eos
            if len(req.out) >= req.max_new or hit_eos:
                req.done = True
                self.stats.completed += 1
                if rec["kind"] == "paged":
                    if self.prefix is not None:
                        self._release_prefix(req)
                    self.kv_pool.free(req.rid)
                    # done at admission: the device popped no prompt pages
                    # for it, so take it back out of the since-sync estimate
                    self._admitted_pages_since_sync -= join["pop"]
                continue
            self.slot_req[slot] = req
            seeds.append((slot, req))
            inserts = join.get("pin", 0) - k
            if inserts > 0:
                new_pids = rows_np[j, k:join["pin"]]
                if (new_pids >= 0).all():
                    created = self.prefix.insert(
                        req.namespace, rec["rows"][j], new_pids,
                        start_page=k)
                    if len(created) != inserts:
                        raise RuntimeError(
                            f"prefix insert created {len(created)} pages, "
                            f"{inserts} planned")
                    cpids = [node.page_id for node in created]
                    self.kv_pool.share(req.rid, req.namespace, cpids)
                    self.kv_pool.acquire(cpids)
                    self.prefix.acquire(created)
                    req._prefix_nodes.extend(created)
                    self.stats.prefix_inserts += len(created)
        if self._spec and seeds:
            self._seed_draft(seeds)
        self.stats.peak_resident = max(
            self.stats.peak_resident,
            sum(r is not None for r in self.slot_req))

    def _seed_draft(self, seeds: List[Tuple[int, Request]]) -> None:
        """Seed the drafter history of freshly admitted slots from the
        host-known token stream (prompt + emitted tokens, newest last): one
        scatter per admission record, no sync.  Resumed requests re-seed
        with their kept output, so the n-gram index warms up again at
        once after a requeue."""
        N = self._draft_hist
        rows = np.full((len(seeds), N), -1, dtype=np.int32)
        ns = np.zeros((len(seeds),), dtype=np.int32)
        slots = np.array([s for s, _ in seeds], dtype=np.int64)
        for j, (_, req) in enumerate(seeds):
            toks = np.asarray(req.prompt, dtype=np.int32)
            if req.out:
                toks = np.concatenate(
                    [toks, np.asarray(req.out, dtype=np.int32)])
            tail = toks[-N:]
            rows[j, N - len(tail):] = tail
            ns[j] = len(tail)
        dev = self.device
        idx = torch.from_numpy(slots).to(dev)
        self.draft = DraftState(
            hist=self.draft.hist.index_put((idx,), torch.from_numpy(rows).to(dev)),
            n=self.draft.n.index_put((idx,), torch.from_numpy(ns).to(dev)))

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
        """Dispatch one decode chunk (speculative: T draft-and-verify
        windows; otherwise T decode steps) without syncing; returns the
        pending record for :meth:`_finish_chunk`.

        The chunk's results are packed and their fetch enqueued here, before
        anything that overlap admission dispatches behind the chunk: on one
        stream the packed copy then holds this chunk's ``active`` and
        ``free_top``, which the admission updates in place afterwards (the
        reference copies them for the same reason, as the admission step
        there donates them)."""
        T = self._pick_chunk(active)
        t0 = self._clock()
        W = self._draft_window if self._spec else 1
        ctr = None
        if self._spec and self.paged:
            chunk = make_paged_spec_decode_chunk(
                self.cfg, self.scfg, T, W, self._draft_ngram, self.page_size)
            (self.caches, self.state, self.pages, self.draft, toks, emitted,
             poisoned, ctr) = chunk(self.params, self.caches, self.state,
                                    self.pages, self.draft)
        elif self._spec:
            chunk = make_spec_decode_chunk(self.cfg, self.scfg, T, W,
                                           self._draft_ngram)
            (self.caches, self.state, self.draft, toks, emitted,
             poisoned) = chunk(self.params, self.caches, self.state,
                               self.draft)
        elif self.paged:
            chunk = make_paged_decode_chunk(self.cfg, self.scfg, T,
                                            self.page_size)
            (self.caches, self.state, self.pages, toks, emitted, poisoned,
             ctr) = chunk(self.params, self.caches, self.state, self.pages,
                          self._gen)
        else:
            chunk = make_decode_chunk(self.cfg, self.scfg, T)
            self.caches, self.state, toks, emitted, poisoned = chunk(
                self.params, self.caches, self.state, self._gen)
        # one packed int32 vector so the chunk costs one fetch: tokens,
        # emitted, poisoned, then (paged) active, free_top, the counters and
        # (audit) the page table; the copy is the table as this chunk left
        # it, before any admission behind the chunk writes it
        parts = [toks.reshape(-1), emitted.to(torch.int32).reshape(-1),
                 poisoned.to(torch.int32)]
        if self.paged:
            parts += [self.state.active.to(torch.int32),
                      self.pages.free_top.reshape(1), ctr]
            if self._audit:
                parts.append(self.pages.table.reshape(-1))
        fetch = _Fetch(torch.cat(parts))
        self.stats.steps += T * W
        self.stats.chunks += 1
        self.stats.dispatches += 1
        if self._tracer.enabled:
            self._tracer.complete("dispatch", self._track, t0,
                                  self._clock() - t0,
                                  {"T": T, "active": len(active)})
        return {"fetch": fetch, "t0": t0, "T": T, "W": W, "active": active}

    def _finish_chunk(self, pending: Dict[str, Any], *,
                      keep_admitted_pages: int = 0) -> None:
        """Sync one dispatched chunk and run the host bookkeeping: token
        emission, completion, poison and OOM requeues, page accounting,
        audit, watchdog.
        ``keep_admitted_pages`` is the number of pages that admission
        dispatched *behind* this chunk has popped: the fetched ``free_top``
        predates those pops, so they survive the estimate's reset."""
        T, W, active = pending["T"], pending["W"], pending["active"]
        B = self.B
        t_sync0 = self._clock() if self._tracer.enabled else 0.0
        fetched = pending["fetch"].wait()                 # ONE host sync
        elapsed = self._clock() - pending["t0"]
        if self._tracer.enabled:
            t_end = pending["t0"] + elapsed
            self._tracer.complete("host_sync", self._track, t_sync0,
                                  t_end - t_sync0)
            self._tracer.complete("chunk", self._track, pending["t0"],
                                  elapsed, {"T": T, "slots": len(active)})
        stall_slot: Optional[int] = None
        if self._stall is not None:
            stall_slot, extra = self._stall
            self._stall = None
            elapsed += extra
        n = T * B * W
        toks_np = fetched[:n].reshape(T, B, W)
        emit_np = fetched[n:2 * n].reshape(T, B, W)
        poison_np = fetched[2 * n:2 * n + B]
        self.stats.host_syncs += 1
        # busy/total count query positions: speculative occupancy then
        # shows rejected drafts as idle device work
        self.stats.slot_total_steps += B * T * W
        self.stats.slot_busy_steps += int(emit_np.sum())
        for i in active:
            req = self.slot_req[i]
            for t in range(T):
                # emitted is a per-window prefix mask (W = 1 without spec)
                c = int(emit_np[t, i].sum())
                if c == 0:
                    break       # deactivated (EOS, budget, OOM, poison)
                req.out.extend(int(x) for x in toks_np[t, i, :c])
                self.stats.decode_tokens += c
                if self._spec:
                    self.stats.spec_windows += 1
                    self.stats.drafted_tokens += W - 1
                    self.stats.accepted_tokens += c - 1
            self._maybe_complete(i, req)
        # non-finite sentinel: the device deactivated the flagged slots
        # before selecting or emitting a token (and, paged, recycled their
        # pages in the same step); requeue the victims
        for i in active:
            req = self.slot_req[i]
            if req is not None and bool(poison_np[i]):
                self.stats.poisoned_slots += 1
                self._tracer.instant("poisoned_slot", self._track,
                                     args={"slot": i})
                self._requeue_slot(i, req)
        if self.paged:
            rest = fetched[2 * n + B:]
            active_np, free_top = rest[:B], int(rest[B])
            ctr_np, table_np = rest[B + 1:B + 5], rest[B + 5:]
            self.stats.device_pages_popped += int(ctr_np[0])
            self.stats.device_pages_pushed += int(ctr_np[1])
            self.stats.fault_denied_slots += int(ctr_np[2])
            self.stats.device_draft_accepted += int(ctr_np[3])
            self._stalled = self._stalled + 1 \
                if int(emit_np.sum()) == 0 else 0
            # a slot that deactivated without finishing was denied a page:
            # requeue its request at the head, keeping its tokens when
            # prompt + output still fit the prompt bucket
            oomed = 0
            for i in active:
                req = self.slot_req[i]
                if req is not None and not bool(active_np[i]):
                    self._tracer.instant("oom_requeue", self._track,
                                         args={"slot": i})
                    if self._requeue_slot(i, req):
                        self.stats.oom_resumed += 1
                    self.stats.oom_requeues += 1
                    oomed += 1
            if oomed:
                self._resident_cap = max(
                    1, sum(r is not None for r in self.slot_req))
            elif self._resident_cap < self.B:
                self._resident_cap += 1
            self.stats.pages_in_use = self.n_pages - free_top
            self.stats.peak_pages_in_use = max(
                self.stats.peak_pages_in_use, self.stats.pages_in_use)
            self._admitted_pages_since_sync = keep_admitted_pages
            if self._audit:
                self._run_audit(table_np.reshape(B, -1))
        if self._watchdog_s is not None and elapsed > self._watchdog_s:
            self._watchdog_trip(stall_slot)

    def _maybe_complete(self, slot: int, req: Request) -> None:
        """Retire ``slot`` if its request just hit EOS or its budget."""
        hit_eos = req.eos is not None and req.out and req.out[-1] == req.eos
        if len(req.out) >= req.max_new or hit_eos:
            req.done = True
            self.slot_req[slot] = None
            self.stats.completed += 1
            if self.paged:
                if self.prefix is not None:
                    self._release_prefix(req)
                self.kv_pool.free(req.rid)

    # -- one scheduling round ---------------------------------------------
    def step(self) -> None:
        """One scheduling round.

        Serial (default): admit, then decode one chunk — two dispatches, two
        syncs, strictly ordered.

        Overlap (``overlap=True``): dispatch the decode chunk first (no
        sync), then run admission **behind it**: its host-side planning
        (queue scan, prefix lookups, row packing) and its prefill dispatch
        happen while the card is still decoding, and the one stream orders
        the admission's in-place writes after the chunk.  One merge point
        per round: the chunk's sync, then each admission's.  The chunk ran
        against pre-admission state, so its fetched ``active``/``free_top``
        never see the new slots; this round's admission pops are carried
        across the estimate's reset."""
        if not self._overlap:
            with self._tracer.span("round", self._track):
                with self._tracer.span("admission", self._track):
                    self._admit()
                active = [i for i, r in enumerate(self.slot_req)
                          if r is not None]
                if not active:
                    return
                self._finish_chunk(self._dispatch_chunk(active))
            return
        with self._tracer.span("round", self._track):
            active = [i for i, r in enumerate(self.slot_req)
                      if r is not None]
            pending = self._dispatch_chunk(active) if active else None
            pops_before = self._admitted_pages_since_sync
            with self._tracer.span("admission", self._track):
                admits = self._admit(defer=True)
            round_pops = self._admitted_pages_since_sync - pops_before
            if pending is not None and admits:
                self.stats.overlap_rounds += 1
                self._tracer.instant("overlap_merge", self._track,
                                     args={"admits": len(admits)})
            if pending is not None:
                self._finish_chunk(pending, keep_admitted_pages=round_pops)
            for rec in admits:
                self._finish_admit(rec)

    def run(self, *, max_steps: int = 10_000) -> BatcherStats:
        while (self.queue or any(r is not None for r in self.slot_req)) and \
                self.stats.steps < max_steps:
            before = self.stats.dispatches
            self.step()
            if self.stats.dispatches == before and \
                    not any(r is not None for r in self.slot_req):
                break   # starved: queued work cannot be admitted
            if self._stalled >= 8:
                break   # page-fault livelock: the pool cannot fit even one
                        # request's footprint at the current quota
        return self.stats

