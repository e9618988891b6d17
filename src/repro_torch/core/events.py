"""Global event model for the hypervisor's discrete-event loop.

Copy of ``repro.core.events`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_tenancy.py`` holds the two against each other).

The paper's hypervisor (§4.1) multiplexes one physical accelerator among many
tenants whose tasks arrive and leave at millisecond granularity.  We model
that as a single time-ordered queue of :class:`Event` records — tenant
arrivals, departures, per-request arrivals and completions, explicit
reconfiguration signals, and straggler probes — consumed by
:class:`repro_torch.core.hypervisor.Hypervisor`.

Determinism rules (they make event-driven runs reproducible and testable):

* events pop in non-decreasing ``time`` order;
* at equal time, kinds pop in a **documented fixed priority** (the
  ``_KIND_RANK`` table): failures first (every other same-instant event
  must already see the shrunk pool — a chaos replay is only byte-stable if
  a failure and a completion at the same timestamp always order the same
  way), then departures (a simultaneous arrival sees the cores a departing
  tenant frees), completions, explicit reconfiguration signals, recoveries
  (repaired cores become placeable before same-instant arrivals ask),
  tenant arrivals, request arrivals after the tenant arrival that may
  carry them, probes last;
* remaining ties break by insertion order (``seq``), never by dict/hash order.

**Open-loop traffic.**  The seed engine re-issued each tenant's next
inference the moment the previous one finished (closed loop) — fine for
throughput figures, useless for latency SLOs, where *offered load* must be
independent of how fast the system drains it.  :class:`PoissonTraffic` and
:class:`TraceTraffic` generate seeded, reproducible arrival-time streams;
:func:`emit_requests` turns one into ``REQUEST`` events carrying
:class:`RequestRecord` instances whose ``t_start``/``t_complete`` fields the
executor stamps as the request moves through the system.  Same seed →
byte-identical event stream.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import random
from typing import Any, Dict, Iterable, List, Optional, Sequence


class EventKind(enum.Enum):
    """What happened at ``Event.time`` (ordered by handling priority)."""

    FAILURE = "failure"          # a fault fires (core death/slowdown/corruption)
    DEPARTURE = "departure"      # tenant leaves; its lease is released
    COMPLETION = "completion"    # a tenant request finished (accounting hook)
    RECONFIG = "reconfig"        # explicit resize signal for one tenant
    RECOVERY = "recovery"        # a fault repairs / a displaced tenant retries
    ARRIVAL = "arrival"          # tenant asks for admission
    REQUEST = "request"          # one inference request arrives for a tenant
    PROBE = "probe"              # pool-wide straggler probe

    @property
    def rank(self) -> int:
        return _KIND_RANK[self]


#: Same-timestamp handling priority (see the module docstring).  FAILURE
#: outranks everything — a same-instant completion/reconfig/arrival must see
#: the post-fault pool; RECOVERY sits after bookkeeping kinds but before
#: ARRIVAL so repaired cores are placeable for simultaneous admissions.
#: Remaining ties break by ``Event.seq`` (insertion order).
_KIND_RANK = {
    EventKind.FAILURE: 0,
    EventKind.DEPARTURE: 1,
    EventKind.COMPLETION: 2,
    EventKind.RECONFIG: 3,
    EventKind.RECOVERY: 4,
    EventKind.ARRIVAL: 5,
    EventKind.REQUEST: 6,
    EventKind.PROBE: 7,
}


@dataclasses.dataclass
class Event:
    """One point on the global timeline.

    ``payload`` carries kind-specific data: the :class:`TenantSpec` for an
    arrival, the target core count for a reconfiguration signal, free-form
    accounting fields for completions.
    """

    time: float
    kind: EventKind
    tenant: Optional[str] = None
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seq: int = -1   # assigned by the queue; insertion-order tie-break

    def __repr__(self) -> str:  # compact, for traces in test failures
        who = f" {self.tenant}" if self.tenant else ""
        return f"<{self.kind.value}{who} @ {self.time:g}>"


class EventQueue:
    """Min-heap of events ordered by (time, kind rank, insertion seq)."""

    def __init__(self) -> None:
        self._heap: List[tuple] = []
        self._count = itertools.count()

    def push(self, event: Event) -> Event:
        event.seq = next(self._count)
        heapq.heappush(self._heap, (event.time, event.kind.rank, event.seq, event))
        return event

    def schedule(self, kind: EventKind, time: float, *, tenant: Optional[str] = None,
                 **payload: Any) -> Event:
        return self.push(Event(time=time, kind=kind, tenant=tenant, payload=payload))

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[-1]

    def peek(self) -> Optional[Event]:
        return self._heap[0][-1] if self._heap else None

    def next_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# ---------------------------------------------------------------------------
# open-loop request traffic
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One inference request's lifecycle, stamped as it moves through the
    system: arrival (offered), start (dequeued onto cores), completion.

    The record object is shared between the traffic source, the event
    payload, and the executor — whoever created the stream can compute SLO
    attainment afterwards without collecting anything from the engine.  A
    request that was never served keeps ``t_complete is None`` and counts
    against attainment (the open-loop contract: offered load doesn't shrink
    because the system is slow).

    ``deadline`` is a hard useless-after time (absolute, same clock as
    ``t_arrival``): an executor that would only *start* the request after
    its deadline sheds it instead of serving it hopelessly late —
    ``dropped`` marks that outcome (``t_complete`` stays None, so the drop
    still counts against attainment)."""

    tenant: str
    rid: int
    t_arrival: float
    slo: Optional[float] = None        # per-request latency target (seconds)
    deadline: Optional[float] = None   # absolute shed-after time
    t_start: Optional[float] = None
    t_complete: Optional[float] = None
    dropped: bool = False

    @property
    def latency(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_arrival

    @property
    def slo_met(self) -> bool:
        """Served within the target.  Unserved or target-less requests are
        *not* met (a request without an SLO never counts as attained; filter
        them out of the denominator if that is what you want)."""
        lat = self.latency
        return lat is not None and self.slo is not None and lat <= self.slo


class PoissonTraffic:
    """Seeded open-loop Poisson arrival process (exponential inter-arrivals).

    Determinism contract: ``PoissonTraffic(rate, seed=s).times(h)`` returns
    the identical list on every call and every platform — the stream is
    drawn from a private ``random.Random(seed)`` re-seeded per call."""

    def __init__(self, rate: float, *, seed: int = 0, start: float = 0.0) -> None:
        if rate <= 0:
            raise ValueError(f"Poisson rate must be positive, got {rate}")
        self.rate = rate
        self.seed = seed
        self.start = start

    def times(self, horizon: float) -> List[float]:
        rng = random.Random(self.seed)
        out: List[float] = []
        t = self.start
        while True:
            t += rng.expovariate(self.rate)
            if t > horizon:
                return out
            out.append(t)


class TraceTraffic:
    """Replay a fixed arrival-time trace (already-sorted or not)."""

    def __init__(self, times: Sequence[float]) -> None:
        self._times = sorted(float(t) for t in times)

    def times(self, horizon: float) -> List[float]:
        return [t for t in self._times if t <= horizon]


def emit_requests(
    queue: EventQueue,
    tenant: str,
    traffic: Any,
    horizon: float,
    *,
    slo: Optional[float] = None,
    start_rid: int = 0,
    deadline_after: Optional[float] = None,
) -> List[RequestRecord]:
    """Schedule one ``REQUEST`` event per arrival of ``traffic`` (anything
    with a ``times(horizon)`` method, or a plain iterable of times) and
    return the shared :class:`RequestRecord` list for later SLO accounting.
    ``deadline_after`` stamps each record's ``deadline`` at arrival +
    that many seconds (the drop-policy knob)."""
    times: Iterable[float]
    if hasattr(traffic, "times"):
        times = traffic.times(horizon)
    else:
        times = [t for t in sorted(traffic) if t <= horizon]
    records = []
    for i, t in enumerate(times):
        rec = RequestRecord(
            tenant=tenant, rid=start_rid + i, t_arrival=t, slo=slo,
            deadline=(t + deadline_after if deadline_after is not None
                      else None))
        queue.schedule(EventKind.REQUEST, t, tenant=tenant, record=rec)
        records.append(rec)
    return records
