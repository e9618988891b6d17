"""Structured tracing: spans + instants, exported as Chrome-trace JSON, and
the port's one helper for ``torch.profiler`` ranges.

A :class:`Tracer` collects *complete spans* (name, track, start, duration)
and *instant events* from the hypervisor event loop, the serving executor,
and the batcher round loop, then exports them in the Chrome trace-event
format that both ``chrome://tracing`` and https://ui.perfetto.dev open
directly.  Tracks (one per tenant, plus ``hypervisor``/``batcher``/...)
become named rows in the timeline.

Design constraints, in order:

* **Zero-cost when disabled.** Every record method checks ``enabled``
  before touching the clock; ``span(...)`` and ``range(...)`` return a
  shared no-op context manager.  ``NULL_TRACER`` is the canonical disabled
  instance — layers default to it so instrumented code never branches on
  ``tracer is None``.
* **Mirrored into the profiler.** While a ``torch.profiler`` session
  records, each live span (``span(...)``) of an enabled tracer also opens
  a profiler range named ``RANGE_PREFIX + name`` (``serving.dispatch``),
  and ``range(name)`` opens such a range alone, around device work inside
  a span (the engine's ``serving.decode_model``).  The spans then sit on
  the profiler's own timeline beside the kernels they launch, while the
  tracer's events stay on its clock and can be read without a profiler.
  A disabled tracer opens no range even under a profiler, so a session
  that did not turn tracing on records what it recorded before: a range's
  GPU-side annotation spans the gaps between its kernels.
* **Injectable clock.** The tracer never calls ``time`` directly unless
  you let it; pass the same ``clock=`` the batcher/executor use and the
  sim's ``at=`` stamps, the batcher's wall-clock, and the tracer's spans
  share one timeline.  ``span(..., clock=)`` times one span on a caller's
  clock (the batcher times all of its spans on its own).  Events store
  raw clock *seconds*; export normalizes to the earliest timestamp and
  converts to microseconds, so sim-time (small floats near 0) and
  ``time.monotonic`` (large floats) both render sensibly — just don't mix
  the two in one tracer.
* **Bounded memory.** ``max_events`` caps retention; once full, new
  events are counted in ``dropped`` but not stored, so a runaway run
  can't eat the host (and committed sample traces stay small).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch

# the prefix of every profiler range a tracer opens
RANGE_PREFIX = "serving."


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_SPAN = _NullSpan()


def profiled(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else the shared no-op context: with no profiler, no range object is
    made."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


class _Span:
    """Live span context manager: stamps the clock on enter/exit and, while
    a profiler records, opens the span's profiler range."""

    __slots__ = ("_tracer", "name", "track", "args", "_clock", "_t0",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: Optional[Dict[str, Any]],
                 clock: Callable[[], float]) -> None:
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._clock = clock
        self._t0 = 0.0
        self._range = _NULL_SPAN

    def __enter__(self) -> "_Span":
        self._range = profiled(RANGE_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc: object) -> None:
        t1 = self._clock()
        self._range.__exit__(*exc)
        self._tracer.complete(self.name, self.track, self._t0,
                              t1 - self._t0, self.args)


class Tracer:
    """Collects spans/instants on an injectable clock; exports Chrome JSON."""

    def __init__(self, *, clock=None, enabled: bool = True,
                 max_events: int = 100_000) -> None:
        self.enabled = enabled
        self._clock = clock if clock is not None else time.monotonic
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0

    # -- recording -------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def instant(self, name: str, track: str = "main", *,
                ts: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Point-in-time event.  ``ts`` overrides the clock (sim time)."""
        if not self.enabled:
            return
        self._push({"ph": "i", "name": name, "track": track,
                    "ts": self._clock() if ts is None else ts,
                    "args": args})

    def complete(self, name: str, track: str, ts: float, dur: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Explicit span from pre-measured stamps (e.g. sim-time ranges)."""
        if not self.enabled:
            return
        self._push({"ph": "X", "name": name, "track": track,
                    "ts": ts, "dur": max(dur, 0.0), "args": args})

    def span(self, name: str, track: str = "main", *,
             args: Optional[Dict[str, Any]] = None,
             clock: Optional[Callable[[], float]] = None):
        """Context manager measuring the enclosed block on ``clock``
        (default: the tracer's), mirrored into a profiler range while a
        profiler records."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args,
                     clock if clock is not None else self._clock)

    def range(self, name: str):
        """A profiler range named ``RANGE_PREFIX + name`` and no event of
        the tracer's: for device work inside a span, which the host clock
        cannot time."""
        if not self.enabled:
            return _NULL_SPAN
        return profiled(RANGE_PREFIX + name)

    # -- export ----------------------------------------------------------
    def tracks(self) -> List[str]:
        out: List[str] = []
        for ev in self.events:
            if ev["track"] not in out:
                out.append(ev["track"])
        return out

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (object form).  Timestamps are shifted
        so the earliest event is t=0 and scaled seconds -> microseconds;
        each track becomes a named tid with a ``thread_name`` metadata
        record so Perfetto labels the rows."""
        t0 = min((ev["ts"] for ev in self.events), default=0.0)
        tids = {track: i for i, track in enumerate(self.tracks())}
        out: List[Dict[str, Any]] = []
        for track, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": tid, "args": {"name": track}})
        for ev in self.events:
            rec: Dict[str, Any] = {
                "ph": ev["ph"], "name": ev["name"], "pid": 1,
                "tid": tids[ev["track"]],
                "ts": (ev["ts"] - t0) * 1e6,
            }
            if ev["ph"] == "X":
                rec["dur"] = ev["dur"] * 1e6
            if ev["ph"] == "i":
                rec["s"] = "t"          # instant scope: thread
            if ev.get("args"):
                rec["args"] = ev["args"]
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


NULL_TRACER = Tracer(enabled=False, clock=lambda: 0.0, max_events=0)
