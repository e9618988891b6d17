"""Typed metrics: counters, gauges, and log-bucketed histograms.

One registry per process (or per test) unifies what used to live in
ad-hoc dicts scattered across the stack — ``BatcherStats`` fields,
``ServingExecutor``'s SLO counters, the hypervisor's request latencies —
under stable dotted names with an optional per-tenant label:

    reg = MetricsRegistry()
    reg.counter("serving.chunks", tenant="gold").inc()
    reg.histogram("slo.latency_s", tenant="gold").record(0.012)
    reg.histogram("slo.latency_s", tenant="gold").quantile(0.99)

Everything here is dependency-free and O(1) per record:

* :class:`Counter` / :class:`Gauge` are a single mutable ``value`` slot —
  cheap enough that ``BatcherStats`` fields can be thin *views* over them
  (the legacy field stays, the registry owns the number).
* :class:`Histogram` is log-bucketed: ``record`` is one ``log`` + one dict
  increment; quantiles come back with bounded relative error (the bucket
  growth factor, ~8% at the default base) — exact enough for p50/p95/p99
  SLO reporting without keeping every sample.
* :func:`percentile` is the *exact* sorted-list quantile the benches use
  on small sample sets (the one shared implementation — bench-local
  copies were deduplicated onto it).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """Exact empirical quantile of ``values`` (nearest-rank, the semantics
    the benches have always used): ``nan`` on an empty sample, else the
    element at floor(q * n) clamped into range."""
    if not values:
        return float("nan")
    vals = sorted(values)
    idx = min(int(q * len(vals)), len(vals) - 1)
    return vals[idx]


class Counter:
    """Monotonic (by convention) integer counter.  ``value`` is plain
    mutable state so field-view wrappers can both read and assign it."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0) -> None:
        self.value = value

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.value})"


class Gauge:
    """Last-write-wins scalar (pages in use, queue depth, ...)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0) -> None:
        self.value = value

    def set(self, v: float) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.value})"


class Histogram:
    """Log-bucketed histogram with O(1) record and bounded-error quantiles.

    Positive samples land in geometric buckets ``base**i <= v < base**(i+1)``
    (a dict of int -> count, so the bucket range is unbounded); zero and
    negative samples share a dedicated bucket.  ``quantile`` walks the
    cumulative counts and returns the geometric midpoint of the rank's
    bucket, clamped to the observed min/max — relative error is bounded by
    the bucket width (~8% at the default base), which is exact enough for
    percentile SLO attainment without retaining samples.
    """

    __slots__ = ("_base", "_log_base", "_buckets", "_zero", "count",
                 "total", "min", "max")

    def __init__(self, base: float = 1.08) -> None:
        assert base > 1.0
        self._base = base
        self._log_base = math.log(base)
        self._buckets: Dict[int, int] = {}
        self._zero = 0                      # samples <= 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._zero += 1
            return
        idx = int(math.floor(math.log(v) / self._log_base))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1); ``nan`` when empty."""
        if self.count == 0:
            return float("nan")
        rank = min(int(q * self.count), self.count - 1)
        if rank < self._zero:
            return min(self.min, 0.0)
        seen = self._zero
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank < seen:
                mid = self._base ** (idx + 0.5)
                return max(self.min, min(self.max, mid))
        return self.max          # unreachable unless counts drifted

    def quantiles(self, qs: Iterable[float] = (0.5, 0.95, 0.99),
                  ) -> Dict[str, float]:
        """The standard SLO percentile bundle: ``{"p50": ..., "p99": ...}``."""
        return {f"p{round(q * 100) if q * 100 == int(q * 100) else q * 100:g}":
                self.quantile(q) for q in qs}

    def __repr__(self) -> str:
        return (f"Histogram(n={self.count}, mean={self.mean:.4g}, "
                f"p99={self.quantile(0.99):.4g})" if self.count
                else "Histogram(n=0)")


class MetricsRegistry:
    """Process-local registry of named, per-tenant-labeled instruments.

    ``counter/gauge/histogram`` get-or-create, so call sites never need a
    registration phase; the key is ``(name, tenant)`` with ``tenant=None``
    meaning unlabeled.  ``snapshot`` returns a JSON-able dict for artifact
    upload and the bench gates.
    """

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, Optional[str]], Counter] = {}
        self._gauges: Dict[Tuple[str, Optional[str]], Gauge] = {}
        self._histograms: Dict[Tuple[str, Optional[str]], Histogram] = {}

    # -- get-or-create ---------------------------------------------------
    def counter(self, name: str, tenant: Optional[str] = None) -> Counter:
        key = (name, tenant)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, tenant: Optional[str] = None) -> Gauge:
        key = (name, tenant)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, tenant: Optional[str] = None,
                  *, base: float = 1.08) -> Histogram:
        key = (name, tenant)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(base=base)
        return h

    # -- queries ---------------------------------------------------------
    def labels(self, name: str) -> List[Optional[str]]:
        """Every tenant label recorded under ``name`` (any instrument)."""
        out = []
        for table in (self._counters, self._gauges, self._histograms):
            for (n, tenant) in table:
                if n == name and tenant not in out:
                    out.append(tenant)
        return out

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able dump: counters/gauges by ``name{tenant}``, histograms
        as count/mean/min/max plus the p50/p95/p99 bundle."""

        def label(key: Tuple[str, Optional[str]]) -> str:
            name, tenant = key
            return name if tenant is None else f"{name}{{{tenant}}}"

        out: Dict[str, Dict] = {
            "counters": {label(k): c.value
                         for k, c in sorted(self._counters.items(),
                                            key=lambda kv: label(kv[0]))},
            "gauges": {label(k): g.value
                       for k, g in sorted(self._gauges.items(),
                                          key=lambda kv: label(kv[0]))},
            "histograms": {},
        }
        for k, h in sorted(self._histograms.items(),
                           key=lambda kv: label(kv[0])):
            out["histograms"][label(k)] = {
                "count": h.count,
                "mean": h.mean if h.count else None,
                "min": h.min if h.count else None,
                "max": h.max if h.count else None,
                **({q: v for q, v in h.quantiles().items()} if h.count
                   else {"p50": None, "p95": None, "p99": None}),
            }
        return out

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        return path
