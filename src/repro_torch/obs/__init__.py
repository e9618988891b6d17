"""repro_torch.obs — the port's unified telemetry plane.

Three pillars shared by every layer of the stack:

* :class:`MetricsRegistry` — typed counters/gauges/log-bucketed histograms
  with per-tenant labels; ``BatcherStats`` fields and the executor's SLO
  counters are thin views over it.
* :class:`Tracer` — structured spans + instants on an injectable clock,
  exported as Chrome-trace/Perfetto JSON and mirrored into
  ``torch.profiler`` ranges while a profiler records (``NULL_TRACER`` =
  disabled, zero-cost); :func:`profiled` is the one helper that opens a
  profiler range.
* :class:`Telemetry` — the bundle a layer accepts as one ``telemetry=``
  kwarg instead of three.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .trace import NULL_TRACER, Tracer, profiled


@dataclass
class Telemetry:
    """One handle threading metrics + tracing through a component.

    ``tenant`` labels every instrument the component records (per-tenant
    tracks in the trace, per-tenant labels in the registry); ``None``
    means unlabeled/shared.
    """

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = NULL_TRACER
    tenant: Optional[str] = None

    @property
    def track(self) -> str:
        return self.tenant if self.tenant is not None else "main"


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Telemetry",
    "Tracer",
    "percentile",
    "profiled",
]
