"""Self-hosted observability: metrics registry, tracing, flight recorder.

``repro_torch.obs`` is the one substrate the serve/ingest fleet reports
through — see docs/observability.md for the metric tables, the span
taxonomy, and the self-profiling walkthrough.  :mod:`repro_torch.obs.export`
is intentionally *not* imported here: shard workers import this package
on their hot path and must not pay for numpy-heavy export machinery
they never use.
"""
from repro_torch.obs.clock import monotime
from repro_torch.obs.registry import (
    HIST_EDGES_US,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    HistogramFamily,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    SPAN_PHASES,
    FlightRecorder,
    Span,
    configure,
    mint_trace_id,
    recorder,
    valid_trace_id,
)

__all__ = [
    "monotime",
    "HIST_EDGES_US",
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "HistogramFamily",
    "MetricsRegistry",
    "SPAN_PHASES",
    "FlightRecorder",
    "Span",
    "configure",
    "mint_trace_id",
    "recorder",
    "valid_trace_id",
]
