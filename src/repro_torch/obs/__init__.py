"""repro_torch.obs — tracing, metrics and flush accounting for the port.

The bottom of the port's import graph, as ``repro.obs`` is of the
reference: the metrics registry (:mod:`.metrics`), the span tracer
(:mod:`.trace`) and the flush-provenance ledger (:mod:`.provenance`).
The exporters, the SLO engine and the stats adapters come with a later
slice (ROADMAP Queue 1 #1, left out of the first slice).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_metrics)
from .provenance import current_flush_reason, flush_reason, record_fence
from .trace import (NULL_SPAN, SpanTracer, disable_tracing, enable_tracing,
                    get_tracer, instant, span, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_metrics",
    "SpanTracer", "NULL_SPAN", "span", "instant", "get_tracer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "flush_reason", "current_flush_reason", "record_fence",
]
