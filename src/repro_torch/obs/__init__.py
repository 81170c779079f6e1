"""repro_torch.obs — tracing, metrics, flush accounting and SLOs.

The bottom of the port's import graph, as ``repro.obs`` is of the
reference, with the reference's whole surface:

- :mod:`.metrics` — the registry: counters, gauges and microsecond
  histograms with labeled series; a process-global default backs the
  committer's and the service's live accounting.
- :mod:`.trace` — the span tracer: nested wall-clock spans at the
  load-bearing seams (round execute, WAL commit/persist/prune, recovery,
  stacked dispatch, chaos crash→recover), one branch while disabled.
- :mod:`.export` — JSONL and Chrome-trace exporters (Perfetto loads the
  latter) and the trace schema check.
- :mod:`.provenance` — the flush-provenance ledger and the
  redundant-fence detector counters.
- :mod:`.slo` — declarative :class:`SloSpec` objectives over sliding
  observation windows with multi-window burn rates (they judge every
  chaos scenario while its faults fire).
- :mod:`.adapters` — idempotent folds of the five ``*Stats``
  dataclasses into registry series, duck-typed.

Layering: anything in the port may import ``repro_torch.obs``;
``repro_torch.obs`` imports nothing of ``repro_torch`` outside itself.
"""
from .adapters import (fold_check, fold_dispatch, fold_durability,
                       fold_service, fold_workload)
from .export import (chrome_trace, export_chrome_trace, export_jsonl,
                     span_tree, validate_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_metrics)
from .provenance import current_flush_reason, flush_reason, record_fence
from .slo import SloEngine, SloSpec, validate_slo_report
from .trace import (NULL_SPAN, SpanTracer, disable_tracing, enable_tracing,
                    get_tracer, instant, span, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_metrics",
    "SpanTracer", "NULL_SPAN", "span", "instant", "get_tracer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "chrome_trace", "export_chrome_trace", "export_jsonl",
    "validate_chrome_trace", "span_tree",
    "flush_reason", "current_flush_reason", "record_fence",
    "SloSpec", "SloEngine", "validate_slo_report",
    "fold_durability", "fold_dispatch", "fold_service", "fold_check",
    "fold_workload",
]
