"""Metrics registry: counters, gauges and wall-clock histograms.

The paper's contribution is counted in instructions *removed* — CAS and
cache-flush operations elided from PMwCAS — so the numbers that matter
here are counts (flushes issued/saved, fences, commits) and wall-clock
latencies (microsecond percentiles).  The registry is the one place both
kinds live: every series is ``(name, labels)``-keyed, so the same metric
name can be tracked per strategy, per shard, or per backend without
inventing new dataclasses.

Three series types:

- :class:`Counter` — monotone-by-convention accumulator (negative deltas
  are allowed for honest-ledger corrections, mirroring
  ``DurabilityStats.flushes_saved``);
- :class:`Gauge` — last-write-wins level (idempotent to re-fold, which
  is why the stats-adapter snapshot folds use gauges);
- :class:`Histogram` — wall-clock samples in MICROSECONDS with p50/p99,
  a bounded reservoir of recent samples (a long-running service must
  not grow its sample list without bound) plus lifetime count/sum.

A process-global default registry (:func:`get_registry`) backs the live
instrumentation in the committer and service layers;
:func:`reset_metrics` starts a fresh measurement window (zero every
series in place, registrations kept) — the registry analogue of
``KVService.reset_stats``.

Thread safety: registry lookups take a lock; the series mutators are
single attribute updates (atomic enough under the GIL for counters whose
writers are the service wave loop and its helpers).
"""
from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, Hashable], ...]


def _label_key(labels: Dict[str, Hashable]) -> LabelKey:
    return tuple(sorted(labels.items()))


class Counter:
    """Accumulating series (``inc`` deltas; see module docstring)."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, delta: int = 1) -> "Counter":
        self.value += delta
        return self

    def reset(self) -> None:
        self.value = 0

    def __repr__(self) -> str:
        return f"Counter({self.name}{dict(self.labels)}={self.value})"


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, value: float) -> "Gauge":
        self.value = value
        return self

    def reset(self) -> None:
        self.value = 0.0

    def __repr__(self) -> str:
        return f"Gauge({self.name}{dict(self.labels)}={self.value})"


class Histogram:
    """Wall-clock samples (microseconds) with bounded percentile window.

    ``record`` keeps the most recent ``window`` samples for percentiles
    and lifetime ``count``/``total_us`` for means; ``percentile`` is
    computed over the window (recent-traffic percentiles, the same
    semantics as ``ServiceStats.MAX_LATENCY_SAMPLES``).
    """

    __slots__ = ("name", "labels", "window", "samples", "count",
                 "total_us", "max_us")
    kind = "histogram"
    DEFAULT_WINDOW = 4096

    def __init__(self, name: str = "", labels: LabelKey = (),
                 window: int = DEFAULT_WINDOW):
        self.name = name
        self.labels = labels
        self.window = window
        self.samples: List[float] = []
        self.count = 0
        self.total_us = 0.0
        self.max_us = 0.0

    def record(self, us: float) -> "Histogram":
        us = float(us)
        self.samples.append(us)
        if len(self.samples) > self.window:
            del self.samples[:len(self.samples) - self.window]
        self.count += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us
        return self

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    @property
    def p50_us(self) -> float:
        return self.percentile(50.0)

    @property
    def p99_us(self) -> float:
        return self.percentile(99.0)

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0

    def reset(self) -> None:
        self.samples = []
        self.count = 0
        self.total_us = 0.0
        self.max_us = 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_us": round(self.mean_us, 3),
                "p50_us": round(self.p50_us, 3),
                "p99_us": round(self.p99_us, 3),
                "max_us": round(self.max_us, 3)}

    def __repr__(self) -> str:
        return (f"Histogram({self.name}{dict(self.labels)} n={self.count} "
                f"p50={self.p50_us:.1f}us p99={self.p99_us:.1f}us)")


class MetricsRegistry:
    """Labeled-series store (see module docstring)."""

    def __init__(self):
        self._series: Dict[Tuple[str, str, LabelKey], object] = {}
        self._lock = threading.Lock()

    # -- get-or-create ---------------------------------------------------------
    def _get(self, kind: str, cls, name: str, labels: Dict, **kw):
        key = (kind, name, _label_key(labels))
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    series = cls(name, key[2], **kw)
                    self._series[key] = series
        return series

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    # -- reads -----------------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (0 when absent —
        a never-incremented metric measured nothing)."""
        key_labels = _label_key(labels)
        for kind in ("counter", "gauge"):
            series = self._series.get((kind, name, key_labels))
            if series is not None:
                return series.value
        return 0

    def series(self, name: Optional[str] = None) -> List[object]:
        """All registered series, optionally filtered by name."""
        with self._lock:
            out = list(self._series.values())
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def total(self, name: str) -> float:
        """Sum of a counter/gauge name across every label combination."""
        return sum(s.value for s in self.series(name)
                   if s.kind in ("counter", "gauge"))

    def as_rows(self) -> List[Dict]:
        """Flat machine-readable dump (benchmark JSON shape)."""
        rows = []
        for s in self.series():
            row = {"name": s.name, "kind": s.kind, "labels": dict(s.labels)}
            if s.kind == "histogram":
                row.update(s.summary())
            else:
                row["value"] = s.value
            rows.append(row)
        rows.sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        return rows

    def snapshot(self) -> Dict[str, float]:
        """Counter/gauge values keyed ``name{k=v,...}`` (histograms are
        summarized under ``name.count``/``name.p50_us``/``name.p99_us``)."""
        out: Dict[str, float] = {}
        for s in self.series():
            tag = "" if not s.labels else \
                "{" + ",".join(f"{k}={v}" for k, v in s.labels) + "}"
            if s.kind == "histogram":
                for k, v in s.summary().items():
                    out[f"{s.name}.{k}{tag}"] = v
            else:
                out[f"{s.name}{tag}"] = s.value
        return out

    # -- lifecycle -------------------------------------------------------------
    def reset(self) -> None:
        """Zero every series IN PLACE (registrations and the objects
        callers hold onto survive) — a fresh measurement window."""
        for s in self.series():
            s.reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (live instrumentation and the
    benchmark window accounting both go through it)."""
    return _REGISTRY


def reset_metrics() -> None:
    """Start a fresh measurement window on the default registry."""
    _REGISTRY.reset()
