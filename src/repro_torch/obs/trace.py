"""Span tracer: nested wall-clock spans over the PMwCAS stack.

One tracer, two states:

- **disabled** (the default): ``span(...)`` returns a shared no-op
  context manager after a single attribute check — no allocation, no
  clock read, no lock.  The instrumented hot paths (round execute, WAL
  commit, persist fences, wave scheduling) pay ~100ns per seam, which
  the CI smoke (`scripts/obs_smoke.py`) bounds below 5% of the sim
  backend's per-op cost.
- **enabled**: every span records one Chrome-trace "complete" event
  (``ph: "X"``, microsecond ``ts``/``dur``) into a thread-safe ring
  buffer.  Nesting is tracked per thread, so each event knows its
  parent span by name; Perfetto/chrome://tracing reconstruct the same
  nesting from the timestamps alone.

The buffer is a bounded deque (``capacity`` events): a chaos soak run
cannot grow memory without bound — old events fall off the front and
``dropped`` counts them, so an exporter can say what it lost.

Spans mutate: ``sp = span("wal.prune"); with sp: ...; sp.set(pruned=n)``
attaches results discovered mid-span (no-op on the disabled singleton).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import get_registry


class _NullSpan:
    """The disabled-path singleton: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span (enabled tracer only); records on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0_ns", "_parent")

    def __init__(self, tracer: "SpanTracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0_ns = 0
        self._parent: Optional[str] = None

    def set(self, **attrs) -> "_Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0_ns
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        args = self.args
        if self._parent is not None:
            args = dict(args, parent=self._parent)
        self._tracer._record({
            "name": self.name, "ph": "X", "cat": "repro",
            "ts": self._t0_ns / 1e3, "dur": dur_ns / 1e3,
            "pid": 1, "tid": threading.get_ident(), "args": args})
        return False


class SpanTracer:
    """Nested-span recorder with an in-memory ring buffer (module
    docstring has the overhead story)."""

    DEFAULT_CAPACITY = 1 << 17          # 131072 events

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self.dropped = 0
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording -------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager for one nested span.  THE hot-path entry:
        when disabled this is one branch + a shared singleton."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Point-in-time event (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        self._record({"name": name, "ph": "i", "cat": "repro", "s": "t",
                      "ts": time.perf_counter_ns() / 1e3,
                      "pid": 1, "tid": threading.get_ident(),
                      "args": attrs})

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, event: Dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._count_dropped(1)
            self._events.append(event)

    def _count_dropped(self, n: int) -> None:
        """Every lost event lands in BOTH ledgers: the tracer's own
        ``dropped`` (exported as ``otherData.dropped_events``) and the
        registry counter ``spans_dropped{component="obs"}`` — so a
        benchmark window can see trace loss without holding the tracer."""
        self.dropped += n
        get_registry().counter("spans_dropped", component="obs").inc(n)

    # -- lifecycle -------------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> "SpanTracer":
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                # shrinking below the buffered count discards the oldest
                # events; count them — this path used to lose them silently
                lost = max(0, len(self._events) - capacity)
                if lost:
                    self._count_dropped(lost)
                self.capacity = capacity
                self._events = deque(self._events, maxlen=capacity)
        self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        self.enabled = False
        return self

    def clear(self) -> "SpanTracer":
        with self._lock:
            self._events.clear()
            self.dropped = 0
        return self

    def events(self) -> List[Dict]:
        """Snapshot of the buffered events, oldest first."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)


_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    """The process-global default tracer the stack instruments."""
    return _TRACER


def span(name: str, **attrs):
    """``get_tracer().span(...)`` — the one-liner the seams call."""
    return _TRACER.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    _TRACER.instant(name, **attrs)


def enable_tracing(capacity: Optional[int] = None) -> SpanTracer:
    return _TRACER.enable(capacity)


def disable_tracing() -> SpanTracer:
    return _TRACER.disable()


def tracing_enabled() -> bool:
    return _TRACER.enabled
