"""Exporters: JSONL event dump + Chrome trace-event format.

``export_chrome_trace`` writes the *JSON Object Format* of the Trace
Event spec — ``{"traceEvents": [...]}`` — which chrome://tracing and
Perfetto both load directly, so one chaos scenario or bench section
becomes an inspectable timeline.  ``validate_chrome_trace`` is the
schema check for every emitted trace (the exporter runs it on
itself before writing): a trace that does not validate is a bug in the
tracer, not a viewer quirk to shrug at.

``export_jsonl`` is the greppable flat form: one JSON event per line,
in buffer order.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Union

from .trace import SpanTracer, get_tracer

_PHASES = {"X", "i", "M"}        # complete, instant, metadata


def chrome_trace(tracer: Optional[SpanTracer] = None) -> Dict:
    """The tracer's buffer as a Trace-Event-format object (metadata
    event first so viewers name the process)."""
    tracer = tracer or get_tracer()
    meta = {"name": "process_name", "ph": "M", "pid": 1, "ts": 0.0,
            "args": {"name": "repro-pmwcas"}}
    return {"traceEvents": [meta] + tracer.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped}}


def validate_chrome_trace(obj: Dict) -> None:
    """Raise ``ValueError`` unless ``obj`` is a loadable Chrome trace:
    a dict with a ``traceEvents`` list whose events carry a string
    ``name``, a known ``ph``, numeric non-negative ``ts`` (and ``dur``
    for complete events), and int ``pid``/``tid`` where present."""
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got {type(obj)}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace lacks a traceEvents list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i} has no name")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} has bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} has bad dur {dur!r}")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                raise ValueError(f"event {i} has non-int {key}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} has non-object args")


def export_chrome_trace(path: Union[str, pathlib.Path],
                        tracer: Optional[SpanTracer] = None
                        ) -> pathlib.Path:
    """Validate, then write the Perfetto-loadable trace JSON."""
    obj = chrome_trace(tracer)
    validate_chrome_trace(obj)
    path = pathlib.Path(path)
    path.write_text(json.dumps(obj, sort_keys=True) + "\n")
    return path


def export_jsonl(path: Union[str, pathlib.Path],
                 tracer: Optional[SpanTracer] = None) -> pathlib.Path:
    """One JSON event per line, buffer order."""
    tracer = tracer or get_tracer()
    path = pathlib.Path(path)
    with open(path, "w") as f:
        for ev in tracer.events():
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return path


def span_tree(events: List[Dict]) -> Dict[str, List[str]]:
    """``{span name: sorted unique child span names}`` over complete
    events — what the acceptance checks read ("the recovery span
    decomposes into >= 3 named child phases")."""
    children: Dict[str, set] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        parent = (ev.get("args") or {}).get("parent")
        if parent:
            children.setdefault(parent, set()).add(ev["name"])
    return {name: sorted(kids) for name, kids in children.items()}
