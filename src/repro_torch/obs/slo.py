"""SLO engine: declarative specs, sliding windows, multi-window burn.

The ROADMAP's async-serving and fast-recovery legs both need wall-clock
pass/fail gates before they can land safely; this module is the gate
machinery.  A :class:`SloSpec` declares one bound over one metric (a
p99-latency ceiling in µs, an ops/s floor, a persists/commit ceiling, a
``recover_us`` ceiling, a ``mig_pause_us_p99`` ceiling, …).  An
:class:`SloEngine` holds a set of specs and a sliding window of
observations — each observation is one plain ``{metric: value}`` dict,
typically a registry/stats snapshot taken once per service wave or once
per benchmark cell.

Verdicts use the standard multi-window burn-rate rule rather than a
naive "last sample violated" check: per spec and window, the burn rate
is ``violation_fraction / error_budget``, and the spec only FIRES
(``ok=False``) when BOTH the short window (is it happening *now*?) and
the long window (is it *substantial*?) burn at >= 1.  A single slow
wave inside the budget never fires; a sustained breach always does.  A
spec whose metric never appears in any observation is reported with
``evaluations == 0`` and ``ok=True`` — absence of evidence is surfaced,
not punished.

``report()`` emits the JSON shape of the reference's
``SLO_<section>.json`` files (the chaos driver attaches one to every
``ChaosReport``), and :func:`validate_slo_report` is its schema check.
The port's engine is the reference's, verdict for verdict
(``tests/test_torch_obs_slo_export.py``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

# burn with a zero error budget would be a division by zero (any
# violation is an infinite burn); cap it to keep the report JSON-safe
_BURN_CAP = 1e9

_KINDS = ("ceiling", "floor")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective: ``metric`` must stay under (``ceiling``)
    or over (``floor``) ``bound``, with ``error_budget`` — the fraction
    of observations allowed to violate before a window burns."""

    name: str
    metric: str
    bound: float
    kind: str = "ceiling"
    error_budget: float = 0.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"SloSpec kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.error_budget < 1.0:
            raise ValueError("error_budget must be in [0, 1)")

    def violated(self, value: float) -> bool:
        if self.kind == "ceiling":
            return value > self.bound
        return value < self.bound


def _burn(violations: int, evaluations: int, budget: float) -> float:
    if evaluations == 0:
        return 0.0
    frac = violations / evaluations
    if budget <= 0.0:
        return _BURN_CAP if frac > 0.0 else 0.0
    return min(frac / budget, _BURN_CAP)


class SloEngine:
    """Sliding-window evaluator for a set of :class:`SloSpec`."""

    def __init__(self, specs: Iterable[SloSpec], short_window: int = 8,
                 long_window: int = 64):
        self.specs: List[SloSpec] = list(specs)
        if short_window < 1 or long_window < short_window:
            raise ValueError("need 1 <= short_window <= long_window")
        self.short_window = short_window
        self.long_window = long_window
        self._obs: Deque[Dict[str, float]] = deque(maxlen=long_window)
        self.observations = 0           # lifetime, beyond the window

    def observe(self, metrics: Dict[str, float]) -> None:
        """Record one observation point (missing metrics are fine — a
        spec simply does not evaluate against this point)."""
        self._obs.append({k: float(v) for k, v in metrics.items()})
        self.observations += 1

    def _evaluate_spec(self, spec: SloSpec) -> Dict:
        values = [o[spec.metric] for o in self._obs if spec.metric in o]
        flags = [spec.violated(v) for v in values]
        short_flags = flags[-self.short_window:]
        result = {
            "name": spec.name, "metric": spec.metric, "kind": spec.kind,
            "bound": spec.bound, "error_budget": spec.error_budget,
            "description": spec.description,
            "evaluations": len(values), "violations": sum(flags),
            "burn_short": round(_burn(sum(short_flags), len(short_flags),
                                      spec.error_budget), 6),
            "burn_long": round(_burn(sum(flags), len(flags),
                                     spec.error_budget), 6),
        }
        if values:
            result["last"] = values[-1]
            result["worst"] = (max(values) if spec.kind == "ceiling"
                               else min(values))
        # fires only when both windows burn — see module docstring
        result["ok"] = not (result["burn_short"] >= 1.0
                            and result["burn_long"] >= 1.0)
        return result

    def evaluate(self) -> List[Dict]:
        return [self._evaluate_spec(s) for s in self.specs]

    def report(self, section: Optional[str] = None, **extra) -> Dict:
        """The ``SLO_<section>.json`` document (schema:
        :func:`validate_slo_report`)."""
        specs = self.evaluate()
        doc = {
            "specs": specs,
            "ok": all(s["ok"] for s in specs),
            "observations": self.observations,
            "windows": {"short": self.short_window,
                        "long": self.long_window},
        }
        if section is not None:
            doc["section"] = section
        doc.update(extra)
        return doc


def validate_slo_report(doc: Dict) -> Dict:
    """Raise ``ValueError`` unless ``doc`` is a well-formed SLO report;
    returns the doc for chaining.  This is the contract every emitted
    ``SLO_<section>.json`` and every chaos report's SLO block meets."""
    if not isinstance(doc, dict):
        raise ValueError("SLO report must be an object")
    for key, typ in (("specs", list), ("ok", bool), ("observations", int),
                     ("windows", dict)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"SLO report field {key!r} must be {typ.__name__}")
    for key in ("short", "long"):
        if not isinstance(doc["windows"].get(key), int):
            raise ValueError(f"windows.{key} must be an int")
    for i, spec in enumerate(doc["specs"]):
        if not isinstance(spec, dict):
            raise ValueError(f"specs[{i}] must be an object")
        for key, typ in (("name", str), ("metric", str), ("kind", str),
                         ("evaluations", int), ("violations", int),
                         ("ok", bool)):
            if not isinstance(spec.get(key), typ):
                raise ValueError(
                    f"specs[{i}].{key} must be {typ.__name__}")
        if spec["kind"] not in _KINDS:
            raise ValueError(f"specs[{i}].kind must be one of {_KINDS}")
        for key in ("bound", "burn_short", "burn_long"):
            if not isinstance(spec.get(key), (int, float)) or \
                    isinstance(spec.get(key), bool):
                raise ValueError(f"specs[{i}].{key} must be a number")
        if spec["evaluations"] < 0 or spec["violations"] < 0 or \
                spec["violations"] > spec["evaluations"]:
            raise ValueError(
                f"specs[{i}]: need 0 <= violations <= evaluations")
    return doc
