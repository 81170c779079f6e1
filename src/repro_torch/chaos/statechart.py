"""A minimal statechart substrate for workload and fault machines.

The chaos harness needs adversarial schedules that *evolve* — skew that
drifts, storms that migrate between shards, sessions that stall and
crash — and those are naturally statecharts: a machine is a named state,
a list of guarded transitions, an event queue, and a seeded PRNG.
Nothing here knows about KV ops or services;
:mod:`repro_torch.chaos.machines` builds the concrete client/fault
machines on top.

Determinism is the design constraint (the regression tests assert
byte-identical traces across runs): transitions fire in declaration
order, events process in FIFO order, and all randomness flows through
the machine's own ``numpy`` generator seeded at construction (numpy's,
not torch's: the port's traces are byte-identical to the reference's,
draw for draw).  Every
processed event — including ones no transition consumed — appends one
tuple to ``machine.trace``, so two runs of a scenario can be compared
event-for-event.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Event:
    """One queued occurrence: a name plus an immutable payload dict."""
    name: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:
        return self.payload[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.payload.get(key, default)


@dataclasses.dataclass(frozen=True)
class Transition:
    """``source --event[guard]/action--> target``.

    ``guard(machine, event) -> bool`` gates the transition (None = always
    enabled); ``action(machine, event)`` runs side effects on the machine
    when it fires.  ``source`` may be ``"*"`` to match any state."""
    source: str
    event: str
    target: str
    guard: Optional[Callable[["Machine", Event], bool]] = None
    action: Optional[Callable[["Machine", Event], None]] = None


class Machine:
    """One statechart instance: state + transitions + event queue + PRNG.

    Subclasses (or factories) supply the transition table; the driver
    posts events and calls :meth:`process` once per wave.  The first
    declared transition whose source/event/guard all match fires; an
    event no transition consumes is recorded as dropped (``target is
    None`` in the trace) — dropping is normal (e.g. a ``tick`` while
    awaiting a verdict), not an error.
    """

    def __init__(self, name: str, initial: str,
                 transitions: Sequence[Transition], seed: int):
        self.name = name
        self.state = initial
        self.transitions = list(transitions)
        self.rng = np.random.default_rng(seed)
        self.queue: deque = deque()
        # (state_before, event_name, state_after_or_None) per processed event
        self.trace: List[Tuple[str, str, Optional[str]]] = []

    def post(self, event: str, **payload: Any) -> None:
        self.queue.append(Event(event, payload))

    def _match(self, ev: Event) -> Optional[Transition]:
        for t in self.transitions:
            if t.event != ev.name:
                continue
            if t.source != "*" and t.source != self.state:
                continue
            if t.guard is not None and not t.guard(self, ev):
                continue
            return t
        return None

    def process(self) -> int:
        """Drain the event queue; returns the number of fired transitions."""
        fired = 0
        while self.queue:
            ev = self.queue.popleft()
            t = self._match(ev)
            if t is None:
                self.trace.append((self.state, ev.name, None))
                continue
            before = self.state
            if t.action is not None:
                t.action(self, ev)
            self.state = t.target
            self.trace.append((before, ev.name, self.state))
            fired += 1
        return fired

    def trace_lines(self) -> List[str]:
        """The trace in a canonical text form (for byte-level diffing)."""
        return [f"{self.name}:{b}--{e}-->{a if a is not None else '.'}"
                for b, e, a in self.trace]
