"""Flush provenance: every persist fence carries a ``(component, reason)``.

The paper's thesis is that the original PMwCAS spends fences it does not
need — and PR 7's dual ledger can only *count* fences, not explain them.
This module is the explanation channel: callers wrap the code that is
ABOUT to hit the persist seam in :func:`flush_reason`, and
``PMemPool.persist`` calls :func:`record_fence` so the registry grows two
labeled counter families:

- ``flush_fences{component, reason}`` — every fence, attributed;
- ``redundant_fences{component, reason}`` — fences that covered an
  already-clean line (nothing unpersisted under them).  On the
  group-commit hot path this must be ZERO — ``benchmarks/bench_durable``
  asserts it, which turns the paper's removed-flushes claim into a CI
  gate.  The per-op protocol keeps the original algorithm's conservative
  read barrier, so its count is honestly nonzero.

Attribution is a thread-local stack of frames.  Frames NEST, and the
label is split across the stack on purpose:

- ``component`` comes from the OUTERMOST frame — who initiated the work
  (``"service"`` for a migration swing, ``"structures"`` for a directory
  doubling, ``"committer"`` for a plain commit);
- ``reason`` comes from the INNERMOST frame — the mechanical reason this
  particular line was fenced (``"descriptor"``, ``"group_record"``,
  ``"wal_prune"``, ``"read_barrier"``, ``"migration_routed"``,
  ``"epoch_close"`` — the ONE fence an epoch of buffered rounds shares,
  ``"checkpoint"`` — a WAL checkpoint image plus the covered-record
  GC it durably supersedes, …).

So a descriptor persisted inside a directory-doubling swing shows up as
``{component="structures", reason="descriptor"}`` — both the business
cause and the mechanical one survive, without exploding cardinality.

A fence issued with no frame on the stack records as
``{component="pmem", reason="unattributed"}`` — visible, not silent, so
an uninstrumented call site shows up in the ledger as a taxonomy gap.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Tuple

from .metrics import get_registry

DEFAULT_REASON: Tuple[str, str] = ("pmem", "unattributed")

_STATE = threading.local()


def _frames() -> list:
    frames = getattr(_STATE, "frames", None)
    if frames is None:
        frames = _STATE.frames = []
    return frames


@contextmanager
def flush_reason(component: str, reason: str) -> Iterator[None]:
    """Attribute every fence issued inside the ``with`` to
    ``(component, reason)``.  Nests: see the module docstring for how
    outer (business) and inner (mechanical) frames combine."""
    frames = _frames()
    frames.append((str(component), str(reason)))
    try:
        yield
    finally:
        frames.pop()


def current_flush_reason() -> Tuple[str, str]:
    """The label the NEXT fence on this thread would record."""
    frames = _frames()
    if not frames:
        return DEFAULT_REASON
    return frames[0][0], frames[-1][1]


def record_fence(redundant: bool = False) -> None:
    """Called by the persist seam (``PMemPool``) for every fence issued.
    ``redundant=True`` means the fence covered an already-clean line —
    durably a no-op, exactly the instruction class the paper removes."""
    component, reason = current_flush_reason()
    reg = get_registry()
    reg.counter("flush_fences", component=component, reason=reason).inc()
    if redundant:
        reg.counter("redundant_fences",
                    component=component, reason=reason).inc()
