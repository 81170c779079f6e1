"""Completed-operation history recording + linearizability checking.

The recorder logs one flat, json-able event stream per scenario run:

- ``("base", items)`` — the state after the load phase (checked inserts)
- ``("invoke", wave, client, seq, kind, key, value)`` — op submitted
- ``("complete", wave, seq, status, value)`` — verdict observed
- ``("crash", wave)`` — the wave's execution died in ``SimulatedCrash``
- ``("adopt", wave, items)`` — recovered state re-adopted as the model
- ``("final", items)`` — the drained service's live items

Why checking is cheap (DESIGN.md Sec. 10): the service executes in
synchronous waves, and a wave gives the commit order away — reads,
scans and other immediate verdicts are compiled against the wave-start
snapshot *before* any CAS executes, every committed mutation completes
in the wave its round won, and the conflict-defer rule admits at most
one committed mutation per key per wave.  So the sequential oracle is a
dict replayed wave by wave: check the wave's immediate verdicts against
the model, then apply its committed mutations (each with its
precondition) — per-key order verification, no interleaving search.

Crashes make verdicts indeterminate, not wrong: ops invoked but never
completed may or may not have committed.  On ``adopt`` the checker
accepts any recovered per-key value reachable from the model through
some subset/order of the in-flight mutations for that key (a fixpoint
closure — a deliberate over-approximation across keys, since round
atomicity only ties keys together in ways that shrink the real set),
then *adopts* the recovered state and keeps checking — the in-place
recovery continuation the chaos driver performs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

DELETE, INSERT, READ, SCAN, UPDATE = ("delete", "insert", "read", "scan",
                                      "update")
OK, EXISTS, NOT_FOUND = "ok", "exists", "not_found"
MUTATIONS = (INSERT, UPDATE, DELETE)


class LinearizabilityError(AssertionError):
    """A completed verdict no sequential execution can explain."""


def _items_list(items: Dict[int, int]) -> List[List[int]]:
    return [[int(k), int(v)] for k, v in sorted(items.items())]


class HistoryRecorder:
    """Append-only event log for one scenario run (see module docstring)."""

    def __init__(self):
        self.events: List[Tuple] = []

    def base(self, items: Dict[int, int]) -> None:
        self.events.append(("base", _items_list(items)))

    def invoke(self, wave: int, client: str, seq: int, kind: str,
               key: int, value: int) -> None:
        self.events.append(("invoke", wave, client, seq, kind, key, value))

    def complete(self, wave: int, seq: int, status: str,
                 value: Optional[int]) -> None:
        self.events.append(("complete", wave, seq, status, value))

    def crash(self, wave: int) -> None:
        self.events.append(("crash", wave))

    def adopt(self, wave: int, items: Dict[int, int]) -> None:
        self.events.append(("adopt", wave, _items_list(items)))

    def final(self, items: Dict[int, int]) -> None:
        self.events.append(("final", _items_list(items)))

    def canonical_lines(self) -> List[str]:
        """One canonical text line per event (byte-comparable across
        runs — the determinism regression diffs these)."""
        return [json.dumps(list(ev), separators=(",", ":"))
                for ev in self.events]


@dataclasses.dataclass
class CheckStats:
    """What one checker pass covered."""
    immediates: int = 0          # read/scan/exists/not-found verdicts checked
    mutations: int = 0           # committed mutations applied with precondition
    unchecked: int = 0           # FULL / EXHAUSTED verdicts (capacity-defined)
    crashes: int = 0
    indeterminate: int = 0       # in-flight ops dropped by a crash
    ok: bool = True


def _reachable(base: Optional[int], muts: Sequence[Tuple[str, int]]):
    """Per-key closure: every value reachable from ``base`` through some
    subset/order of the in-flight mutations (None = key absent)."""
    seen = {base}
    frontier = [base]
    while frontier:
        v = frontier.pop()
        for kind, val in muts:
            if kind == INSERT and v is None:
                nxt = val
            elif kind == UPDATE and v is not None:
                nxt = val
            elif kind == DELETE and v is not None:
                nxt = None
            else:
                continue
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


def check_history(events: Sequence[Tuple]) -> CheckStats:
    """Validate one recorded history against the sequential oracle.

    Raises :class:`LinearizabilityError` on the first verdict (or
    recovered state) no sequential per-key execution can explain;
    returns coverage stats otherwise."""
    stats = CheckStats()
    model: Dict[int, int] = {}
    pending: Dict[int, Tuple[str, str, int, int]] = {}   # seq -> invocation
    buffered: List[Tuple] = []                           # one wave's completes
    buf_wave: Optional[int] = None

    def fail(msg: str) -> None:
        stats.ok = False
        raise LinearizabilityError(msg)

    def check_immediate(wave, seq, kind, key, value, status, val) -> None:
        if status in ("full", "exhausted"):
            stats.unchecked += 1
            return
        stats.immediates += 1
        if kind == READ:
            if status == OK and model.get(key) != val:
                fail(f"wave {wave} seq {seq}: read({key}) returned {val}, "
                     f"model holds {model.get(key)}")
            if status == NOT_FOUND and key in model:
                fail(f"wave {wave} seq {seq}: read({key}) missed but model "
                     f"holds {model[key]}")
        elif kind == SCAN:
            want = sum(1 for k in model if k >= key)
            if status != OK or val != want:
                fail(f"wave {wave} seq {seq}: scan(>={key}) counted {val}, "
                     f"model counts {want}")
        elif kind == INSERT and status == EXISTS:
            if model.get(key) != val:
                fail(f"wave {wave} seq {seq}: insert({key}) saw EXISTS with "
                     f"{val}, model holds {model.get(key)}")
        elif kind in (UPDATE, DELETE) and status == NOT_FOUND:
            if key in model:
                fail(f"wave {wave} seq {seq}: {kind}({key}) missed but "
                     f"model holds {model[key]}")
        else:
            fail(f"wave {wave} seq {seq}: inexplicable verdict "
                 f"{kind}/{status}")

    def flush() -> None:
        nonlocal buffered, buf_wave
        if not buffered:
            return
        wave = buf_wave
        immediates, mutations = [], []
        for (_, w, seq, status, val) in buffered:
            if seq not in pending:
                fail(f"wave {w} seq {seq}: completion without invocation")
            inv = pending.pop(seq)
            _client, kind, key, value = inv
            if kind in MUTATIONS and status == OK:
                mutations.append((w, seq, kind, key, value))
            else:
                immediates.append((w, seq, kind, key, value, status, val))
        # immediate verdicts saw the wave-start snapshot: check first
        for im in immediates:
            check_immediate(*im)
        # then the wave's committed mutations (conflict-defer admits at
        # most one per key per wave, so intra-wave order is irrelevant)
        touched = set()
        for (w, seq, kind, key, value) in mutations:
            if key in touched:
                fail(f"wave {w}: two mutations committed on key {key} "
                     "in one wave (conflict-defer violated)")
            touched.add(key)
            stats.mutations += 1
            if kind == INSERT:
                if key in model:
                    fail(f"wave {w} seq {seq}: insert({key}) committed "
                         f"over live value {model[key]}")
                model[key] = value
            elif kind == UPDATE:
                if key not in model:
                    fail(f"wave {w} seq {seq}: update({key}) committed "
                         "on an absent key")
                model[key] = value
            else:
                if key not in model:
                    fail(f"wave {w} seq {seq}: delete({key}) committed "
                         "on an absent key")
                del model[key]
        buffered, buf_wave = [], None

    for ev in events:
        tag = ev[0]
        if tag == "base":
            model = {k: v for k, v in ev[1]}
        elif tag == "invoke":
            flush()
            _, wave, client, seq, kind, key, value = ev
            pending[seq] = (client, kind, key, value)
        elif tag == "complete":
            if buf_wave is not None and ev[1] != buf_wave:
                flush()
            buf_wave = ev[1]
            buffered.append(ev)
        elif tag == "crash":
            flush()
            stats.crashes += 1
        elif tag == "adopt":
            flush()
            _, wave, items = ev
            adopted = {k: v for k, v in items}
            per_key: Dict[int, List[Tuple[str, int]]] = {}
            for (_client, kind, key, value) in pending.values():
                if kind in MUTATIONS:
                    per_key.setdefault(key, []).append((kind, value))
            for key in set(model) | set(adopted) | set(per_key):
                okvals = _reachable(model.get(key), per_key.get(key, []))
                if adopted.get(key) not in okvals:
                    fail(f"wave {wave}: recovered value {adopted.get(key)} "
                         f"for key {key} unreachable from {model.get(key)} "
                         f"under in-flight ops {per_key.get(key, [])}")
            stats.indeterminate += len(pending)
            pending.clear()          # in-flight verdicts died with the crash
            model = adopted
        elif tag == "final":
            flush()
            if pending:
                fail(f"history ended with {len(pending)} ops never "
                     "completed (and no crash to explain them)")
            final = {k: v for k, v in ev[1]}
            if final != model:
                fail(f"final items {final} != model {model}")
        else:
            fail(f"unknown history event {tag!r}")
    flush()
    return stats
