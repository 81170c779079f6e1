"""Fixed-capacity open-addressing hash map on the unified PMwCAS API.

The paper's closing claim is that a fast PMwCAS unlocks lock-free
persistent data structures; this is the first one in the repo.  Every
mutation compiles to exactly ONE 2-word :class:`repro_torch.pmwcas.MwCASOp`
over the bucket's pair of words, so the structure runs unchanged on any
:class:`repro_torch.pmwcas.Backend` (in this package: the hand-written
CUDA kernel backend, or its plain PyTorch version on the CPU):

======== =========================================== =====================
op       MwCAS targets                               crash invariant
======== =========================================== =====================
insert   (key word: EMPTY/TOMB -> key,               key never visible
          value word: 0 -> value)                    without its value
update   (key word: key -> key  [guard],             value moves only
          value word: old -> new)                    while key unchanged
delete   (key word: key -> TOMBSTONE,                chain stays probe-
          value word: old -> 0)                      able; pair atomic
======== =========================================== =====================

Bucket ``b`` owns words ``base + 2b`` (key) and ``base + 2b + 1``
(value) — addresses are adjacent and ascending, i.e. already in the
paper's canonical sorted embedding order.

**Directory doubling** (opt-in via ``max_doublings > 0``) makes the
capacity elastic with the same decide -> materialize -> swing protocol
the tree uses for its root split (DESIGN.md Sec. 12):

- a 2-word header precedes the arrays: word ``base`` is the
  *generation word* ``g | MIG_BIT`` (MIG_BIT set while a doubling is
  in flight), word ``base + 1`` is reserved (always 0);
- generation ``g``'s array lives at ``base + 2 + 2*n0*(2^g - 1)`` with
  ``n0 * 2^g`` buckets — every generation has a fixed home, so no
  address is ever reused across generations;
- **decide**: a full insert verdict becomes :class:`NeedsResize`;
  ``begin_resize`` publishes the decision with ONE 1-word CAS
  ``g -> g | MIG_BIT`` (the persisted decision record);
- **materialize**: ``resize_step`` pumps live keys old -> new with
  4-word *move* ops (old pair dies, new pair is born, atomically; no
  generation guard — moves are pairwise disjoint) while client ops
  proceed against the split-brain table under a generation-word guard
  ``(gen, G, G)``: insert goes to the new array (3 words), update of a
  not-yet-moved key is *move-on-write* (5 words), delete hits
  whichever array holds the key (3 words).  A finalize racing any
  guarded op changes the generation word, so the guard converts the
  race into a normal CAS retry — never a lost update;
- **swing**: once the old array holds no live key, ONE 1-word CAS
  ``g | MIG_BIT -> g + 1`` retires the old generation.

A crash at any persist lands in one of three self-describing states —
MIG unset (pre-growth), MIG set (the split-brain table, valid for
reads/writes indefinitely; any later op resumes the pump), or the next
generation (post-growth) — which is exactly what
the reference package's ``check_hashmap_resize_sweep`` sweeps.

Execution is round-based (the batched analogue of the lock-free retry
loop): every logical op is compiled against one snapshot of the table,
the whole round executes as one backend batch under the deterministic
one-shot semantics, and losers are recompiled against the next snapshot.
All compiled ops carry pre-batch expected values, so condition (a) of
the batch semantics always passes and the lowest-index op of every
conflict component wins — each round commits at least one op and the
retry loop terminates in at most ``len(ops)`` rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.pmwcas import Backend, MwCASOp

EMPTY = 0
TOMBSTONE = (1 << 32) - 1          # uint32 max; keys/values must stay below

MIG_BIT = 1 << 30                  # generation word: doubling in flight
GEN_MASK = MIG_BIT - 1

# logical operation kinds
READ, INSERT, UPDATE, DELETE, SCAN = ("read", "insert", "update", "delete",
                                      "scan")
_KINDS = (READ, INSERT, UPDATE, DELETE, SCAN)

# result statuses
OK = "ok"                  # committed (mutations) / answered (reads)
EXISTS = "exists"          # insert found the key already live
NOT_FOUND = "not_found"    # update/delete/read missed
FULL = "full"              # insert found no writable bucket
EXHAUSTED = "exhausted"    # still losing conflicts after max_rounds


class TornStructure(AssertionError):
    """A bucket pair violates the crash invariant — must never happen."""


@dataclasses.dataclass(frozen=True)
class NeedsResize:
    """Insert verdict: generation ``gen`` is full and a doubling is both
    allowed (``gen < max_doublings``) and required to make room.
    :meth:`HashMap.apply` answers it by publishing the resize decision
    (``begin_resize``) and retrying the op against the split-brain
    table; standalone compilers hand it to :meth:`HashMap.ensure_room`.
    """
    gen: int


@dataclasses.dataclass(frozen=True)
class KVOp:
    """One logical hash-map operation (the workload vocabulary)."""
    kind: str
    key: int
    value: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")
        if not 0 < self.key < TOMBSTONE:
            raise ValueError(f"key {self.key} outside (0, 2^32-1)")
        if self.kind in (INSERT, UPDATE) and not 0 < self.value < TOMBSTONE:
            raise ValueError(f"{self.kind} needs a value in (0, 2^32-1)")


@dataclasses.dataclass
class StructResult:
    """Per-logical-op outcome of :meth:`HashMap.apply`."""
    op: KVOp
    status: str
    value: Optional[int] = None    # reads: the value found (None on miss)
    rounds: int = 0                # CAS rounds this op participated in

    def __bool__(self) -> bool:
        return self.status == OK


@dataclasses.dataclass
class RoundTrace:
    """One executed round: the compiled batch and its verdicts.

    Recorded by :meth:`HashMap.apply` so the structure differential can
    replay every round through a shadow simulator batch.
    """
    ops: List[MwCASOp]
    owners: List[int]              # batch position -> logical op index
    success: np.ndarray            # bool[B]


class HashMap:
    """Open-addressing (linear probing, tombstone) map over a Backend.

    The map holds no authoritative state of its own: keys and values
    live in the backend's word table, read back via ``backend.read`` —
    which is what makes a crash/recover cycle on the durable backend
    transparent (attach a fresh ``HashMap`` to the recovered backend).
    """

    def __init__(self, backend: Backend, n_buckets: int, base: int = 0, *,
                 max_doublings: int = 0):
        if n_buckets < 1:
            raise ValueError("need at least one bucket")
        if max_doublings < 0:
            raise ValueError("max_doublings must be >= 0")
        self.backend = backend
        self.n_buckets = n_buckets           # generation-0 bucket count
        self.base = base
        self.max_doublings = max_doublings
        self.hdr = 2 if max_doublings else 0  # generation word + reserved
        self.last_history: List[RoundTrace] = []
        # cumulative instrumentation across apply() calls
        self.rounds_run = 0
        self.mwcas_submitted = 0
        self.mwcas_won = 0
        self.resizes = 0                     # doublings finalized
        self.keys_migrated = 0               # pump moves committed

    # -- layout ----------------------------------------------------------------
    @property
    def gen_addr(self) -> int:
        return self.base

    def gen_state(self, snap: Optional[np.ndarray] = None
                  ) -> Tuple[int, bool]:
        """(current generation, doubling in flight?)."""
        if not self.hdr:
            return 0, False
        w = (int(self.backend.read(self.gen_addr)) if snap is None
             else int(snap[0]))
        return w & GEN_MASK, bool(w & MIG_BIT)

    @property
    def gen(self) -> int:
        return self.gen_state()[0]

    @property
    def migrating(self) -> bool:
        return self.gen_state()[1]

    def cap(self, g: int = 0) -> int:
        return self.n_buckets << g

    def arr_off(self, g: int = 0) -> int:
        """Generation ``g``'s array offset within the map's region."""
        return self.hdr + 2 * self.n_buckets * ((1 << g) - 1)

    def key_addr(self, bucket: int, g: int = 0) -> int:
        return self.base + self.arr_off(g) + 2 * bucket

    def value_addr(self, bucket: int, g: int = 0) -> int:
        return self.key_addr(bucket, g) + 1

    @property
    def n_words(self) -> int:
        return self.words_needed(self.n_buckets, self.max_doublings)

    @staticmethod
    def words_needed(n_buckets: int, max_doublings: int = 0,
                     base: int = 0) -> int:
        """Word footprint: every generation has a fixed, disjoint home."""
        if max_doublings == 0:
            return base + 2 * n_buckets
        return base + 2 + 2 * n_buckets * ((1 << (max_doublings + 1)) - 1)

    def _home(self, key: int, g: int = 0) -> int:
        return (key * 2654435761) % self.cap(g)    # Knuth multiplicative

    # -- reads -----------------------------------------------------------------
    def snapshot(self) -> np.ndarray:
        """One consistent-enough read of the whole region (int64[2N]).

        Array-shaped backends expose the full word table in one call;
        the durable backend resolves slots one at a time.
        """
        values = getattr(self.backend, "values", None)
        if callable(values):
            table = np.asarray(values(), np.int64)
            return table[self.base:self.base + self.n_words]
        return np.asarray([self.backend.read(self.base + i)
                           for i in range(self.n_words)], np.int64)

    def _locate(self, key: int, snap: np.ndarray, g: int = 0,
                claimed: Optional[set] = None
                ) -> Tuple[Optional[int], Optional[int]]:
        """(bucket holding key or None, first writable bucket or None)
        within generation ``g``'s array.  ``claimed`` buckets (reserved
        by another move compiled against the same snapshot) probe as
        occupied — the chain stays walkable once the claims commit."""
        off, cap = self.arr_off(g), self.cap(g)
        writable = None
        b = self._home(key, g)
        for _ in range(cap):
            if claimed is not None and b in claimed:
                b = (b + 1) % cap
                continue
            kw = int(snap[off + 2 * b])
            if kw == key:
                return b, writable
            if kw == TOMBSTONE:
                if writable is None:
                    writable = b
            elif kw == EMPTY:
                return None, b if writable is None else writable
            b = (b + 1) % cap
        return None, writable

    def lookup(self, key: int,
               snap: Optional[np.ndarray] = None) -> Optional[int]:
        snap = self.snapshot() if snap is None else snap
        g, mig = self.gen_state(snap)
        for gi in ((g + 1, g) if mig else (g,)):
            b, _ = self._locate(key, snap, gi)
            if b is not None:
                return int(snap[self.arr_off(gi) + 2 * b + 1])
        return None

    def _gen_items(self, snap: np.ndarray, g: int) -> Dict[int, int]:
        off = self.arr_off(g)
        out = {}
        for b in range(self.cap(g)):
            kw = int(snap[off + 2 * b])
            if kw not in (EMPTY, TOMBSTONE):
                out[kw] = int(snap[off + 2 * b + 1])
        return out

    def items(self, snap: Optional[np.ndarray] = None) -> Dict[int, int]:
        """All live (key, value) pairs (union of both generations while
        a doubling is in flight — a key is live in exactly one)."""
        snap = self.snapshot() if snap is None else snap
        g, mig = self.gen_state(snap)
        out = self._gen_items(snap, g)
        if mig:
            out.update(self._gen_items(snap, g + 1))
        return out

    def check_integrity(self, snap: Optional[np.ndarray] = None
                        ) -> Dict[int, int]:
        """Assert no bucket pair is torn; return the live items.

        Invariant (each mutation moves both words in ONE MwCAS):
        key EMPTY or TOMBSTONE  <=>  value == 0 — in every generation.
        Additionally for elastic maps: retired generations are drained,
        no key is live in two generations at once, future generations
        are untouched (all-zero), and the generation word is in range.
        """
        snap = self.snapshot() if snap is None else snap
        g, mig = self.gen_state(snap)
        if self.hdr:
            if g > self.max_doublings or (mig and g >= self.max_doublings):
                raise TornStructure(
                    f"generation word {g}{'|MIG' if mig else ''} out of "
                    f"range (max_doublings={self.max_doublings})")
            if int(snap[1]) != 0:
                raise TornStructure(
                    f"reserved header word is {int(snap[1])}, not 0")

        def check_pairs(gi: int, drained: bool) -> None:
            off = self.arr_off(gi)
            for b in range(self.cap(gi)):
                kw, vw = int(snap[off + 2 * b]), int(snap[off + 2 * b + 1])
                if kw in (EMPTY, TOMBSTONE):
                    if vw != 0:
                        raise TornStructure(f"gen {gi} bucket {b}: key "
                                            f"word {kw} but value {vw} != 0")
                elif vw == 0:
                    raise TornStructure(f"gen {gi} bucket {b}: live key "
                                        f"{kw} with value 0 (torn insert)")
                elif drained:
                    raise TornStructure(f"gen {gi} bucket {b}: key {kw} "
                                        "still live in a retired generation")

        for gi in range(g):
            check_pairs(gi, drained=True)
        check_pairs(g, drained=False)
        if mig:
            check_pairs(g + 1, drained=False)
            both = set(self._gen_items(snap, g)) & set(
                self._gen_items(snap, g + 1))
            if both:
                raise TornStructure(
                    f"keys live in two generations at once: {sorted(both)}")
        future = self.arr_off(g + 2 if mig else g + 1)
        if future < self.n_words and np.asarray(snap[future:]).any():
            raise TornStructure("future generation array is not all-zero")
        return self.items(snap)

    # -- operation compilation -------------------------------------------------
    def compile_op(self, op: KVOp, snap: np.ndarray
                   ) -> Union[MwCASOp, StructResult, NeedsResize]:
        """One logical op -> one MwCASOp (or an immediate verdict).

        Expected values come from ``snap``; executing the compiled op in
        the same round as its snapshot guarantees condition (a) passes.
        Steady state compiles the classic 2-word shapes; while a
        doubling is in flight every mutation carries the generation-word
        guard and may span both generations (3/5-word shapes).
        """
        g, mig = self.gen_state(snap)
        if mig:
            return self._compile_migrating(op, snap, g)
        found, writable = self._locate(op.key, snap, g)
        off = self.arr_off(g)
        if op.kind == READ:
            val = None if found is None else int(snap[off + 2 * found + 1])
            return StructResult(op, OK if found is not None else NOT_FOUND,
                                value=val)
        if op.kind == SCAN:
            items = self.items(snap)
            return StructResult(op, OK, value=len(
                [k for k in items if k >= op.key]))
        if op.kind == INSERT:
            if found is not None:
                return StructResult(op, EXISTS,
                                    value=int(snap[off + 2 * found + 1]))
            if writable is None:
                if g < self.max_doublings:
                    return NeedsResize(g)
                return StructResult(op, FULL)
            kw_cur = int(snap[off + 2 * writable])   # EMPTY or TOMBSTONE
            return MwCASOp([(self.key_addr(writable, g), kw_cur, op.key),
                            (self.value_addr(writable, g), 0, op.value)])
        if found is None:                            # UPDATE / DELETE miss
            return StructResult(op, NOT_FOUND)
        v_cur = int(snap[off + 2 * found + 1])
        if op.kind == UPDATE:
            # key word is a guard (expected == desired): it pins the key
            # in place and claims the bucket against concurrent deletes
            return MwCASOp([(self.key_addr(found, g), op.key, op.key),
                            (self.value_addr(found, g), v_cur, op.value)])
        return MwCASOp([(self.key_addr(found, g), op.key, TOMBSTONE),
                        (self.value_addr(found, g), v_cur, 0)])

    def _compile_migrating(self, op: KVOp, snap: np.ndarray, g: int
                           ) -> Union[MwCASOp, StructResult]:
        """Compile against the split-brain table (doubling g -> g+1).

        Every mutation is guarded by ``(gen_addr, G, G)`` where
        ``G = g | MIG_BIT``: if the doubling finalizes (or the snapshot
        was stale) the guard fails and the op retries — a generation
        conflict is a normal CAS retry, never a lost update.  Target
        lists are naturally address-sorted: guard < old array < new.
        """
        G = g | MIG_BIT
        guard = (self.gen_addr, G, G)
        fo, _ = self._locate(op.key, snap, g)        # old generation
        fn, wn = self._locate(op.key, snap, g + 1)   # new generation
        off_o, off_n = self.arr_off(g), self.arr_off(g + 1)
        if op.kind == READ:
            if fn is not None:
                return StructResult(op, OK, value=int(snap[off_n + 2*fn + 1]))
            if fo is not None:
                return StructResult(op, OK, value=int(snap[off_o + 2*fo + 1]))
            return StructResult(op, NOT_FOUND)
        if op.kind == SCAN:
            items = self.items(snap)
            return StructResult(op, OK, value=len(
                [k for k in items if k >= op.key]))
        if op.kind == INSERT:
            if fn is not None:
                return StructResult(op, EXISTS,
                                    value=int(snap[off_n + 2 * fn + 1]))
            if fo is not None:
                return StructResult(op, EXISTS,
                                    value=int(snap[off_o + 2 * fo + 1]))
            if wn is None:
                return StructResult(op, FULL)
            kw_cur = int(snap[off_n + 2 * wn])
            return MwCASOp([guard,
                            (self.key_addr(wn, g + 1), kw_cur, op.key),
                            (self.value_addr(wn, g + 1), 0, op.value)])
        if fn is None and fo is None:                # UPDATE / DELETE miss
            return StructResult(op, NOT_FOUND)
        if op.kind == UPDATE:
            if fn is not None:
                v_cur = int(snap[off_n + 2 * fn + 1])
                return MwCASOp([guard,
                                (self.key_addr(fn, g + 1), op.key, op.key),
                                (self.value_addr(fn, g + 1), v_cur,
                                 op.value)])
            v_cur = int(snap[off_o + 2 * fo + 1])
            if wn is not None:
                # move-on-write: retire the old pair and write the fresh
                # value into the new generation in ONE 5-word op
                kw_cur = int(snap[off_n + 2 * wn])
                return MwCASOp([guard,
                                (self.key_addr(fo, g), op.key, TOMBSTONE),
                                (self.value_addr(fo, g), v_cur, 0),
                                (self.key_addr(wn, g + 1), kw_cur, op.key),
                                (self.value_addr(wn, g + 1), 0, op.value)])
            return MwCASOp([guard,                   # new array full:
                            (self.key_addr(fo, g), op.key, op.key),
                            (self.value_addr(fo, g), v_cur, op.value)])
        if fn is not None:                           # DELETE
            v_cur = int(snap[off_n + 2 * fn + 1])
            return MwCASOp([guard,
                            (self.key_addr(fn, g + 1), op.key, TOMBSTONE),
                            (self.value_addr(fn, g + 1), v_cur, 0)])
        v_cur = int(snap[off_o + 2 * fo + 1])
        return MwCASOp([guard,
                        (self.key_addr(fo, g), op.key, TOMBSTONE),
                        (self.value_addr(fo, g), v_cur, 0)])

    # -- directory doubling ----------------------------------------------------
    def _record_round(self, batch: List[MwCASOp], owners: List[int],
                      success: np.ndarray) -> None:
        self.last_history.append(
            RoundTrace(ops=batch, owners=owners, success=success))
        self.rounds_run += 1
        self.mwcas_submitted += len(batch)
        self.mwcas_won += int(success.sum())

    def begin_resize(self, max_attempts: int = 8) -> bool:
        """Publish the doubling decision: ONE 1-word CAS sets MIG_BIT.

        Idempotent (already migrating -> True); False when the map is
        not elastic or the generation budget is spent.
        """
        if not self.hdr:
            return False
        for _ in range(max_attempts):
            g, mig = self.gen_state()
            if mig:
                return True
            if g >= self.max_doublings:
                return False
            op = MwCASOp([(self.gen_addr, g, g | MIG_BIT)])
            (res,) = self.backend.execute([op])
            self._record_round([op], [], np.asarray([res.success]))
            if res.success:
                return True
        return False

    def resize_step(self, max_moves: Optional[int] = None) -> int:
        """Pump up to ``max_moves`` live keys old -> new generation.

        Every move is ONE 4-word op (old pair dies, new pair is born);
        moves in a round are pairwise disjoint — no generation guard
        needed, they all commit.  Finalizes (1-word CAS ``G -> g+1``)
        once the old array holds no live key.  Returns keys moved.
        """
        g, mig = self.gen_state()
        if not mig:
            return 0
        snap = self.snapshot()
        off_o = self.arr_off(g)
        claimed: set = set()
        batch: List[MwCASOp] = []
        for b in range(self.cap(g)):
            if max_moves is not None and len(batch) >= max_moves:
                break
            kw = int(snap[off_o + 2 * b])
            if kw in (EMPTY, TOMBSTONE):
                continue
            vw = int(snap[off_o + 2 * b + 1])
            fn, wn = self._locate(kw, snap, g + 1, claimed=claimed)
            if fn is not None or wn is None:
                continue       # already moved under our feet / new full
            claimed.add(wn)
            kw_cur = int(snap[self.arr_off(g + 1) + 2 * wn])
            batch.append(MwCASOp([(self.key_addr(b, g), kw, TOMBSTONE),
                                  (self.value_addr(b, g), vw, 0),
                                  (self.key_addr(wn, g + 1), kw_cur, kw),
                                  (self.value_addr(wn, g + 1), 0, vw)]))
        moved = 0
        if batch:
            verdicts = self.backend.execute(batch)
            success = np.asarray([r.success for r in verdicts])
            self._record_round(batch, [], success)
            moved = int(success.sum())
            self.keys_migrated += moved
        # swing: retire the old generation once it is drained
        if not self._gen_items(self.snapshot(), g):
            G = g | MIG_BIT
            op = MwCASOp([(self.gen_addr, G, g + 1)])
            (res,) = self.backend.execute([op])
            self._record_round([op], [], np.asarray([res.success]))
            if res.success:
                self.resizes += 1
        return moved

    def ensure_room(self, max_steps: int = 8) -> bool:
        """Synchronously drive one full doubling to completion (the
        incremental path is :meth:`apply`'s per-round pump)."""
        if not self.begin_resize():
            return False
        for _ in range(max_steps):
            if not self.migrating:
                return True
            self.resize_step()
        return not self.migrating

    # -- round-based execution -------------------------------------------------
    def apply(self, ops: Sequence[KVOp],
              max_rounds: Optional[int] = None) -> List[StructResult]:
        """Execute one batch of logical ops; losers retry next round.

        Elastic maps interleave growth with the client rounds: an
        in-flight doubling pumps a chunk of moves before each round, and
        a :class:`NeedsResize` verdict publishes the decision and
        retries the op against the doubled table.
        """
        max_rounds = len(ops) + 1 if max_rounds is None else max_rounds
        results: List[Optional[StructResult]] = [None] * len(ops)
        pending = list(range(len(ops)))
        self.last_history = []
        rounds = 0
        while pending and rounds < max_rounds:
            if self.hdr and self.migrating:
                self.resize_step(max_moves=max(len(pending), 2))
            snap = self.snapshot()
            batch_ops: List[MwCASOp] = []
            owners: List[int] = []
            still_pending: List[int] = []
            need_resize: List[int] = []
            guard_used = False
            for idx in pending:
                compiled = self.compile_op(ops[idx], snap)
                if isinstance(compiled, NeedsResize):
                    need_resize.append(idx)
                elif isinstance(compiled, StructResult):
                    compiled.rounds = rounds
                    results[idx] = compiled
                elif any(t.addr == self.gen_addr and self.hdr
                         for t in compiled.targets):
                    # generation-guarded mutations serialize: one per
                    # round (the guard word is shared, so all but the
                    # first would lose the CAS anyway — resolve the
                    # conflict at compile time to keep rounds in
                    # lockstep across every substrate)
                    if guard_used:
                        still_pending.append(idx)
                    else:
                        guard_used = True
                        batch_ops.append(compiled)
                        owners.append(idx)
                else:
                    batch_ops.append(compiled)
                    owners.append(idx)
            if batch_ops:
                rounds += 1
                verdicts = self.backend.execute(batch_ops)
                success = np.asarray([r.success for r in verdicts])
                self._record_round(batch_ops, owners, success)
                for pos, idx in enumerate(owners):
                    if success[pos]:
                        results[idx] = StructResult(ops[idx], OK,
                                                    rounds=rounds)
                    else:
                        still_pending.append(idx)
            if need_resize:
                if self.begin_resize():
                    still_pending.extend(need_resize)
                else:
                    for idx in need_resize:
                        results[idx] = StructResult(ops[idx], FULL,
                                                    rounds=rounds)
            pending = still_pending
        for idx in pending:
            results[idx] = StructResult(ops[idx], EXHAUSTED, rounds=rounds)
        assert all(r is not None for r in results)
        return results               # type: ignore[return-value]
