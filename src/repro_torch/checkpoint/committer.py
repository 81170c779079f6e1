"""Atomic multi-slot checkpoint commit — the paper's PMwCAS without dirty
flags, at file granularity (DESIGN.md Sec. 2.3).

Slots are named pointers (slots/<name> -> data version); a commit atomically
moves a SET of slots from their expected versions to desired versions.  The
per-op protocol is Fig. 4 *with* the original algorithm's conservative
read barrier (the flush lines 20-22 exist to back) — it is the measured
baseline that :meth:`Committer.commit_round` optimizes away:

  1. prepare: write + persist the desired data files (out-of-place)
  2. WAL:     persist descriptor {state: FAILED, targets: [(slot, exp, des)]}
  2b. read barrier: fence each existing slot line before trusting its read
      (almost always already clean — the provenance ledger flags each of
      these ``redundant_fences``; group commit never pays them)
  3. reserve: flip each slot pointer to reference the descriptor, persist
  4. commit:  persist descriptor state = SUCCEEDED   <- linearization point
  5. finalize: write each slot pointer = desired version, persist
  6. done:    descriptor state = COMPLETED (lazy persist), GC old data

There are NO per-slot commit markers (the dirty-flag analogue; the
baseline committer in marker_committer.py has them for the benchmark).
Recovery reads only descriptors + slot pointers and rolls forward/back.

Round-level group commit (DESIGN.md Sec. 9): :meth:`Committer.commit_round`
coalesces a whole conflict-free batch round into ONE WAL record — the
record embeds every op's targets AND payloads, so its single persist is
the round's only durability fence.  Data files and slot pointers are
written visibly but flushed lazily; recovery replays round records (in
commit order) exactly like per-op descriptors, rebuilding anything the
crash dropped from the record itself.  Descriptors-as-WAL is unchanged —
only flush *placement* moves, from per-op to per-round.

Epoch durability (DESIGN.md Sec. 14): with ``epoch_rounds > 1`` even the
per-round fence amortizes away — rounds buffer into an *epoch* that
shares ONE persist (a coalesced ``wal/epoch-*`` record embedding every
buffered round).  A fence is interposed early only when a round reads a
slot an earlier buffered round wrote (dependency-aware elision, tracked
from the rounds' target sets); :meth:`Committer.sync` is the explicit
barrier for callers needing round-granular durability, and a crash
inside an open epoch loses at most ``epoch_rounds - 1`` committed-but-
unfenced rounds, never a torn one (the bounded-loss window).  Data
files are MOD-style out-of-place on this path: they materialize only at
epoch close and are never individually fenced — the epoch record is the
single line needing ordered persistence.  :meth:`Committer.checkpoint`
persists one out-of-place image of every live slot (version + payload)
and durably drops the round/epoch records it covers, so recovery replay
length is bounded by the checkpoint cadence instead of the run length;
within an epoch the dependency rule makes the rounds mutually
independent, so recovery redoes each surviving epoch as one stacked
batch with no per-round fences.
"""
from __future__ import annotations

import base64
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..obs import flush_reason, get_registry, span
from .pmem import PMemPool

ST_COMPLETED, ST_FAILED, ST_SUCCEEDED = "COMPLETED", "FAILED", "SUCCEEDED"

_ROUND_PREFIX = "round-"
_EPOCH_PREFIX = "epoch-"
_CKPT_PREFIX = "ckpt-"


def _slot_rel(name: str) -> str:
    return f"slots/{name}.json"


def _desc_rel(cid: str) -> str:
    return f"wal/{cid}.json"


def _ckpt_rel(cid: str) -> str:
    return f"ckpt/{cid}.json"


def _rec_seq(rec_id: str) -> int:
    """Commit sequence embedded in a round/epoch/ckpt record id."""
    return int(rec_id.rsplit("-", 1)[1])


def data_rel(name: str, version: int) -> str:
    return f"data/{name}.v{version}.bin"


class CommitError(Exception):
    pass


@dataclasses.dataclass
class DurabilityStats:
    """Flush accounting for the commit paths (the paper's fewer-flushes
    lever, measured): how many persists were actually issued, how many
    the per-op protocol would have issued for the same commits, and how
    many commit fences (round-record persists) were paid."""
    flushes_issued: int = 0    # persists actually issued by commit paths
    flushes_saved: int = 0     # per-op-protocol persists coalesced away
    fences: int = 0            # round/epoch-record commit fences
    round_commits: int = 0     # commit_round calls that committed >= 1 op
    op_commits: int = 0        # per-op commit() calls
    ops_committed: int = 0     # ops that reached their linearization point
    epochs_closed: int = 0     # epoch records persisted (sync barriers)
    checkpoints: int = 0       # checkpoint images persisted
    dep_fences: int = 0        # epoch closes forced by a read-after-write

    def merge(self, other: "DurabilityStats") -> "DurabilityStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_row(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @property
    def flushes_per_commit(self) -> float:
        return (self.flushes_issued / self.ops_committed
                if self.ops_committed else 0.0)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def _unb64(text: str) -> bytes:
    return base64.b64decode(text.encode("ascii"))


def _per_op_flush_cost(targets: Sequence[Tuple[str, int, int]]) -> int:
    """Persists the per-op protocol pays for one committed op: k data
    prepares + 1 WAL + k reserves + 1 SUCCEEDED + k finalizes."""
    return 3 * len(targets) + 2


def _account(stats: DurabilityStats, **deltas: int) -> None:
    """Apply deltas to BOTH the dataclass and the global registry with
    the same integers — the two ledgers can never drift, which is what
    lets the durable benchmark assert exact equality between them.
    Registry series carry ``component="committer"`` so live commit
    accounting never collides with the adapter snapshot folds."""
    registry = get_registry()
    for name, delta in deltas.items():
        setattr(stats, name, getattr(stats, name) + delta)
        if delta:
            registry.counter(name, component="committer").inc(delta)


class Committer:
    """The paper's algorithm (no dirty flags)."""

    # round-level group commit is a protocol property of THIS committer;
    # the marker baseline keeps its per-slot dirty flags and opts out
    supports_rounds = True

    def __init__(self, pool: PMemPool, epoch_rounds: int = 1,
                 checkpoint_every: int = 0):
        """``epoch_rounds > 1`` buffers that many rounds per durability
        epoch (ONE fence at close; bounded-loss window of
        ``epoch_rounds - 1`` rounds); ``checkpoint_every = N`` persists
        a checkpoint image after every N epoch closes, bounding recovery
        replay to at most N epochs.  The defaults keep the measured
        group-commit protocol bit-identical."""
        self.pool = pool
        self.stats = DurabilityStats()
        self.epoch_rounds = max(1, int(epoch_rounds))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self._round_seq: Optional[int] = None   # lazily scanned from wal/
        self._ckpt_seq: Optional[int] = None    # lazily scanned from ckpt/
        self._epoch: List[Dict] = []            # buffered round records
        self._epoch_written: Set[str] = set()   # slots those rounds wrote
        self._epochs_since_ckpt = 0

    @property
    def epoch_pending(self) -> int:
        """Rounds committed-but-unfenced in the open epoch (each is
        visible; none is durable until the next close/:meth:`sync`)."""
        return len(self._epoch)

    # -- reads -----------------------------------------------------------------
    def slot_version(self, name: str) -> int:
        """Read procedure (Fig. 5): resolve through in-flight descriptors."""
        rec = self.pool.read_record(_slot_rel(name))
        if rec is None:
            return 0
        if "desc" in rec:
            desc = self.pool.read_record(_desc_rel(rec["desc"]))
            if desc is None:    # descriptor never persisted -> roll back
                return rec["expected"]
            t = {s: (e, d) for s, e, d in desc["targets"]}
            exp, des = t[name]
            return des if desc["state"] == ST_SUCCEEDED else exp
        return rec["version"]

    # -- commit ------------------------------------------------------------------
    def commit(self, cid: str, targets: Sequence[Tuple[str, int, int]],
               payloads: Dict[str, bytes]) -> bool:
        """Atomically move every (slot, expected, desired); all-or-nothing.

        payloads: desired data per slot (written out-of-place first).
        """
        if self._epoch:
            # the per-op protocol reads and fences slot lines directly,
            # so an open epoch's rounds must be durable first — a
            # dependency fence in the minimal-ordering sense (the mixed
            # history could otherwise recover this commit without the
            # buffered rounds it read)
            self.sync()
        pool = self.pool
        p0 = pool.persist_count
        with span("wal.commit", slots=len(targets)) as sp:
            try:
                ok = self._commit(cid, targets, payloads)
            finally:
                _account(self.stats, op_commits=1,
                         flushes_issued=pool.persist_count - p0)
            if ok:
                _account(self.stats, ops_committed=1)
            sp.set(ok=ok, flushes=pool.persist_count - p0)
        return ok

    def _commit(self, cid: str, targets: Sequence[Tuple[str, int, int]],
                payloads: Dict[str, bytes]) -> bool:
        pool = self.pool
        # 0. versions must advance.  An exp == des "no-op move" would pass
        # every check and then GC its own live data file in step 6
        # (delete of data_rel(name, exp) == data_rel(name, des)).
        for _name, exp, des in targets:
            if des == exp:
                return False
        # 1. prepare desired values (out-of-place).  A desired version that
        # collides with the slot's LIVE version (stale exp) must not
        # clobber its data: refuse before writing anything.  The exists()
        # stat keeps the common path (fresh desired versions) to one cheap
        # check per target.
        for name, _exp, des in targets:
            if pool.exists(data_rel(name, des)) and \
                    des == self.slot_version(name) and \
                    pool.read(data_rel(name, des)) != payloads[name]:
                return False
        with flush_reason("committer", "data_prepare"):
            for name, _exp, des in targets:
                pool.write_persist(data_rel(name, des), payloads[name])
        # 2. the descriptor IS the write-ahead log
        desc = {"id": cid, "state": ST_FAILED,
                "targets": [list(t) for t in targets],
                "ts": time.time()}
        with flush_reason("committer", "descriptor"):
            pool.write_record(_desc_rel(cid), desc)
        # 2b. the original algorithm's conservative read barrier — the
        # flush Fig. 4 lines 20-22 exist to back: before trusting a
        # slot read for the reserve step, fence its line.  In steady
        # state the line is already clean, which is EXACTLY the
        # redundancy the paper's algorithm removes; the per-op protocol
        # keeps it as the measured baseline (the provenance ledger
        # flags each one redundant), and commit_round never pays it.
        with flush_reason("committer", "read_barrier"):
            for name, _exp, _des in targets:
                if pool.exists(_slot_rel(name)):
                    pool.persist(_slot_rel(name))
        # 3. reserve every slot (embed the descriptor address)
        success = True
        reserved: List[str] = []
        for name, exp, _des in targets:
            cur = self.pool.read_record(_slot_rel(name))
            cur_ver = 0 if cur is None else cur.get("version")
            if cur is not None and "desc" in cur:
                # another in-flight commit: resolve it first (help/wait)
                cur_ver = self.slot_version(name)
            if cur_ver != exp:
                success = False
                break
            with flush_reason("committer", "reserve"):
                pool.write_record(_slot_rel(name),
                                  {"desc": cid, "expected": exp})
            reserved.append(name)
        if success:
            # 4. durability linearization point
            desc["state"] = ST_SUCCEEDED
            with flush_reason("committer", "commit_point"):
                pool.write_record(_desc_rel(cid), desc)
        # 5. finalize (commit or roll back the reserved prefix)
        t = {s: (e, d) for s, e, d in targets}
        with flush_reason("committer", "finalize"):
            for name in reserved:
                exp, des = t[name]
                ver = des if success else exp
                pool.write_record(_slot_rel(name), {"version": ver})
        # 6. completed (lazy persist is safe: recovery replays idempotently)
        desc["state"] = ST_COMPLETED if success else desc["state"]
        pool.write_record(_desc_rel(cid), desc, persist=False)
        if success:
            for name, exp, _des in targets:
                if exp:
                    pool.delete(data_rel(name, exp))  # GC old version
        else:
            # GC the desired data files written in step 1: the rolled-back
            # slots never reference them, and leaving them would leak
            # orphaned data/*.bin until the next recover()
            for name, _exp, des in targets:
                if des != self.slot_version(name):
                    pool.delete(data_rel(name, des))
        return success

    # -- round-level group commit --------------------------------------------------
    def _scan_wal_seq(self) -> int:
        """First unused round sequence judging from ``wal/`` filenames
        (an epoch record is named by its LAST embedded round, so the
        scan needs no record reads)."""
        top = 0
        for fn in self.pool.listdir("wal"):
            for prefix in (_ROUND_PREFIX, _EPOCH_PREFIX):
                if fn.startswith(prefix) and fn.endswith(".json"):
                    try:
                        top = max(top, 1 + int(
                            fn[len(prefix):-len(".json")]))
                    except ValueError:
                        pass
        return top

    def _next_round_id(self) -> str:
        """Monotonic round ids; ``wal/`` filename order == commit order
        (recovery replays rounds in that order).  The sequence resumes
        past any surviving round/epoch records after a crash."""
        if self._round_seq is None:
            self._round_seq = self._scan_wal_seq()
        rid = f"{_ROUND_PREFIX}{self._round_seq:010d}"
        self._round_seq += 1
        return rid

    def commit_round(self, entries: Sequence[Tuple[str, Sequence[
            Tuple[str, int, int]]]], payloads: Dict[str, bytes]
            ) -> List[bool]:
        """Commit a conflict-free round of ops under ONE durability fence.

        ``entries`` is ``[(op_id, [(slot, expected, desired), ...]), ...]``
        — ops of one batch round; an op whose slots collide with an
        earlier entry, whose expected versions are stale, or whose
        versions do not advance fails individually (per-entry verdicts
        are returned, mirroring per-op :meth:`commit`).

        Protocol (DESIGN.md Sec. 9) — flush placement, not WAL shape,
        is what changes versus per-op commit:

        1. validate every entry against the live slot versions;
        2. write every winner's desired data files (visible, NOT yet
           flushed);
        3. persist ONE coalesced round record ``{id, kind: round,
           state: SUCCEEDED, ops: [{id, targets, payloads}]}`` — the
           single commit fence and durability linearization point of
           every op in the round;
        4. finalize every slot pointer and GC old data files LAZILY —
           the record (which embeds the payloads) is the durable truth
           until :meth:`prune_completed` flushes the final state and
           drops it.

        A crash before (3) leaves no durable record: the round never
        happened.  A crash after (3) is redone by :meth:`recover`
        (rounds replay in commit order; a slot already at its desired
        version is skipped, a slot superseded by a later durable commit
        is left alone).
        """
        pool = self.pool
        p0 = pool.persist_count
        with span("wal.commit_round", ops=len(entries)) as sp:
            verdicts: List[bool] = []
            winners: List[Tuple[str, List[Tuple[str, int, int]]]] = []
            claimed: Set[str] = set()
            for op_id, targets in entries:
                targets = [tuple(t) for t in targets]
                ok = (all(des != exp for _n, exp, des in targets) and
                      not any(name in claimed
                              for name, _e, _d in targets) and
                      all(self.slot_version(name) == exp
                          for name, exp, _d in targets))
                if ok:
                    claimed.update(name for name, _e, _d in targets)
                    winners.append((op_id, targets))
                verdicts.append(ok)
            sp.set(winners=len(winners))
            if not winners:
                return verdicts
            if self.epoch_rounds > 1:
                # -- epoch path (DESIGN.md Sec. 14) --------------------
                # Dependency-aware fence elision: every target slot is
                # both read (expected check) and written, so a fence is
                # interposed early ONLY when this round's target set
                # intersects what the open epoch already wrote — the
                # minimal ordering the recovered state needs.
                if claimed & self._epoch_written:
                    _account(self.stats, dep_fences=1)
                    self.sync()
                rid = self._next_round_id()
                rec = {"id": rid, "kind": "round", "state": ST_SUCCEEDED,
                       "ops": [{"id": op_id,
                                "targets": [list(t) for t in targets],
                                "payloads": {name: _b64(payloads[name])
                                             for name, _e, _d in targets}}
                               for op_id, targets in winners],
                       "ts": time.time()}
                # lazy finalize: slot pointers move visibly NOW (reads
                # see the round committed); data files do not — they
                # are MOD-style out-of-place and materialize at close
                for _op_id, targets in winners:
                    for name, _exp, des in targets:
                        pool.write_record(_slot_rel(name),
                                          {"version": des}, persist=False)
                self._epoch.append(rec)
                self._epoch_written |= claimed
                # the round's own fence is elided (credited saved here);
                # the shared close fence is debited when it is paid
                _account(self.stats, round_commits=1,
                         ops_committed=len(winners),
                         flushes_saved=sum(_per_op_flush_cost(t)
                                           for _id, t in winners) - 1)
                sp.set(flushes=0, epoch_pending=len(self._epoch))
                if len(self._epoch) >= self.epoch_rounds:
                    # the Nth round rides the closing fence, so at most
                    # epoch_rounds - 1 committed rounds are ever at risk
                    self.sync()
                return verdicts
            # 2. desired data, visible but unflushed (redo rebuilds it
            # from the record, so no per-file fence is needed)
            for _op_id, targets in winners:
                for name, _exp, des in targets:
                    pool.write(data_rel(name, des), payloads[name])
            # 3. the ONE fence: a coalesced WAL record for the round
            rid = self._next_round_id()
            rec = {"id": rid, "kind": "round", "state": ST_SUCCEEDED,
                   "ops": [{"id": op_id,
                            "targets": [list(t) for t in targets],
                            "payloads": {name: _b64(payloads[name])
                                         for name, _e, _d in targets}}
                           for op_id, targets in winners],
                   "ts": time.time()}
            with flush_reason("committer", "group_record"):
                pool.write_record(_desc_rel(rid), rec)
            # 4. lazy finalize + lazy GC (recovery replays the record)
            for _op_id, targets in winners:
                for name, exp, des in targets:
                    pool.write_record(_slot_rel(name), {"version": des},
                                      persist=False)
                    if exp:
                        pool.delete(data_rel(name, exp))
            rec["state"] = ST_COMPLETED
            pool.write_record(_desc_rel(rid), rec, persist=False)
            issued = pool.persist_count - p0
            _account(self.stats, flushes_issued=issued,
                     flushes_saved=sum(_per_op_flush_cost(t)
                                       for _id, t in winners) - issued,
                     fences=1, round_commits=1,
                     ops_committed=len(winners))
            sp.set(flushes=issued)
            return verdicts

    # -- epoch durability ---------------------------------------------------------
    def sync(self) -> int:
        """Close the open epoch under ONE persist fence; returns the
        number of rounds made durable (0 if none were buffered).

        The explicit round-granular durability barrier: the coalesced
        ``wal/epoch-*`` record (named by its LAST embedded round, so
        filename order stays commit order) embeds every buffered round —
        its single persist is the durability linearization point of all
        of them.  Only then do the rounds' data files materialize
        (out-of-place, visible, never fenced) and the superseded
        pre-epoch data files go away: no line but the epoch record ever
        needs ordered persistence."""
        if not self._epoch:
            return 0
        pool = self.pool
        rounds, self._epoch = self._epoch, []
        self._epoch_written = set()
        eid = f"{_EPOCH_PREFIX}{rounds[-1]['id'][len(_ROUND_PREFIX):]}"
        with span("wal.epoch_close", rounds=len(rounds)) as sp:
            rec = {"id": eid, "kind": "epoch",
                   "rounds": rounds, "ts": time.time()}
            with flush_reason("committer", "epoch_close"):
                pool.write_record(_desc_rel(eid), rec)   # THE one fence
            for rnd in rounds:
                for op in rnd["ops"]:
                    for name, exp, des in (tuple(t) for t in op["targets"]):
                        pool.write(data_rel(name, des),
                                   _unb64(op["payloads"][name]))
                        if exp:
                            pool.delete(data_rel(name, exp))
            # group commit would have paid one fence per round; the
            # epoch pays one for all of them
            _account(self.stats, flushes_issued=1, fences=1,
                     epochs_closed=1, flushes_saved=len(rounds) - 1)
            sp.set(flushes=1)
        self._epochs_since_ckpt += 1
        if self.checkpoint_every and \
                self._epochs_since_ckpt >= self.checkpoint_every:
            self.checkpoint()
        return len(rounds)

    def _next_ckpt_id(self) -> str:
        if self._ckpt_seq is None:
            top = 0
            for fn in self.pool.listdir("ckpt"):
                if fn.startswith(_CKPT_PREFIX) and fn.endswith(".json"):
                    try:
                        top = max(top, 1 + int(
                            fn[len(_CKPT_PREFIX):-len(".json")]))
                    except ValueError:
                        pass
            self._ckpt_seq = top
        cid = f"{_CKPT_PREFIX}{self._ckpt_seq:010d}"
        self._ckpt_seq += 1
        return cid

    def checkpoint(self) -> int:
        """Persist one out-of-place image of every live slot and durably
        drop the round/epoch records it covers; returns records dropped.

        The image embeds versions AND payloads, so under the round/epoch
        protocol the slot and data files become pure cache — nothing
        under ``slots/`` or ``data/`` is fenced here (the MOD argument:
        out-of-place shrinks the ordered-persistence set to the single
        checkpoint record).  ``covers`` is the highest round sequence
        reflected in the image; recovery installs the latest image and
        replays only records above it, so replay length is bounded by
        the checkpoint cadence — this supersedes raw ``wal_prune_every``
        scanning.  Crash-safe at every persist: before the image lands
        the old image + records recover; after it, recovery finishes the
        interrupted drops itself.  Per-op descriptors are out of scope
        (they act through durable slot references and keep
        :meth:`prune_completed` as their hygiene path)."""
        self.sync()               # the image reflects a round prefix
        self._epochs_since_ckpt = 0
        pool = self.pool
        p0 = pool.persist_count
        with span("wal.checkpoint") as sp, \
                flush_reason("committer", "checkpoint"):
            slots: Dict[str, int] = {}
            payloads: Dict[str, str] = {}
            for fn in pool.listdir("slots"):
                name = fn[:-len(".json")]
                rec = pool.read_record(_slot_rel(name))
                if rec is not None and "desc" in rec:
                    continue      # in-flight per-op: its descriptor owns it
                ver = self.slot_version(name)
                slots[name] = ver
                if ver and pool.exists(data_rel(name, ver)):
                    payloads[name] = _b64(pool.read(data_rel(name, ver)))
            covers = -1
            covered: List[str] = []
            for fn in pool.listdir("wal"):
                desc = pool.read_record(f"wal/{fn}")
                if desc is not None and \
                        desc.get("kind") in ("round", "epoch"):
                    covers = max(covers, _rec_seq(desc["id"]))
                    covered.append(f"wal/{fn}")
            if covers < 0 and not slots:
                return 0          # nothing to bound
            cid = self._next_ckpt_id()
            pool.write_record(_ckpt_rel(cid), {
                "id": cid, "kind": "checkpoint", "covers": covers,
                "slots": slots, "payloads": payloads,
                "ts": time.time()})              # the image's ONE fence
            for rel in covered:
                pool.delete_persist(rel)         # replay debt retired
            for fn in pool.listdir("ckpt"):
                if fn != f"{cid}.json":
                    pool.delete_persist(f"ckpt/{fn}")   # old image spent
            issued = pool.persist_count - p0
            # honest ledger: pruning the same records would have fenced
            # every slot + live data file before each drop
            _account(self.stats, flushes_issued=issued, checkpoints=1,
                     flushes_saved=max(
                         0, 2 * len(slots) + len(covered) - issued))
            sp.set(covers=covers, dropped=len(covered), flushes=issued)
        return len(covered)

    # -- WAL hygiene --------------------------------------------------------------
    def prune_completed(self) -> int:
        """Remove spent descriptor records from ``wal/``; returns how
        many were pruned.

        Every structure op writes one descriptor, so without pruning the
        WAL grows without bound (ROADMAP: recovery-time GC).  A record is
        *spent* — and safe to drop durably — once no target slot still
        references it: COMPLETED records (the common case, finalize done)
        and FAILED/SUCCEEDED residue that recovery already rolled
        forward/back.  Recovery only ever consults a descriptor through a
        slot's ``desc`` reference, so an unreferenced record cannot
        influence any future recover().

        Round records (group commit) are the ONLY durable copy of their
        round's effects until pruned, so dropping one first flushes the
        final state it guards — each slot pointer and live data file
        exactly once (dedup across rounds touching the same file).
        This is the deferred half of the group-commit bargain: the
        flushes leave the commit hot path and are amortized here.

        An open epoch closes first (one fence), as in :meth:`commit`:
        its rounds have already moved slot pointers visibly, so flushing
        a slot line for an older record would make an unfenced round's
        version durable without the rest of that round — a torn round
        after a crash.  While a checkpoint image exists, round and epoch
        records stay: recovery installs the image over the slot lines
        and replays only the records above it, so a record dropped here
        would take its rounds back to the image's versions.  The
        checkpoint cadence retires those records instead.
        """
        if self.epoch_pending:
            self.sync()
        pool = self.pool
        imaged = bool(pool.listdir("ckpt"))
        pruned = 0
        flushed: Set[str] = set()        # dedup: one persist per file

        def _flush_once(rel: str) -> None:
            if rel not in flushed and pool.exists(rel):
                pool.persist(rel)
                flushed.add(rel)

        with span("wal.prune_completed") as sp, \
                flush_reason("committer", "wal_prune"):
            for fn in pool.listdir("wal"):
                rel = f"wal/{fn}"
                desc = pool.read_record(rel)
                if desc is not None and \
                        desc.get("kind") in ("round", "epoch"):
                    if imaged:
                        continue             # the next checkpoint's job
                    # REDO the round(s) first (idempotent, exactly what
                    # recover() does): prune may legally run on a
                    # reopened pool before any recover, when the visible
                    # slot state still predates the round — flushing
                    # that stale state and dropping the record would
                    # lose the committed ops.  An epoch record is its
                    # rounds' only durable copy, so it prunes the same
                    # way, round by embedded round.
                    p0 = pool.persist_count
                    rounds = (desc["rounds"] if desc["kind"] == "epoch"
                              else [desc])
                    n_ops = 0
                    for rnd in rounds:
                        self._replay_round(rnd)
                        for op in rnd["ops"]:
                            n_ops += 1
                            for name, _exp, des in op["targets"]:
                                _flush_once(_slot_rel(name))
                                _flush_once(data_rel(name, des))
                    pool.delete_persist(rel)
                    issued = pool.persist_count - p0
                    # honest ledger: the per-op protocol would pay one
                    # delete_persist per op record here (its commit-time
                    # flushes were already credited saved in
                    # commit_round, so every persist THIS pass issues
                    # claws savings back)
                    _account(self.stats, flushes_issued=issued,
                             flushes_saved=n_ops - issued)
                    pruned += 1
                    continue
                if desc is not None:
                    referenced = False
                    for name, _exp, _des in desc["targets"]:
                        rec = pool.read_record(_slot_rel(name))
                        if rec is not None and \
                                rec.get("desc") == desc["id"]:
                            referenced = True
                            break
                    if referenced:
                        continue             # still in-flight: keep
                pool.delete_persist(rel)     # torn/spent: durably drop
                _account(self.stats, flushes_issued=1)  # per-op cost too
                pruned += 1
            sp.set(pruned=pruned)
        return pruned

    def _replay_round(self, desc: Dict) -> None:
        """Idempotent redo of one durable round record (shared by
        :meth:`recover` and :meth:`prune_completed`): a slot still at
        its expected version rolls forward durably (data file rebuilt
        from the embedded payload), a slot already at the desired
        version only has its data file ensured, and a slot superseded
        by a later durable commit is left alone."""
        pool = self.pool
        for op in desc["ops"]:
            for name, exp, des in (tuple(t) for t in op["targets"]):
                cur = self.slot_version(name)
                if cur == exp:
                    pool.write_persist(data_rel(name, des),
                                       _unb64(op["payloads"][name]))
                    pool.write_record(_slot_rel(name), {"version": des})
                elif cur == des and not pool.exists(data_rel(name, des)):
                    pool.write_persist(data_rel(name, des),
                                       _unb64(op["payloads"][name]))

    def _replay_epoch(self, desc: Dict) -> None:
        """One stacked redo of an epoch's rounds.  The dependency-
        elision rule guarantees no slot appears in two rounds of the
        same epoch, so the union of their slot moves applies as ONE
        batch — and with NO per-round fences: every write here is lazy
        (visible only), because the epoch record itself stays the
        durable truth until a checkpoint drops it.  Eliminating those
        per-round fsyncs is what collapses ``recover_ms``."""
        pool = self.pool
        for rnd in desc["rounds"]:
            for op in rnd["ops"]:
                for name, exp, des in (tuple(t) for t in op["targets"]):
                    cur = self.slot_version(name)
                    if cur == exp:
                        pool.write(data_rel(name, des),
                                   _unb64(op["payloads"][name]))
                        pool.write_record(_slot_rel(name),
                                          {"version": des}, persist=False)
                        if exp:
                            pool.delete(data_rel(name, exp))
                    elif cur == des and \
                            not pool.exists(data_rel(name, des)):
                        pool.write(data_rel(name, des),
                                   _unb64(op["payloads"][name]))

    # -- recovery -----------------------------------------------------------------
    def recover(self) -> Dict[str, int]:
        """Roll every slot forward/back from the persisted descriptors.
        Idempotent; returns the recovered slot->version map.

        Per-op descriptors act through slot references (reserve made the
        pointer durable) and are order-independent; round records carry
        no slot references — a durable round record means DECIDED, and
        its ops replay in commit order (the id embeds the sequence):
        a slot still at the expected version is rolled forward (data
        file rebuilt from the record's embedded payload), a slot already
        at the desired version only has its data file ensured, and a
        slot superseded by a later durable commit is left alone.

        With checkpoints, replay is bounded and batched: the latest
        checkpoint image installs first (slots + payloads, lazily — the
        image stays the durable truth), records at or below its
        ``covers`` sequence are durably dropped (finishing any
        interrupted checkpoint's job), and each surviving epoch record
        redoes as one stacked batch via :meth:`_replay_epoch` with no
        per-round fences."""
        pool = self.pool
        t0_ns = time.perf_counter_ns()
        with span("wal.recover", committer="wal") as sp, \
                flush_reason("committer", "recover"):
            # phase 0: install the latest checkpoint image (if any) and
            # note the round prefix it covers
            covers = -1
            with span("recover.load_checkpoint") as lc:
                images = []
                for fn in pool.listdir("ckpt"):
                    rec = pool.read_record(f"ckpt/{fn}")
                    if rec is None:
                        pool.delete(f"ckpt/{fn}")          # torn image
                    else:
                        images.append(rec)
                images.sort(key=lambda r: _rec_seq(r["id"]))
                installed = 0
                if images:
                    ck = images[-1]
                    for old in images[:-1]:   # crash mid-supersede:
                        pool.delete_persist(_ckpt_rel(old["id"]))
                    covers = ck["covers"]
                    for name, ver in ck["slots"].items():
                        cur = pool.read_record(_slot_rel(name))
                        if cur is not None and "desc" in cur:
                            continue   # durable per-op reservation wins
                        pool.write_record(_slot_rel(name),
                                          {"version": ver}, persist=False)
                        payload = ck["payloads"].get(name)
                        if ver and payload is not None and \
                                not pool.exists(data_rel(name, ver)):
                            pool.write(data_rel(name, ver),
                                       _unb64(payload))
                        installed += 1
                lc.set(installed=installed, covers=covers)
            # phase 1: scan the WAL — drop torn records and anything the
            # checkpoint already covers, split the rest into the per-op
            # and round/epoch replay queues
            ops: List[Dict] = []
            rounds: List[Dict] = []
            with span("recover.scan_wal") as scan:
                for fn in pool.listdir("wal"):
                    desc = pool.read_record(f"wal/{fn}")
                    if desc is None:
                        pool.delete(f"wal/{fn}")   # torn/unpersisted
                    elif desc.get("kind") in ("round", "epoch"):
                        if _rec_seq(desc["id"]) <= covers:
                            # leftover an interrupted checkpoint meant
                            # to drop: its effects are in the image
                            pool.delete_persist(f"wal/{fn}")
                        else:
                            rounds.append(desc)
                    else:
                        ops.append(desc)
                scan.set(ops=len(ops), rounds=len(rounds))
            # phase 2: per-op descriptors act through slot references
            # (reserve made the pointer durable); order-independent
            with span("recover.replay_ops", ops=len(ops)):
                for desc in ops:
                    t = {s: (e, d) for s, e, d in desc["targets"]}
                    for name, (exp, des) in t.items():
                        rec = pool.read_record(_slot_rel(name))
                        if rec is not None and \
                                rec.get("desc") == desc["id"]:
                            ver = des if desc["state"] == ST_SUCCEEDED \
                                else exp
                            pool.write_record(_slot_rel(name),
                                              {"version": ver})
            # phase 3: rounds replay in commit order (id embeds
            # sequence; an epoch record sorts at its FIRST embedded
            # round — epochs are contiguous sequence ranges, so the
            # merged order is total).  Epochs redo as one stacked batch
            # each, with no per-round fences.
            def _order(d: Dict) -> int:
                if d.get("kind") == "epoch":
                    return _rec_seq(d["rounds"][0]["id"])
                return _rec_seq(d["id"])

            n_epochs = sum(1 for d in rounds if d.get("kind") == "epoch")
            with span("recover.replay_rounds",
                      rounds=len(rounds) - n_epochs, epochs=n_epochs):
                for desc in sorted(rounds, key=_order):
                    if desc.get("kind") == "epoch":
                        self._replay_epoch(desc)
                    else:
                        self._replay_round(desc)
            # phase 4: drop data files no slot references (uncommitted
            # desired versions)
            with span("recover.gc_data") as gc:
                live = set()
                for fn in pool.listdir("slots"):
                    name = fn[:-len(".json")]
                    live.add(data_rel(name, self.slot_version(name)))
                dropped = 0
                for fn in pool.listdir("data"):
                    if f"data/{fn}" not in live:
                        pool.delete(f"data/{fn}")
                        dropped += 1
                gc.set(dropped=dropped)
            recovered = {
                fn[:-len('.json')]: self.slot_version(fn[:-len('.json')])
                for fn in pool.listdir("slots")}
            # the round sequence must clear the checkpoint horizon, or a
            # reused sequence would be mistaken for covered on the NEXT
            # recovery and dropped unreplayed
            self._round_seq = max(self._scan_wal_seq(), covers + 1,
                                  self._round_seq or 0)
            sp.set(slots=len(recovered))
        get_registry().histogram("recover_us", component="committer") \
            .record((time.perf_counter_ns() - t0_ns) / 1e3)
        return recovered
