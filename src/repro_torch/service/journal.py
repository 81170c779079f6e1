"""Durable decision log for cross-shard MwCAS ops.

A cross-shard op cannot be one backend commit: its targets live in
different shards' pools.  The service therefore serializes cross-shard
ops into a global round and makes each one atomic the same way the paper
makes everything atomic — a persisted descriptor as its own write-ahead
log, here one level up:

1. validate every target against its shard (reads only, nothing moves);
2. persist the decision record ``{state: SUCCEEDED, targets}`` — THE
   durability linearization point of the whole cross-shard op;
3. apply each shard's sub-op through that shard's own backend (each
   application is per-shard atomic; a durable shard writes its own WAL
   record as usual);
4. mark the record COMPLETED (lazy persist — redo is idempotent).

A crash anywhere leaves either (i) no decision record → nothing moved
(validation reads don't write), or (ii) a SUCCEEDED record → recovery
REDOES the op: any shard whose words still hold the expected values gets
its sub-op re-applied, shards already holding the desired values are
skipped.  Because the global round is serialized (no other op touches
those words until the record is COMPLETED), a word can only hold the
expected or the desired value at redo time — anything else is a torn
state and raises.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.obs import flush_reason

ST_SUCCEEDED = "SUCCEEDED"
ST_COMPLETED = "COMPLETED"

# (shard, local addr-or-slot, expected, desired)
CrossTarget = Tuple[int, object, int, int]


def _rel(op_id: str) -> str:
    return f"xwal/{op_id}.json"


class CrossShardJournal:
    """Decision log over one :class:`repro_torch.PMemPool`.

    The pool should be its own directory (or a dedicated subtree of a
    shard's pool) — the journal never collides with committer layouts
    because every record lives under ``xwal/``.
    """

    def __init__(self, pool):
        self.pool = pool

    # -- the 2 persists of the protocol ---------------------------------------
    def decide(self, op_id: str, targets: Sequence[CrossTarget]) -> None:
        """Persist the SUCCEEDED decision record (linearization point)."""
        with flush_reason("service", "journal_decide"):
            self.pool.write_record(_rel(op_id), {
                "id": op_id, "state": ST_SUCCEEDED,
                "targets": [list(t) for t in targets]})

    def complete(self, op_id: str) -> None:
        """Mark the record spent.  Lazy persist (no durability barrier):
        losing this write to a crash only means one idempotent redo."""
        rec = self.pool.read_record(_rel(op_id))
        if rec is None:
            return
        rec["state"] = ST_COMPLETED
        self.pool.write_record(_rel(op_id), rec, persist=False)

    # -- recovery --------------------------------------------------------------
    def pending(self) -> List[Dict]:
        """Decision records whose application may be incomplete."""
        out = []
        for fn in self.pool.listdir("xwal"):
            rec = self.pool.read_record(f"xwal/{fn}")
            if rec is None:
                # torn record: the decision never became durable, so the
                # op never happened — drop the residue
                self.pool.delete(f"xwal/{fn}")
                continue
            if rec.get("state") == ST_SUCCEEDED:
                out.append(rec)
        return out

    def prune(self) -> int:
        """Durably drop COMPLETED records (journal hygiene, the
        ``prune_completed`` analogue).  Returns how many were pruned."""
        pruned = 0
        for fn in self.pool.listdir("xwal"):
            rec = self.pool.read_record(f"xwal/{fn}")
            if rec is not None and rec.get("state") != ST_COMPLETED:
                continue
            with flush_reason("service", "journal_prune"):
                self.pool.delete_persist(f"xwal/{fn}")
            pruned += 1
        return pruned

    @staticmethod
    def targets_of(rec: Dict) -> List[CrossTarget]:
        return [tuple(t) for t in rec["targets"]]

    def __len__(self) -> int:
        return len(self.pool.listdir("xwal"))

    def __repr__(self) -> str:
        return f"CrossShardJournal({len(self)} records)"


# -- online shard migration ----------------------------------------------------
MIG_MIGRATING = "MIGRATING"      # decided; copy in flight; rollback on crash
MIG_ROUTED = "ROUTED"            # routing swung; cleanup redo on crash
MIG_COMPLETED = "COMPLETED"      # spent (prune-able)

_ROUTES = "mig_routes.json"


def _mig_rel(mig_id: str) -> str:
    return f"mig/{mig_id}.json"


class MigrationLog:
    """Decision log for online key-range shard migrations — the same
    journal idiom as :class:`CrossShardJournal`, one protocol level up:

    1. persist ``{state: MIGRATING, lo, hi, dst}`` — the *decide*
       record.  From here until ROUTED, a crash rolls the migration
       BACK: copies on ``dst`` (in-range keys that hash-route
       elsewhere) are deleted and the record dropped — the migration
       never happened;
    2. the service copies in-range keys to ``dst`` in batched MwCAS
       rounds (*materialize*; each round per-shard atomic as usual);
    3. flip the record to ``ROUTED`` (THE durability linearization
       point of the migration), then persist the route table with the
       new override (*swing*).  From here a crash rolls FORWARD:
       recovery re-installs the override and redoes the cleanup;
    4. delete the now-unroutable source copies, mark ``COMPLETED``
       (lazy persist — redo is idempotent).

    The route table ``mig_routes.json`` is the persistent image of
    :attr:`ShardRouter.ranges`; it is rewritten under a completed
    record's authority only, so its content is always implied by the
    record states.
    """

    def __init__(self, pool):
        self.pool = pool

    # -- the persists of the protocol ------------------------------------------
    def decide(self, mig_id: str, lo: int, hi: int, dst: int) -> None:
        with flush_reason("service", "migration_decide"):
            self.pool.write_record(_mig_rel(mig_id), {
                "id": mig_id, "state": MIG_MIGRATING,
                "lo": lo, "hi": hi, "dst": dst})

    def mark_routed(self, mig_id: str) -> None:
        rec = self.pool.read_record(_mig_rel(mig_id))
        rec["state"] = MIG_ROUTED
        with flush_reason("service", "migration_routed"):
            self.pool.write_record(_mig_rel(mig_id), rec)

    def complete(self, mig_id: str) -> None:
        rec = self.pool.read_record(_mig_rel(mig_id))
        if rec is None:
            return
        rec["state"] = MIG_COMPLETED
        self.pool.write_record(_mig_rel(mig_id), rec, persist=False)

    def abort(self, mig_id: str) -> None:
        """Drop a MIGRATING record (rollback's final persist)."""
        with flush_reason("service", "migration_abort"):
            self.pool.delete_persist(_mig_rel(mig_id))

    # -- the route table -------------------------------------------------------
    def save_routes(self, ranges) -> None:
        with flush_reason("service", "migration_routes"):
            self.pool.write_record(_ROUTES, {
                "ranges": [list(r) for r in ranges]})

    def load_routes(self) -> List[Tuple[int, int, int]]:
        rec = self.pool.read_record(_ROUTES)
        if rec is None:
            return []
        return [tuple(r) for r in rec["ranges"]]

    # -- recovery --------------------------------------------------------------
    def records(self) -> List[Dict]:
        """Every readable migration record (torn records are residue of
        an unpersisted decide — the migration never happened — and are
        dropped)."""
        out = []
        for fn in sorted(self.pool.listdir("mig")):
            rec = self.pool.read_record(f"mig/{fn}")
            if rec is None:
                self.pool.delete(f"mig/{fn}")
                continue
            out.append(rec)
        return out

    def pending(self) -> List[Dict]:
        """Records whose migration is not COMPLETED (recovery work)."""
        return [r for r in self.records()
                if r.get("state") != MIG_COMPLETED]

    def prune(self) -> int:
        """Durably drop COMPLETED records; returns how many."""
        pruned = 0
        for fn in self.pool.listdir("mig"):
            rec = self.pool.read_record(f"mig/{fn}")
            if rec is not None and rec.get("state") != MIG_COMPLETED:
                continue
            with flush_reason("service", "migration_prune"):
                self.pool.delete_persist(f"mig/{fn}")
            pruned += 1
        return pruned

    def __len__(self) -> int:
        return len(self.pool.listdir("mig"))

    def __repr__(self) -> str:
        return f"MigrationLog({len(self)} records)"
