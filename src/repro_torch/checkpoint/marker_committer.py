"""Baseline committer WITH per-slot commit markers — the file-granularity
analogue of the original algorithm's dirty flags (and of naive multi-file
checkpointers): every slot write sets a marker, persists, clears the
marker, persists again.  Functionally equivalent to ``Committer`` but pays
2 extra persists per slot; ``benchmarks/bench_ckpt.py`` quantifies the gap,
mirroring the paper's ours-vs-ours(DF) comparison."""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

from ..obs import flush_reason, get_registry, span
from .committer import (Committer, DurabilityStats, ST_COMPLETED, ST_FAILED,
                        ST_SUCCEEDED, _account, _desc_rel, _slot_rel,
                        data_rel)
from .pmem import PMemPool


def _marker_rel(name: str) -> str:
    return f"markers/{name}.json"


class MarkerCommitter:
    # dirty-flag markers are inherently per-slot; no round-level protocol
    supports_rounds = False

    def __init__(self, pool: PMemPool, epoch_rounds: int = 1,
                 checkpoint_every: int = 0):
        # epoch durability needs round records to buffer and a single
        # coalesced fence to ride; per-slot dirty flags force a fence
        # per slot write, so the baseline cannot defer them — refuse
        # rather than silently measure the wrong protocol
        if int(epoch_rounds) != 1 or int(checkpoint_every):
            raise ValueError(
                "marker committer has no epoch protocol (per-slot dirty "
                "flags cannot defer their fences); use the WAL committer "
                "for epoch_rounds > 1 / checkpoint_every > 0")
        self.pool = pool
        self.stats = DurabilityStats()

    # WAL hygiene is committer-agnostic (it reads only descriptors and
    # slot records, both shared vocabulary) — reuse the primary logic
    prune_completed = Committer.prune_completed

    # surface uniformity with Committer's epoch API: every marker commit
    # is already durable at return, so the barrier has nothing to close
    epoch_pending = 0

    def sync(self) -> int:
        return 0

    def slot_version(self, name: str) -> int:
        rec = self.pool.read_record(_slot_rel(name))
        if rec is None:
            return 0
        if "desc" in rec:
            desc = self.pool.read_record(_desc_rel(rec["desc"]))
            if desc is None:
                return rec["expected"]
            t = {s: (e, d) for s, e, d in desc["targets"]}
            exp, des = t[name]
            return des if desc["state"] == ST_SUCCEEDED else exp
        return rec["version"]

    def commit(self, cid: str, targets: Sequence[Tuple[str, int, int]],
               payloads: Dict[str, bytes]) -> bool:
        pool = self.pool
        p0 = pool.persist_count
        with span("wal.commit", slots=len(targets),
                  committer="marker") as sp:
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
        # versions must advance + never clobber a live version's data
        # (see Committer.commit steps 0/1)
        for _name, exp, des in targets:
            if des == exp:
                return False
        for name, _exp, des in targets:
            if pool.exists(data_rel(name, des)) and \
                    des == self.slot_version(name) and \
                    pool.read(data_rel(name, des)) != payloads[name]:
                return False
        with flush_reason("committer", "data_prepare"):
            for name, _exp, des in targets:
                pool.write_persist(data_rel(name, des), payloads[name])
        desc = {"id": cid, "state": ST_FAILED,
                "targets": [list(t) for t in targets], "ts": time.time()}
        with flush_reason("committer", "descriptor"):
            pool.write_record(_desc_rel(cid), desc)
        # the dirty-flag algorithm's conservative read barrier (same as
        # Committer._commit step 2b): fence each slot line before
        # trusting its read
        with flush_reason("committer", "read_barrier"):
            for name, _exp, _des in targets:
                if pool.exists(_slot_rel(name)):
                    pool.persist(_slot_rel(name))
        success = True
        reserved = []
        for name, exp, _des in targets:
            cur = pool.read_record(_slot_rel(name))
            cur_ver = 0 if cur is None else cur.get("version")
            if cur is not None and "desc" in cur:
                cur_ver = self.slot_version(name)
            if cur_ver != exp:
                success = False
                break
            with flush_reason("committer", "reserve"):
                pool.write_record(_slot_rel(name),
                                  {"desc": cid, "expected": exp})
            reserved.append(name)
        if success:
            desc["state"] = ST_SUCCEEDED
            with flush_reason("committer", "commit_point"):
                pool.write_record(_desc_rel(cid), desc)
        t = {s: (e, d) for s, e, d in targets}
        with flush_reason("committer", "marker_finalize"):
            for name in reserved:
                exp, des = t[name]
                ver = des if success else exp
                # dirty-flag analogue: set marker, persist, write, persist,
                # clear marker, persist  (the double-flush the paper removes)
                pool.write_record(_marker_rel(name),
                                  {"dirty": True, "slot": name})
                pool.write_record(_slot_rel(name), {"version": ver})
                pool.write_record(_marker_rel(name), {"dirty": False,
                                                      "slot": name})
        desc["state"] = ST_COMPLETED if success else desc["state"]
        pool.write_record(_desc_rel(cid), desc, persist=False)
        if success:
            for name, exp, _des in targets:
                if exp:
                    pool.delete(data_rel(name, exp))
        else:
            # GC desired data files from step 1 (same leak as Committer)
            for name, _exp, des in targets:
                if des != self.slot_version(name):
                    pool.delete(data_rel(name, des))
        return success

    def recover(self) -> Dict[str, int]:
        # markers force a scan of every slot (the cost the WAL-only design
        # avoids); afterwards the descriptor logic is identical
        pool = self.pool
        t0_ns = time.perf_counter_ns()
        with span("wal.recover", committer="marker") as sp, \
                flush_reason("committer", "recover"):
            with span("recover.clear_markers") as clear:
                markers = pool.listdir("markers")
                for fn in markers:
                    pool.delete(f"markers/{fn}")
                clear.set(markers=len(markers))
            with span("recover.replay_ops"):
                for fn in pool.listdir("wal"):
                    desc = pool.read_record(f"wal/{fn}")
                    if desc is None:
                        pool.delete(f"wal/{fn}")
                        continue
                    t = {s: (e, d) for s, e, d in desc["targets"]}
                    for name, (exp, des) in t.items():
                        rec = pool.read_record(_slot_rel(name))
                        if rec is not None and \
                                rec.get("desc") == desc["id"]:
                            ver = des if desc["state"] == ST_SUCCEEDED \
                                else exp
                            pool.write_record(_slot_rel(name),
                                              {"version": ver})
            recovered = {
                fn[:-len('.json')]: self.slot_version(fn[:-len('.json')])
                for fn in pool.listdir("slots")}
            sp.set(slots=len(recovered))
        get_registry().histogram("recover_us", component="committer") \
            .record((time.perf_counter_ns() - t0_ns) / 1e3)
        return recovered
