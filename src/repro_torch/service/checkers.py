"""Service-layer crash checker: the online shard-migration sweep.

The structure-level sweeps live in :mod:`repro_torch.structures.checkers`;
this one needs a whole :class:`KVService` (shard pools + the migration
decision log), so it sits in the service layer — structures must not
import upward.
"""
from __future__ import annotations

import pathlib
from typing import Dict, Union

import torch

from repro_torch.checkpoint import SimulatedCrash
from repro_torch.structures import CrashCheckError, INSERT, KVOp, OK

from .service import KVService


def check_migration_crash_sweep(load: Dict[int, int], root, *,
                                lo: int, hi: int, dst: int,
                                n_shards: int = 3, n_buckets: int = 32,
                                migration_chunk: int = 2,
                                max_doublings: int = 0,
                                max_crash_points: int = 400,
                                device: Union[str, torch.device] = "cuda"
                                ) -> int:
    """Crash-at-every-persist sweep through an online shard migration.

    Builds a durable :class:`repro_torch.service.KVService`, loads
    ``load``, then runs ``migrate_range(lo, hi, dst)`` with a crash trap
    armed on ONE pool at a time — each shard's WAL pool and the
    migration decision-log pool in turn — at every persist ordinal until
    the migration completes untrapped.  After each crash the recovered
    service must satisfy, at every point:

    - ``check_integrity()`` equals the loaded items (a migration moves
      keys, it never creates, loses or tears one — rollback deletes
      half-copied residue, roll-forward redoes cleanup);
    - the route table is all-or-nothing: fully swung ``(lo, hi, dst)``
      or absent, per the ROUTED record — never a half-installed route;
    - the decision log has no pending record;
    - every key still reads its loaded value through routing;
    - a SECOND crash/recover cycle reproduces the identical state
      (recovery is idempotent).

    ``device`` is the service's device (durable shards put nothing on
    it; it is checked like every entry point's).  Returns the total
    number of crash points swept across all pools.
    """
    root = pathlib.Path(root)
    kvops = [KVOp(INSERT, k, v) for k, v in sorted(load.items())]

    def build(run_root):
        svc = KVService(n_shards, backend="durable", n_buckets=n_buckets,
                        max_doublings=max_doublings, durable_root=run_root,
                        migration_chunk=migration_chunk, device=device)
        res = svc.apply(kvops)
        if any(r.status != OK for r in res):
            raise CrashCheckError(
                f"migration sweep load failed: "
                f"{[r.status for r in res if r.status != OK]}")
        return svc, svc.check_integrity()

    def pools_of(svc):
        return [b.pool for b in svc.backends] + [svc.mig_pool]

    swept = 0
    for pool_idx in range(n_shards + 1):
        for crash_at in range(max_crash_points + 1):
            svc, before = build(root / f"p{pool_idx}c{crash_at}")
            pool = pools_of(svc)[pool_idx]
            pool.crash_after = pool.persist_count + crash_at
            crashed = False
            try:
                svc.migrate_range(lo, hi, dst)
            except SimulatedCrash:
                crashed = True
            pool.crash_after = None
            svc2 = svc.crash()
            swept += 1
            tag = f"pool={pool_idx} crash_at={crash_at}"
            items = svc2.check_integrity()
            if items != before:
                raise CrashCheckError(
                    f"{tag}: recovered items diverged from load")
            if svc2.router.ranges not in ([], [(lo, hi, dst)]):
                raise CrashCheckError(
                    f"{tag}: half-installed routes {svc2.router.ranges}")
            if svc2.mig_log.pending():
                raise CrashCheckError(
                    f"{tag}: pending record survived recovery")
            for k, v in load.items():
                got = svc2.lookup(k)
                if got != v:
                    raise CrashCheckError(
                        f"{tag}: key {k} reads {got}, loaded {v}")
            svc3 = svc2.crash()
            if (svc3.check_integrity() != items
                    or svc3.router.ranges != svc2.router.ranges):
                raise CrashCheckError(
                    f"{tag}: second crash/recover changed state")
            if not crashed:
                break           # this pool's persists are fully swept
        else:
            raise CrashCheckError(
                f"pool {pool_idx}: migration never completed within "
                f"{max_crash_points} persists")
    return swept
