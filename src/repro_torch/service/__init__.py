"""repro_torch.service — sharded, batched PMwCAS execution for many clients.

- :class:`ShardRouter` — partitions the word space into S shards, plus
  multiplicative-hash key routing for the KV front.
- :class:`BatchScheduler` — the raw-op layer: clients ``submit``
  :class:`repro_torch.pmwcas.MwCASOp`\\ s and get :class:`OpFuture`\\ s;
  queued ops coalesce into conflict-free per-shard rounds (duplicate-
  target ops are DEFERRED to the next round), all shard rounds execute
  in one wave, and cross-shard ops run in a serialized global round
  (journaled when shards are durable, so no crash can half-apply one).
- :class:`StackedKernelExecutor` — kernel shards' rounds stacked into
  ONE launch of the Hopper MwCAS kernel: S rounds, one launch.
- :class:`KVService` — the structures front: per-shard
  :class:`repro_torch.structures.HashMap` / ``BzTreeIndex`` partitions,
  logical :class:`repro_torch.structures.KVOp` submissions compiled per
  snapshot and retried across waves, split/GC protocols and online
  key-range migration included; :func:`load_word_tables` installs word
  tables taken from another run.
- :func:`check_migration_crash_sweep` — crash at every persist of an
  online shard migration.
- :class:`ServiceStats` — per-shard round counts, batch occupancy,
  defer/conflict rates, p50/p99 op latency.
"""
from .checkers import check_migration_crash_sweep
from .executor import (DispatchStats, SerialShardExecutor,
                       StackedKernelExecutor, build_rounds, execute_wave,
                       schedule_wave, select_executor)
from .journal import (CrossShardJournal, MIG_COMPLETED, MIG_MIGRATING,
                      MIG_ROUTED, MigrationLog)
from .router import CROSS_SHARD, RoutedOp, ShardRouter
from .scheduler import BatchScheduler, OpFuture, ServiceError
from .service import KVFuture, KVService, load_word_tables
from .stats import (ServiceStats, ShardStats, collect_durability,
                    fresh_stats)

__all__ = [
    "ShardRouter", "RoutedOp", "CROSS_SHARD",
    "BatchScheduler", "OpFuture", "ServiceError",
    "KVService", "KVFuture", "load_word_tables",
    "SerialShardExecutor", "StackedKernelExecutor", "DispatchStats",
    "build_rounds", "schedule_wave", "execute_wave", "select_executor",
    "CrossShardJournal",
    "MigrationLog", "MIG_MIGRATING", "MIG_ROUTED", "MIG_COMPLETED",
    "check_migration_crash_sweep",
    "ServiceStats", "ShardStats", "collect_durability", "fresh_stats",
]
