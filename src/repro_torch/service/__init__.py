"""repro_torch.service — sharded, batched PMwCAS execution for many clients.

- :class:`ShardRouter` — partitions the word space into S shards, plus
  multiplicative-hash key routing for the KV front.
- :class:`StackedKernelExecutor` — kernel shards' rounds stacked into
  ONE launch of the Hopper MwCAS kernel: S rounds, one launch.
- :class:`KVService` — the structures front: per-shard
  :class:`repro_torch.structures.HashMap` partitions, logical
  :class:`repro_torch.structures.KVOp` submissions compiled per snapshot
  and retried across waves, online key-range migration included;
  :func:`load_word_tables` installs word tables taken from another run.
- :class:`ServiceStats` — per-shard round counts, batch occupancy,
  defer/conflict rates, p50/p99 op latency.

The raw-op ``BatchScheduler`` with its cross-shard journal rounds and
the migration crash checker are later slices (ROADMAP Queue 1 #5).
"""
from .executor import (DispatchStats, SerialShardExecutor,
                       StackedKernelExecutor, build_rounds, execute_wave,
                       schedule_wave, select_executor)
from .journal import (CrossShardJournal, MIG_COMPLETED, MIG_MIGRATING,
                      MIG_ROUTED, MigrationLog)
from .router import CROSS_SHARD, RoutedOp, ShardRouter
from .service import KVFuture, KVService, load_word_tables
from .stats import (ServiceStats, ShardStats, collect_durability,
                    fresh_stats)

__all__ = [
    "ShardRouter", "RoutedOp", "CROSS_SHARD",
    "KVService", "KVFuture", "load_word_tables",
    "SerialShardExecutor", "StackedKernelExecutor", "DispatchStats",
    "build_rounds", "schedule_wave", "execute_wave", "select_executor",
    "CrossShardJournal",
    "MigrationLog", "MIG_MIGRATING", "MIG_ROUTED", "MIG_COMPLETED",
    "ServiceStats", "ShardStats", "collect_durability", "fresh_stats",
]
