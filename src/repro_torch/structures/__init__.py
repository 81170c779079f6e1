"""repro_torch.structures — lock-free persistent data structures on PMwCAS.

The paper's closing claim is that a practical PMwCAS enables lock-free
persistent data structures; this package is that claim made executable.
Every structure is implemented ONLY against the public
``repro_torch.pmwcas`` surface (``MwCASOp`` + the ``Backend`` protocol),
so each one runs unchanged on the batched kernel backend (the
hand-written Hopper kernel on a CUDA table, its plain PyTorch version on
a CPU one) and on the durable descriptor-WAL committer:

- :class:`HashMap` — open-addressing map with directory doubling;
  insert/update/delete each compile to ONE 2-word MwCAS (key word +
  value word), 3-5 words while a doubling is in flight.
- :class:`SortedNode` — BzTree-style sorted-array node; insert is a
  2-word MwCAS (meta + slot), split freezes then materializes both
  halves with ONE wide MwCAS.
- :class:`BzTreeIndex` — the multi-node payoff: a BzTree of
  :class:`LeafNode` KV leaves under separator-routing inner nodes;
  every split (leaf, inner, root) is the one-wide-MwCAS materialization
  plus a 2-word install (DESIGN.md Sec. 7).
- :class:`FreeListAllocator` — atomic K-slot reservation layered on
  ``reserve_slots``; its free bitmap lives on an explicit device.
- workload compiler — YCSB-style mixes with Zipfian key popularity
  (A/B/C plus the scan-heavy E for the range index), compiled to the
  shared logical-op vocabulary.
- checkers + differential — the durable crash-at-every-persist sweeps
  (map, elastic map, tree), the simulator's micro-op crash sweep
  (:func:`check_sim_crash_sweep`, its crash points in one launch) and
  :func:`run_struct_differential`, kernel against durable for whole
  logical workloads with every round replayed on the simulator.
"""
from .bztree import (COUNT_MASK, FROZEN_BIT, NODE_EXHAUSTED, NODE_EXISTS,
                     NODE_FROZEN, NODE_FULL, NODE_OK, SortedNode, SplitError,
                     read_pointer, swap_pointer)
from .bztree_index import (BzTreeIndex, INNER_BIT, LEAF_DEAD, LeafNode,
                           NeedsSplit)
from .checkers import (CrashCheckError, check_durable_crash_sweep,
                       check_hashmap_resize_sweep, check_sim_crash_sweep,
                       check_tree_crash_sweep, replay_effects)
from .differential import (StructDifferentialReport, conservative_verdicts,
                           replay_rounds, run_struct_differential,
                           shadow_batch, winner_blocking_verdicts)
from .freelist import DoubleFree, FreeListAllocator, OutOfRegions
from .hashmap import (DELETE, EMPTY, EXHAUSTED, EXISTS, FULL, HashMap,
                      INSERT, KVOp, MIG_BIT, NOT_FOUND, NeedsResize, OK,
                      READ, RoundTrace, SCAN, StructResult, TOMBSTONE,
                      TornStructure, UPDATE)
from .workload import (LOAD, WorkloadSpec, WorkloadStats, YCSB_A, YCSB_B,
                       YCSB_C, YCSB_E, batches, client_streams,
                       compile_workload, interleave, kernel_round_arrays,
                       key_shard, load_phase, partition_ops, run_workload)

__all__ = [
    # hash map
    "HashMap", "KVOp", "StructResult", "RoundTrace", "TornStructure",
    "NeedsResize", "EMPTY", "TOMBSTONE", "MIG_BIT",
    "READ", "INSERT", "UPDATE", "DELETE", "SCAN",
    "OK", "EXISTS", "NOT_FOUND", "FULL", "EXHAUSTED",
    # bztree node
    "SortedNode", "SplitError", "swap_pointer", "read_pointer",
    "FROZEN_BIT", "COUNT_MASK",
    "NODE_OK", "NODE_FULL", "NODE_FROZEN", "NODE_EXISTS", "NODE_EXHAUSTED",
    # multi-node tree
    "BzTreeIndex", "LeafNode", "LEAF_DEAD", "NeedsSplit", "INNER_BIT",
    # allocator
    "FreeListAllocator", "DoubleFree", "OutOfRegions",
    # workload
    "WorkloadSpec", "WorkloadStats", "YCSB_A", "YCSB_B", "YCSB_C", "YCSB_E",
    "LOAD",
    "compile_workload", "load_phase", "batches", "run_workload",
    "kernel_round_arrays", "client_streams", "interleave", "key_shard",
    "partition_ops",
    # checkers + differential
    "check_durable_crash_sweep", "check_sim_crash_sweep",
    "check_tree_crash_sweep", "check_hashmap_resize_sweep",
    "replay_effects",
    "CrashCheckError",
    "run_struct_differential", "StructDifferentialReport",
    "conservative_verdicts", "winner_blocking_verdicts", "shadow_batch",
    "replay_rounds",
]
