"""repro_torch.structures — the lock-free persistent hash map on PMwCAS.

The port's first structure, built only on the public
``repro_torch.pmwcas`` surface like its reference:

- :class:`HashMap` — open-addressing map with directory doubling;
  insert/update/delete each compile to ONE 2-word MwCAS (key word +
  value word), 3-5 words while a doubling is in flight.
- workload compiler — YCSB-style mixes with Zipfian key popularity,
  compiled to the logical-op vocabulary the service consumes.
- checkers — the durable crash-at-every-persist sweeps of the map
  (:func:`check_durable_crash_sweep`, :func:`check_hashmap_resize_sweep`
  through directory doubling).

The BzTree node and index with its tree sweep, the free-list allocator
and the structure differential are ROADMAP Queue 1 #4; the simulator
sweep is Queue 1 #7.
"""
from .checkers import (CrashCheckError, check_durable_crash_sweep,
                       check_hashmap_resize_sweep, check_sim_crash_sweep,
                       check_tree_crash_sweep, replay_effects)
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
    # workload
    "WorkloadSpec", "WorkloadStats", "YCSB_A", "YCSB_B", "YCSB_C", "YCSB_E",
    "LOAD",
    "compile_workload", "load_phase", "batches", "run_workload",
    "kernel_round_arrays", "client_streams", "interleave", "key_shard",
    "partition_ops",
    # checkers
    "check_durable_crash_sweep", "check_hashmap_resize_sweep",
    "check_tree_crash_sweep", "check_sim_crash_sweep", "replay_effects",
    "CrashCheckError",
]
