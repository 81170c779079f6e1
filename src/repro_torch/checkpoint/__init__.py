"""Persistence layer of the port: the file-backed persistent-memory pool,
the descriptor-WAL committer (the paper's PMwCAS without dirty flags:
per-op commit, round-level group commit, epochs, checkpoints, recovery)
the dirty-flag baseline it is measured against, and the training-state
checkpoint managers built on the committer."""
from .committer import CommitError, Committer, DurabilityStats, data_rel
from .manager import AsyncCheckpointManager, CheckpointManager
from .marker_committer import MarkerCommitter
from .pmem import PMemPool, SimulatedCrash

__all__ = ["AsyncCheckpointManager", "CheckpointManager", "CommitError",
           "Committer", "DurabilityStats", "MarkerCommitter", "PMemPool",
           "SimulatedCrash", "data_rel"]
