"""Persistence layer of the port: the file-backed persistent-memory pool,
the descriptor-WAL committer (the paper's PMwCAS without dirty flags:
per-op commit, round-level group commit, epochs, checkpoints, recovery)
and the dirty-flag baseline it is measured against.  The checkpoint
manager is ROADMAP Queue 1 #8."""
from .committer import CommitError, Committer, DurabilityStats, data_rel
from .marker_committer import MarkerCommitter
from .pmem import PMemPool, SimulatedCrash

__all__ = ["CommitError", "Committer", "DurabilityStats", "MarkerCommitter",
           "PMemPool", "SimulatedCrash", "data_rel"]
