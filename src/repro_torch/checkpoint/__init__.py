"""Persistence layer of the port: the file-backed persistent-memory pool
(the migration log's medium) and the committer's flush accounting.  The
committers and the checkpoint manager are ROADMAP Queue 1 #3 and #8."""
from .committer import DurabilityStats
from .pmem import PMemPool, SimulatedCrash

__all__ = ["DurabilityStats", "PMemPool", "SimulatedCrash"]
