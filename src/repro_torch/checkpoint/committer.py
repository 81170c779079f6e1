"""Committer flush accounting.  The descriptor-WAL committer itself
(group commit, epochs, checkpoints, recovery) is ROADMAP Queue 1 #3;
this slice carries only the stats dataclass the service layer merges."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class DurabilityStats:
    """Flush accounting for the commit paths (the paper's fewer-flushes
    lever, measured): how many persists were actually issued, how many
    the per-op protocol would have issued for the same commits, and how
    many commit fences (round-record persists) were paid."""
    flushes_issued: int = 0    # persists actually issued by commit paths
    flushes_saved: int = 0     # per-op-protocol persists coalesced away
    fences: int = 0            # round/epoch-record commit fences
    round_commits: int = 0     # commit_round calls that committed >= 1 op
    op_commits: int = 0        # per-op commit() calls
    ops_committed: int = 0     # ops that reached their linearization point
    epochs_closed: int = 0     # epoch records persisted (sync barriers)
    checkpoints: int = 0       # checkpoint images persisted
    dep_fences: int = 0        # epoch closes forced by a read-after-write

    def merge(self, other: "DurabilityStats") -> "DurabilityStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_row(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @property
    def flushes_per_commit(self) -> float:
        return (self.flushes_issued / self.ops_committed
                if self.ops_committed else 0.0)
