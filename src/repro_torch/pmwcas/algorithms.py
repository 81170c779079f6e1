"""Algorithm variants as strategy objects (paper Section 5's competitors).

The simulator historically selected its state machine with magic strings
("ours", "ours_df", ...).  These strategy objects carry the same selector
plus the paper's analytical properties (Sec. 2.1 instruction counts, GC
and helping requirements) so call sites can reason about a variant
without string comparisons::

    SimSession().with_algorithm(OURS).run()
    OURS.cas_per_op(k=3)        # -> 6, the Sec. 2.1 claim tests assert

``resolve`` accepts either a strategy or the legacy string, so the old
spelling keeps working for one deprecation cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.model import (ALG_ORIGINAL, ALG_OURS, ALG_OURS_DF,
                                    ALG_PCAS)


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """One PMwCAS variant: simulator selector + analytical properties."""
    name: str                    # core.model selector (the kernel's ALG code)
    title: str                   # human-readable label
    dirty_flags: bool            # pays the per-word dirty-flag double flush
    helping: bool                # readers complete foreign ops (needs GC)
    max_k: Optional[int] = None  # None = any width

    # -- paper Sec. 2.1 no-conflict instruction counts ----------------------
    def cas_per_op(self, k: int) -> int:
        """CAS-class events per successful k-word op, zero conflicts."""
        if self.name == ALG_PCAS:
            return 2                      # CAS + atomic clear-store
        if self.name == ALG_ORIGINAL:
            return 4 * k                  # RDCSS + promote + finalize + clear
        return 2 * k                      # reserve + finalize (ours/ours_df)

    def flush_per_op(self, k: int, desc_lines: int = 1) -> Optional[int]:
        """Persist events per successful op, zero conflicts.

        ours: WAL (desc_lines) + installed targets (k) + state (1) +
        finalized targets (k).  Dirty flags add one more flush per target
        (Fig. 4 line 22).  The original algorithm has no closed form here
        (its helper-fused persists depend on interleaving); None.
        """
        if self.name == ALG_PCAS:
            return 1
        if self.name == ALG_ORIGINAL:
            return None
        base = desc_lines + 2 * k + 1
        if self.dirty_flags:
            base += k
        return base

    def supports_k(self, k: int) -> bool:
        return self.max_k is None or k <= self.max_k

    def __str__(self) -> str:  # str(OURS) == "ours": drop-in for cfg fields
        return self.name


OURS = Algorithm(name=ALG_OURS, title="ours (no dirty flags, Sec. 4)",
                 dirty_flags=False, helping=False)
OURS_DF = Algorithm(name=ALG_OURS_DF, title="ours + dirty flags (Sec. 3)",
                    dirty_flags=True, helping=False)
ORIGINAL = Algorithm(name=ALG_ORIGINAL, title="Wang et al. (ICDE'18)",
                     dirty_flags=True, helping=True)
PCAS = Algorithm(name=ALG_PCAS, title="persistent single-word CAS",
                 dirty_flags=True, helping=False, max_k=1)

STRATEGIES = (OURS, OURS_DF, ORIGINAL, PCAS)
_BY_NAME = {a.name: a for a in STRATEGIES}


def resolve(alg: Union[str, Algorithm]) -> Algorithm:
    """Accept a strategy object or a legacy magic string."""
    if isinstance(alg, Algorithm):
        return alg
    try:
        return _BY_NAME[alg]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {alg!r}; expected one of "
            f"{sorted(_BY_NAME)} or an Algorithm strategy") from None
