"""Canonical PMwCAS operation model shared by every backend.

The paper's single algorithmic object is the *descriptor*: a persisted
record of (address, expected, desired) triples plus a state word, acting
as its own write-ahead log.  This repo executes that object on three very
different substrates — a cycle-accurate many-core simulator, a batched
batched kernel, and a file-granularity durable committer — and this module
defines the one vocabulary all of them accept:

- :class:`Target`      one (addr, expected, desired) triple
- :class:`MwCASOp`     an atomic multi-word compare-and-swap (>=1 targets)
- :class:`Descriptor`  the WAL view of an op (op id + state + targets)
- :class:`OpResult`    per-op verdict returned by a backend

Addresses are ``int`` word indices for the array-shaped backends
(simulator / kernel) and ``str`` slot names for the durable backend; an
``int`` address is mapped to the slot name ``w<addr>`` so the same
``MwCASOp`` batch can run against every backend (the cross-backend
differential test relies on this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

Addr = Union[int, str]

# Descriptor states, shared vocabulary with checkpoint.committer and
# core.model (paper Table 1).
STATE_COMPLETED = "COMPLETED"
STATE_FAILED = "FAILED"
STATE_SUCCEEDED = "SUCCEEDED"
STATE_UNDECIDED = "UNDECIDED"


@dataclasses.dataclass(frozen=True)
class Target:
    """One word of a PMwCAS: CAS ``addr`` from ``expected`` to ``desired``."""
    addr: Addr
    expected: int
    desired: int

    def __post_init__(self):
        if isinstance(self.addr, int) and self.addr < 0:
            raise ValueError(f"negative address {self.addr} (reserved for "
                             "padding in array form)")

    @property
    def slot_name(self) -> str:
        """Slot-name form of the address (durable backend)."""
        return self.addr if isinstance(self.addr, str) else f"w{self.addr}"


@dataclasses.dataclass(frozen=True)
class MwCASOp:
    """An atomic multi-word CAS: all targets move together or none do.

    Targets must not repeat an address (the paper's descriptors embed each
    word once; duplicates would make success ill-defined).  For backends
    that require the paper's canonical embedding order, use
    :meth:`sorted`.
    """
    targets: Tuple[Target, ...]

    def __init__(self, targets: Iterable[Union[Target, Tuple[Addr, int, int]]]):
        tgts = tuple(t if isinstance(t, Target) else Target(*t)
                     for t in targets)
        if not tgts:
            raise ValueError("MwCASOp needs at least one target")
        addrs = [t.addr for t in tgts]
        if len(set(addrs)) != len(addrs):
            raise ValueError(f"duplicate target addresses in {addrs}")
        object.__setattr__(self, "targets", tgts)

    @classmethod
    def of_distinct(cls, targets: Tuple[Target, ...]) -> "MwCASOp":
        """``MwCASOp(targets)`` for ready :class:`Target` objects whose
        addresses the caller guarantees distinct, without checking them
        again (a structure's batch compiler builds thousands a wave)."""
        op = object.__new__(cls)
        object.__setattr__(op, "targets", targets)
        return op

    # -- views ---------------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.targets)

    @property
    def addrs(self) -> Tuple[Addr, ...]:
        return tuple(t.addr for t in self.targets)

    def sorted(self) -> "MwCASOp":
        """Canonical (address-sorted) embedding order — deadlock freedom for
        lock-style reservation (paper Sec. 2.1)."""
        return MwCASOp(tuple(sorted(self.targets, key=lambda t: t.addr)))

    def is_increment(self) -> bool:
        """True when every target moves expected -> expected + 1 (the
        paper's benchmark workload; the only shape the cycle-accurate
        simulator executes natively)."""
        return all(t.desired == t.expected + 1 for t in self.targets)

    # -- constructors --------------------------------------------------------
    @classmethod
    def increment(cls, addrs: Sequence[Addr],
                  current: Sequence[int]) -> "MwCASOp":
        """The benchmark op: CAS each word from its current value to +1."""
        return cls(tuple(Target(a, int(c), int(c) + 1)
                         for a, c in zip(addrs, current)))


@dataclasses.dataclass
class Descriptor:
    """Write-ahead-log view of an op.

    ``DurableBackend`` derives its commit targets from
    :meth:`slot_targets`; the committer then persists an equivalent
    record (same id / state vocabulary / targets list) under ``wal/``.
    The simulator holds the same information in its ``d_*`` arrays; the
    kernel never materializes it (one batch = one implicit generation of
    descriptors, index order = linearization).
    """
    op_id: str
    op: MwCASOp
    state: str = STATE_FAILED

    def slot_targets(self) -> List[Tuple[str, int, int]]:
        """(slot, expected, desired) triples in committer wire format."""
        return [(t.slot_name, t.expected, t.desired)
                for t in self.op.targets]

    def as_record(self) -> Dict:
        return {"id": self.op_id, "state": self.state,
                "targets": [list(t) for t in self.slot_targets()]}


@dataclasses.dataclass(frozen=True)
class OpResult:
    """Per-op verdict from one backend execution."""
    index: int                 # position in the submitted batch
    success: bool
    backend: str               # backend.name that produced the verdict
    op: MwCASOp

    def __bool__(self) -> bool:  # `if result:` reads naturally
        return self.success


# ---------------------------------------------------------------------------
# Array bridging (simulator / kernel backends)
# ---------------------------------------------------------------------------

def batch_width(ops: Sequence[MwCASOp]) -> int:
    return max(op.k for op in ops)


def ops_to_arrays(ops: Sequence[MwCASOp], k: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a batch into (addr int32[B,K] with -1 padding, exp, des uint32).

    This is the wire format of ``repro_torch.pmwcas.KernelBackend`` (and of the
    underlying CUDA kernel, as int32 bit patterns).  Addresses must be ints.
    """
    if not ops:
        raise ValueError("empty batch")
    K = k or batch_width(ops)
    B = len(ops)
    addr = np.full((B, K), -1, np.int32)
    exp = np.zeros((B, K), np.uint32)
    des = np.zeros((B, K), np.uint32)
    for i, op in enumerate(ops):
        if op.k > K:
            raise ValueError(f"op {i} has {op.k} targets > batch width {K}")
        for j, t in enumerate(op.targets):
            if not isinstance(t.addr, int):
                raise TypeError(
                    f"op {i} target {j} has non-int address {t.addr!r}; "
                    "array backends need word indices")
            addr[i, j] = t.addr
            exp[i, j] = t.expected
            des[i, j] = t.desired
    return addr, exp, des


def ops_from_arrays(addr, exp, des) -> List[MwCASOp]:
    """Inverse of :func:`ops_to_arrays` (drops padded slots)."""
    addr, exp, des = (np.asarray(x) for x in (addr, exp, des))
    ops = []
    for i in range(addr.shape[0]):
        tgts = [Target(int(a), int(e), int(d))
                for a, e, d in zip(addr[i], exp[i], des[i]) if a >= 0]
        ops.append(MwCASOp(tgts))
    return ops


def results_from_mask(ops: Sequence[MwCASOp], mask, backend: str
                      ) -> List[OpResult]:
    mask = np.asarray(mask)
    return [OpResult(index=i, success=bool(mask[i]), backend=backend, op=op)
            for i, op in enumerate(ops)]
