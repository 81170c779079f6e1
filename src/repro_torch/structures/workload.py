"""YCSB-style workload compiler for the structures layer.

Turns an abstract (mix, skew, size) spec into the hash map's logical-op
vocabulary (:class:`repro_torch.structures.KVOp`), batches it into rounds, and
exposes the kernel wire form (``ops_to_arrays``) of any round — the same
Zipfian-popularity machinery the simulator benchmark uses
(``generate_ops`` / paper Eq. 1), applied to keys instead of raw words.

Standard mixes are provided as :data:`YCSB_A` (50/50 read/update),
:data:`YCSB_B` (95/5), :data:`YCSB_C` (read-only), :data:`YCSB_E`
(scan-heavy — the range-index workload the multi-node tree exists for)
and an insert-heavy :data:`LOAD` phase, each a :class:`WorkloadSpec`
template to fork with ``dataclasses.replace``.

The compiled stream is structure-agnostic: the same :class:`KVOp` list
drives :class:`repro_torch.structures.HashMap` (``run_workload`` accepts
anything with the ``apply``/counter surface).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.model import zipf_probs
from repro_torch.pmwcas import MwCASOp, ops_to_arrays

from .hashmap import DELETE, INSERT, KVOp, READ, SCAN, UPDATE


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Operation mix + skew + size; fractions must sum to 1."""
    n_ops: int = 256
    n_keys: int = 64               # key universe (keys are 1..n_keys)
    read: float = 0.5
    update: float = 0.25
    insert: float = 0.2
    delete: float = 0.05
    scan: float = 0.0
    alpha: float = 0.0             # Zipf skew of key popularity (Eq. 1)
    seed: int = 0
    batch: int = 16                # logical ops submitted per apply()

    def __post_init__(self):
        total = self.read + self.update + self.insert + self.delete \
            + self.scan
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"mix fractions sum to {total}, need 1.0")
        if self.batch < 1 or self.n_ops < 1 or self.n_keys < 1:
            raise ValueError("n_ops, n_keys and batch must be positive")


# The classic YCSB templates (fork with dataclasses.replace)
YCSB_A = WorkloadSpec(read=0.5, update=0.5, insert=0.0, delete=0.0)
YCSB_B = WorkloadSpec(read=0.95, update=0.05, insert=0.0, delete=0.0)
YCSB_C = WorkloadSpec(read=1.0, update=0.0, insert=0.0, delete=0.0)
YCSB_E = WorkloadSpec(read=0.0, update=0.0, insert=0.05, delete=0.0,
                      scan=0.95)
LOAD = WorkloadSpec(read=0.0, update=0.0, insert=1.0, delete=0.0)


def compile_workload(spec: WorkloadSpec) -> List[KVOp]:
    """Deterministic logical-op stream: kinds by mix, keys by Zipf rank
    (rank -> key through a seeded permutation, as in ``generate_ops``)."""
    rng = np.random.default_rng(spec.seed)
    p = zipf_probs(spec.n_keys, spec.alpha)
    perm = rng.permutation(spec.n_keys)
    kinds = rng.choice(
        [READ, UPDATE, INSERT, DELETE, SCAN], size=spec.n_ops,
        p=[spec.read, spec.update, spec.insert, spec.delete, spec.scan])
    ranks = rng.choice(spec.n_keys, size=spec.n_ops, p=p)
    values = rng.integers(1, 1 << 20, size=spec.n_ops)
    return [KVOp(kind=str(kind), key=int(perm[rank]) + 1, value=int(val))
            for kind, rank, val in zip(kinds, ranks, values)]


def load_phase(spec: WorkloadSpec, fraction: float = 0.5) -> List[KVOp]:
    """Pre-populate ops: insert a deterministic ``fraction`` of the key
    universe (so read/update/delete mixes have something to hit)."""
    rng = np.random.default_rng(spec.seed + 0xB00)
    n = max(1, int(spec.n_keys * fraction))
    keys = rng.permutation(spec.n_keys)[:n]
    vals = rng.integers(1, 1 << 20, size=n)
    return [KVOp(INSERT, int(k) + 1, int(v)) for k, v in zip(keys, vals)]


def batches(ops: Sequence[KVOp], batch: int) -> Iterator[List[KVOp]]:
    for i in range(0, len(ops), batch):
        yield list(ops[i:i + batch])


def client_streams(spec: WorkloadSpec, n_clients: int) -> List[List[KVOp]]:
    """Split one workload spec into ``n_clients`` deterministic per-client
    op streams (client i draws from the same mix/skew with seed
    ``spec.seed + i`` and ``n_ops // n_clients`` ops) — the many-client
    arrival shape the sharded service layer multiplexes.  All clients
    share one key universe, so Zipf-hot keys contend across clients."""
    if n_clients < 1:
        raise ValueError("need at least one client")
    per = max(1, spec.n_ops // n_clients)
    return [compile_workload(dataclasses.replace(spec, n_ops=per,
                                                 seed=spec.seed + i))
            for i in range(n_clients)]


def interleave(streams: Sequence[Sequence[KVOp]]) -> List[KVOp]:
    """Round-robin merge of per-client streams into one arrival order."""
    out: List[KVOp] = []
    for i in range(max((len(s) for s in streams), default=0)):
        for s in streams:
            if i < len(s):
                out.append(s[i])
    return out


def key_shard(key: int, n_parts: int) -> int:
    """Multiplicative-hash (Knuth) key partition — the ONE definition
    shared by :func:`partition_ops` and the service's
    ``ShardRouter.shard_of_key``, so a partitioned workload provably
    lands on the shards the service would route it to."""
    return (key * 2654435761 % (1 << 32)) % n_parts


def partition_ops(ops: Sequence[KVOp], n_parts: int,
                  part_of=None) -> List[List[KVOp]]:
    """Partition a logical op stream (order-preserving within a part).
    ``part_of(op) -> int`` defaults to :func:`key_shard`, the service
    router's key hash."""
    if part_of is None:
        def part_of(op):
            return key_shard(op.key, n_parts)
    parts: List[List[KVOp]] = [[] for _ in range(n_parts)]
    for op in ops:
        parts[part_of(op)].append(op)
    return parts


@dataclasses.dataclass
class WorkloadStats:
    """Aggregate outcome of a workload run against one HashMap."""
    n_ops: int = 0
    rounds: int = 0                # backend batches executed
    mwcas_submitted: int = 0
    mwcas_won: int = 0
    by_status: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def retries_per_op(self) -> float:
        extra = self.mwcas_submitted - self.mwcas_won
        return extra / self.n_ops if self.n_ops else 0.0

    @property
    def cas_ops_per_op(self) -> float:
        return self.mwcas_submitted / self.n_ops if self.n_ops else 0.0


def run_workload(struct, spec: WorkloadSpec,
                 ops: Optional[Sequence[KVOp]] = None) -> WorkloadStats:
    """Drive a compiled workload through a structure in ``spec.batch``-
    sized rounds of the lock-free retry loop.  ``struct`` is any
    structure with the HashMap execution surface (``apply`` +
    ``rounds_run``/``mwcas_*`` counters) — :class:`HashMap` or
    :class:`BzTreeIndex`."""
    ops = compile_workload(spec) if ops is None else list(ops)
    stats = WorkloadStats(n_ops=len(ops))
    r0, s0, w0 = struct.rounds_run, struct.mwcas_submitted, struct.mwcas_won
    for chunk in batches(ops, spec.batch):
        for res in struct.apply(chunk):
            stats.by_status[res.status] = \
                stats.by_status.get(res.status, 0) + 1
    stats.rounds = struct.rounds_run - r0
    stats.mwcas_submitted = struct.mwcas_submitted - s0
    stats.mwcas_won = struct.mwcas_won - w0
    return stats


def kernel_round_arrays(struct, ops: Sequence[KVOp]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   List[MwCASOp]]:
    """Compile one round against the current snapshot and return its
    kernel wire form ``(addr int32[B,K] with -1 padding, exp, des)`` —
    the hand-off point between the structure layer and the batched
    kernel.  Works for any snapshot-compiling structure (``HashMap``,
    ``BzTreeIndex``); immediate results and split requests compile to no
    CAS and are dropped from the wire form."""
    snap = struct.snapshot()
    compiled = [struct.compile_op(op, snap) for op in ops]
    mwcas = [c for c in compiled if isinstance(c, MwCASOp)]
    if not mwcas:
        raise ValueError("round compiles to no CAS work (all reads?)")
    addr, exp, des = ops_to_arrays(mwcas)
    return addr, exp, des, mwcas
