"""Shard routing: partitioning the word/key space across backends.

The service owns S backend instances ("shards"); every submitted op must
land on exactly one of them — or be flagged cross-shard and serialized
(``repro_torch.service.scheduler``).  Two address partitions are
supported:

- ``range``:  shard ``addr // words_per_shard`` — contiguous blocks,
  the natural fit for structures occupying contiguous word ranges;
- ``hash``:   shard ``addr % n_shards``, local ``addr // n_shards`` —
  the interleaved (modular) member of the hash family.  Word addresses
  are already uniform integers, so the identity hash keeps the
  global<->local mapping a compact bijection; *key* routing (the KV
  service) uses a real multiplicative hash instead, because keys are
  anything but uniform.

Both are bijections ``global addr <-> (shard, local addr)``, so an op
can be translated into a shard's private address space and back —
each shard backend only ever sees local addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.pmwcas import MwCASOp, Target
from repro_torch.structures import key_shard

# shard id returned for ops whose targets span shards (scheduler routes
# these to the serialized global round)
CROSS_SHARD = -1

_POLICIES = ("range", "hash")


@dataclasses.dataclass(frozen=True)
class RoutedOp:
    """One classified submission: the owning shard (or CROSS_SHARD) and
    the op translated into shard-local address space.  Cross-shard ops
    keep a per-shard breakdown instead of a single local op."""
    op: MwCASOp                          # original, global addresses
    shard: int                           # owning shard or CROSS_SHARD
    local: MwCASOp = None                # shard-local translation
    parts: Dict[int, Tuple[Target, ...]] = None   # cross: shard -> targets

    @property
    def is_cross(self) -> bool:
        return self.shard == CROSS_SHARD


class ShardRouter:
    def __init__(self, n_shards: int, *, words_per_shard: int = 0,
                 policy: str = "range"):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        if policy not in _POLICIES:
            raise ValueError(f"policy {policy!r} not in {_POLICIES}")
        if policy == "range" and words_per_shard < 1:
            raise ValueError("range partition needs words_per_shard >= 1")
        self.n_shards = n_shards
        self.words_per_shard = words_per_shard
        self.policy = policy
        # key-range routing overrides (online shard migration): ordered
        # (lo, hi, shard) rows consulted BEFORE the hash — the in-memory
        # image of the service's persistent route table
        self.ranges: List[Tuple[int, int, int]] = []

    # -- address partition -----------------------------------------------------
    def shard_of_addr(self, addr: int) -> int:
        if addr < 0:
            raise ValueError(f"negative address {addr}")
        if self.words_per_shard and \
                addr >= self.n_shards * self.words_per_shard:
            # array-shaped shards silently drop out-of-range scatters,
            # so an unbounded address would "succeed" writing nothing
            raise ValueError(f"address {addr} beyond shard space "
                             f"({self.n_shards} x "
                             f"{self.words_per_shard} words)")
        if self.policy == "range":
            return addr // self.words_per_shard
        return addr % self.n_shards

    def local(self, addr: int) -> int:
        """Global address -> the owning shard's local word index."""
        self.shard_of_addr(addr)                 # bounds check
        if self.policy == "range":
            return addr % self.words_per_shard
        return addr // self.n_shards

    def global_addr(self, shard: int, local: int) -> int:
        """Inverse of (shard_of_addr, local)."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if self.policy == "range":
            return shard * self.words_per_shard + local
        return local * self.n_shards + shard

    # -- key partition (KV service) --------------------------------------------
    def shard_of_key(self, key: int) -> int:
        """Multiplicative-hash key routing for the KV front (the same
        :func:`repro_torch.structures.key_shard` that ``partition_ops``
        uses, so pre-partitioned workloads land where ops route).
        Range overrides installed by a completed shard migration win
        over the hash."""
        for lo, hi, shard in self.ranges:
            if lo <= key < hi:
                return shard
        return key_shard(key, self.n_shards)

    def hash_shard_of_key(self, key: int) -> int:
        """The pure hash route, ignoring overrides (what the key would
        do with no migrations — recovery uses this to tell a migrated
        copy from a key that natively hashes to its shard)."""
        return key_shard(key, self.n_shards)

    def set_range(self, lo: int, hi: int, shard: int) -> None:
        """Install a key-range override; the newest override wins over
        its whole range, so overlapping older rows are TRIMMED to their
        non-overlapping remainder (a later migration may re-migrate part
        of an earlier one's range).  Idempotent; the caller persists the
        route table (``MigrationLog.save_routes``) — this is only the
        in-memory image."""
        if not lo < hi:
            raise ValueError(f"empty key range [{lo}, {hi})")
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        self.clear_range(lo, hi)
        self.ranges.append((lo, hi, shard))
        self.ranges.sort()

    def clear_range(self, lo: int, hi: int) -> None:
        """Remove [lo, hi) from every override, trimming partial
        overlaps to their remainder."""
        out: List[Tuple[int, int, int]] = []
        for a, b, s in self.ranges:
            if b <= lo or hi <= a:
                out.append((a, b, s))
                continue
            if a < lo:
                out.append((a, lo, s))
            if hi < b:
                out.append((hi, b, s))
        self.ranges = out

    # -- op classification -----------------------------------------------------
    def classify(self, op: MwCASOp) -> RoutedOp:
        """Route one op: single-shard ops get a local translation,
        spanning ops a per-shard breakdown under CROSS_SHARD."""
        by_shard: Dict[int, List[Target]] = {}
        for t in op.targets:
            if not isinstance(t.addr, int):
                raise TypeError(
                    f"service routing needs int word addresses, got "
                    f"{t.addr!r}")
            s = self.shard_of_addr(t.addr)
            by_shard.setdefault(s, []).append(
                Target(self.local(t.addr), t.expected, t.desired))
        if len(by_shard) == 1:
            ((shard, targets),) = by_shard.items()
            return RoutedOp(op=op, shard=shard, local=MwCASOp(targets))
        return RoutedOp(op=op, shard=CROSS_SHARD,
                        parts={s: tuple(ts) for s, ts in by_shard.items()})
