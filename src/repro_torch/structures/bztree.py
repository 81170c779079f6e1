"""BzTree-style sorted-array node on the unified PMwCAS API.

One node = a metadata word plus a fixed array of key slots::

    word base           meta  = count | (FROZEN_BIT if frozen)
    word base + 1 + i   slot i (0 = unused; keys are appended in arrival
                        order, sorted on read — the BzTree recipe)

Mutations are single MwCAS ops, exactly the PMwCAS-mediated protocol of
Wang et al.'s BzTree transferred onto this repo's batch semantics:

- **insert**: one 2-word op ``[(meta, m, m+1), (slot[count], 0, key)]``.
  The meta word is simultaneously the reservation (the op claims slot
  ``count`` by incrementing the count) and the visibility switch (the
  key is only in-bounds once the count moved) — a torn insert is
  impossible because both words move atomically.  Note the meta target
  is literally increment-shaped, so node inserts shadow directly onto
  the simulator's benchmark workload.
- **freeze**: one 1-word op setting FROZEN_BIT; any in-flight insert
  compiled against the unfrozen meta loses its CAS (meta changed).
- **split**: freeze, then write BOTH half nodes with ONE wide MwCAS
  (all-or-nothing: no crash can leave one half visible), then the caller
  atomically swings a parent pointer with :func:`swap_pointer`.

A frozen node is immutable forever — readers passing through a stale
pointer still see a consistent (frozen) array, the BzTree argument for
why pointer installation can be a separate, later CAS.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.pmwcas import Backend, MwCASOp

FROZEN_BIT = 1 << 31
COUNT_MASK = FROZEN_BIT - 1

# insert statuses (strings shared in spirit with hashmap)
NODE_OK = "ok"
NODE_FULL = "full"
NODE_FROZEN = "frozen"
NODE_EXISTS = "exists"
NODE_EXHAUSTED = "exhausted"


class SplitError(RuntimeError):
    """The target region for a split half was not zeroed / got claimed."""


class SortedNode:
    """Fixed-capacity sorted-array node; all state lives in the backend."""

    def __init__(self, backend: Backend, base: int, capacity: int):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (split needs two halves)")
        self.backend = backend
        self.base = base
        self.capacity = capacity

    # -- layout ----------------------------------------------------------------
    @property
    def meta_addr(self) -> int:
        return self.base

    def slot_addr(self, i: int) -> int:
        return self.base + 1 + i

    @property
    def n_words(self) -> int:
        return 1 + self.capacity

    # -- reads -----------------------------------------------------------------
    def meta(self) -> int:
        return int(self.backend.read(self.meta_addr))

    @property
    def count(self) -> int:
        return self.meta() & COUNT_MASK

    @property
    def frozen(self) -> bool:
        return bool(self.meta() & FROZEN_BIT)

    def _slots_upto(self, n: int) -> List[int]:
        return [int(self.backend.read(self.slot_addr(i))) for i in range(n)]

    def raw_slots(self) -> List[int]:
        """Slots 0..count-1 in arrival (append) order."""
        return self._slots_upto(self.count)

    def keys(self) -> List[int]:
        """The sorted view (BzTree sorts the append area on read)."""
        return sorted(self.raw_slots())

    def search(self, key: int) -> bool:
        return key in self.raw_slots()

    # -- mutations -------------------------------------------------------------
    def compile_insert(self, key: int, meta: Optional[int] = None,
                       slots: Optional[List[int]] = None):
        """One insert -> one 2-word MwCASOp against the current meta.

        ``meta``/``slots`` let a round compile many inserts against one
        node snapshot (the HashMap.apply pattern — no per-op re-reads).
        Returns a status string instead when no op is needed/possible.
        """
        if not 0 < key < (1 << 31):
            raise ValueError(f"key {key} outside (0, 2^31)")
        m = self.meta() if meta is None else meta
        if m & FROZEN_BIT:
            return NODE_FROZEN
        count = m & COUNT_MASK
        if count >= self.capacity:
            return NODE_FULL
        if key in (self._slots_upto(count) if slots is None else slots):
            return NODE_EXISTS
        return MwCASOp([(self.meta_addr, m, m + 1),
                        (self.slot_addr(count), 0, key)])

    def insert(self, key: int, max_attempts: int = 8) -> str:
        """Lock-free insert: retry the 2-word CAS until a verdict."""
        for _ in range(max_attempts):
            compiled = self.compile_insert(key)
            if isinstance(compiled, str):
                return compiled
            (res,) = self.backend.execute([compiled])
            if res.success:
                return NODE_OK
        return NODE_EXHAUSTED

    def insert_batch(self, keys: List[int],
                     max_rounds: Optional[int] = None) -> List[str]:
        """Concurrent inserts into ONE node serialize: every round all
        pending ops target the same (meta, next-slot) pair, so exactly
        one wins per round — multi-node workloads are where node inserts
        parallelize.  Returns one status per key."""
        max_rounds = len(keys) + 1 if max_rounds is None else max_rounds
        status: List[Optional[str]] = [None] * len(keys)
        pending = list(range(len(keys)))
        for _ in range(max_rounds):
            if not pending:
                break
            m = self.meta()
            slots = self._slots_upto(m & COUNT_MASK)   # one read per round
            batch, owners, still = [], [], []
            for idx in pending:
                compiled = self.compile_insert(keys[idx], meta=m,
                                               slots=slots)
                if isinstance(compiled, str):
                    status[idx] = compiled
                else:
                    batch.append(compiled)
                    owners.append(idx)
            if not batch:
                pending = []
                break
            verdicts = self.backend.execute(batch)
            for pos, idx in enumerate(owners):
                if verdicts[pos].success:
                    status[idx] = NODE_OK
                else:
                    still.append(idx)
            pending = still
        for idx in pending:
            status[idx] = NODE_EXHAUSTED
        return status                      # type: ignore[return-value]

    def freeze(self, max_attempts: int = 8) -> int:
        """Set FROZEN_BIT (idempotent); returns the frozen meta word."""
        for _ in range(max_attempts):
            m = self.meta()
            if m & FROZEN_BIT:
                return m
            (res,) = self.backend.execute(
                [MwCASOp([(self.meta_addr, m, m | FROZEN_BIT)])])
            if res.success:
                return m | FROZEN_BIT
        raise RuntimeError("freeze lost its CAS repeatedly")

    def _node_image(self, base: int, keys: List[int]) -> List:
        targets = [(base, 0, len(keys))]
        targets += [(base + 1 + i, 0, k) for i, k in enumerate(keys)]
        return targets

    def split(self, left_base: int, right_base: int, *,
              extra_targets: Sequence[Tuple[int, int, int]] = ()
              ) -> Tuple["SortedNode", "SortedNode", int]:
        """Freeze, then materialize both halves with ONE wide MwCAS.

        The target regions must be zeroed, unclaimed words (use an
        allocator).  Returns (left, right, separator) where every key in
        ``right`` is >= separator.  The single wide op is the crash
        argument: either both halves exist completely or neither does,
        and the frozen original stays valid throughout.

        ``extra_targets`` are folded into the same wide MwCAS — the
        multi-node tree uses this to pre-publish its parent entry
        (separator + right-child words at an invisible append position)
        atomically with the half images (DESIGN.md Sec. 7).
        """
        self.freeze()
        ks = self.keys()
        if len(ks) < 2:
            raise SplitError("need >= 2 keys to split")
        mid = len(ks) // 2
        left_keys, right_keys = ks[:mid], ks[mid:]
        targets = (self._node_image(left_base, left_keys)
                   + self._node_image(right_base, right_keys)
                   + [tuple(t) for t in extra_targets])
        # canonical (address-sorted) embedding order: extra_targets may
        # sit below the half regions, and the simulator shadow replays
        # growth rounds verbatim
        (res,) = self.backend.execute([MwCASOp(targets).sorted()])
        if not res.success:
            raise SplitError(
                "split target region was not zeroed or is contended")
        return (type(self)(self.backend, left_base, self.capacity),
                type(self)(self.backend, right_base, self.capacity),
                right_keys[0])


def swap_pointer(backend: Backend, ptr_addr: int,
                 old_base: int, new_base: int) -> bool:
    """Atomically swing a node pointer word (split/consolidate install)."""
    (res,) = backend.execute([MwCASOp([(ptr_addr, old_base, new_base)])])
    return res.success


def read_pointer(backend: Backend, ptr_addr: int) -> int:
    return int(backend.read(ptr_addr))
