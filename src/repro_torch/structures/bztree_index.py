r"""Multi-level BzTree index on the unified PMwCAS API (DESIGN.md Sec. 7, 12).

The first true multi-node structure in the repo, grown from two fixed
levels to unbounded height: inner nodes routing by separator keys over
a row of KV leaves, every building block taken from the existing
structures layer —

- leaves are :class:`LeafNode`, a :class:`~repro_torch.structures.SortedNode`
  with a parallel value array (insert is one 3-word MwCAS, update/delete
  one 2-word meta-guarded MwCAS);
- inner nodes are SortedNode-shaped: separator/child entries are
  appended in arrival order and sorted on read, so publishing an entry
  is a count bump — the same visibility switch the leaf insert uses;
- node regions are carved out of :class:`FreeListAllocator`;
- EVERY split — leaf, inner, and root — is the same two-round protocol:
  freeze, ONE wide MwCAS materializing the replacement out-of-place,
  ONE small MwCAS swinging a routing word.

Word layout (all state lives in the backend, as with every structure)::

    base          super   = base of the current root node (0 = empty)
    base + 1      pending = new-root base of an in-flight root split
    base + 2 ...  node regions (FreeListAllocator), region_words each

    leaf:  L             meta  = arrival count | FROZEN_BIT
           L + 1 + i     key slot i
           L + 1 + C + i value slot i   (LEAF_DEAD = deleted)
    inner: N             meta  = entry count | INNER_BIT | FROZEN_BIT
           N + 1         ptr0  = leftmost child (keys < every separator)
           N + 2 + 2i    sep[i]   \  appended in arrival order,
           N + 3 + 2i    child[i] /  sorted by separator on read

**Split = exactly two MwCAS rounds** (the DESIGN Sec. 7 argument, now
uniform across levels):

1. freeze the node (1-word), then ONE wide MwCAS materializes both half
   images out-of-place AND pre-publishes the install handle — for a
   non-root split the (separator, right child) pre-entry at the parent's
   *append position* ``n`` (invisible: parent count still ``n``); for a
   ROOT split the entire new 1-entry root image plus the ``pending``
   word (invisible: ``super`` still points at the frozen old root).
2. ONE small MwCAS swings routing: non-root, a 2-word op bumps the
   parent count ``n -> n+1`` while the old child's routing pointer
   swings to the left half; root, a 2-word op swings ``super`` to the
   new root while clearing ``pending``.  This is the linearization
   point of the split.

A crash between the rounds leaves a frozen node whose routing is
unchanged — the pre-split tree, fully readable.  The next mutation that
lands under the frozen node *completes* the pending split from
persisted state alone (the parent pre-entry or the ``pending`` word;
the left half base is derivable because halves are materialized
adjacently inside one allocator region), which is why no split ever
needs a third round or an auxiliary log.  When a full node's parent is
itself full, growth recurses upward one region at a time — each
``ensure_room`` call performs exactly one two-round growth step, so
every crash window is one of the two windows argued above.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Dict, Iterator, List, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.pmwcas import Backend, MwCASOp, Target

from .bztree import FROZEN_BIT, SortedNode, SplitError
from .freelist import FreeListAllocator, OutOfRegions
from .hashmap import (EXHAUSTED, EXISTS, FULL, INSERT, KVOp, NOT_FOUND, OK,
                      READ, RoundTrace, SCAN, StructResult, TornStructure,
                      UPDATE)

CompiledOp = Union[MwCASOp, StructResult, "NeedsSplit"]

LEAF_DEAD = (1 << 32) - 1        # value word of a deleted key (uint32 max)
MAX_KEY = FROZEN_BIT             # keys live in (0, 2^31), as in SortedNode
INNER_BIT = 1 << 30              # meta bit: this node routes (no KV slots)
NODE_CMASK = INNER_BIT - 1       # count bits below INNER_BIT / FROZEN_BIT


def count_ge(sorted_keys: np.ndarray, keys) -> np.ndarray:
    """SCAN's value for each of ``keys``: how many of ``sorted_keys``
    (live keys in ascending order, as :meth:`BzTreeIndex.scan_keys`
    gives them) are ``>=`` it."""
    keys = np.asarray(keys, np.int64)
    return len(sorted_keys) - np.searchsorted(sorted_keys, keys, side="left")


class LeafNode(SortedNode):
    """A SortedNode plus a parallel value array — the KV leaf.

    The meta/key protocol (count-as-visibility-switch, FROZEN_BIT,
    append order, sorted reads) is inherited unchanged; values ride in
    the slots ``base + 1 + capacity + i``.  Deletion never shrinks the
    append area: it CASes the value word to :data:`LEAF_DEAD`, and the
    next split compacts dead entries away (``keys()`` is live-only, so
    the inherited one-wide-MwCAS split is also the consolidation).
    """

    # -- layout ----------------------------------------------------------------
    def value_addr(self, i: int) -> int:
        return self.base + 1 + self.capacity + i

    @property
    def n_words(self) -> int:
        return 1 + 2 * self.capacity

    # -- reads -----------------------------------------------------------------
    def raw_values(self) -> List[int]:
        return [int(self.backend.read(self.value_addr(i)))
                for i in range(self.count)]

    def items(self) -> Dict[int, int]:
        """Live (key, value) pairs (dead entries filtered)."""
        return {k: v for k, v in zip(self.raw_slots(), self.raw_values())
                if v != LEAF_DEAD}

    def keys(self) -> List[int]:
        """Sorted LIVE keys — what the inherited split materializes."""
        return sorted(self.items())

    def search(self, key: int) -> bool:
        return key in self.items()

    # -- mutations -------------------------------------------------------------
    def compile_insert(self, key, meta=None, slots=None):
        raise NotImplementedError(
            "LeafNode inserts carry values; compile through BzTreeIndex")

    def _node_image(self, base: int, keys: List[int]) -> List:
        """Meta + keys (the SortedNode image) + their values: the half
        image the inherited ``split`` writes with its one wide MwCAS."""
        kv = self.items()
        return super()._node_image(base, keys) + \
            [(base + 1 + self.capacity + i, 0, kv[k])
             for i, k in enumerate(keys)]


@dataclasses.dataclass(frozen=True)
class NeedsSplit:
    """Compile verdict: this op cannot proceed until its leaf splits
    (full) or a pending split completes (frozen).  The sharded service
    layer dispatches on this type (`repro_torch.service`), so it is public:
    a round compiler that receives one should call
    :meth:`BzTreeIndex.ensure_room` and recompile."""
    leaf_base: int


_NeedsSplit = NeedsSplit         # original (private) spelling


class LeafClaim:
    """What :meth:`BzTreeIndex.compile_ops` yields, with
    ``defer_same_leaf``, for a leaf's second and later CAS ops: the only
    thing a conflict-defer round former reads of them, their claim on
    the leaf's meta word (``addrs``).  Every CAS op of a leaf targets its
    meta word, so such an op shares a word with the leaf's first op and
    is deferred (or held back by the round cap) whatever its other
    words; it is compiled again next wave.  Never executed."""
    __slots__ = ("leaf_base", "addrs")

    def __init__(self, leaf_base: int):
        self.leaf_base = leaf_base
        self.addrs = (leaf_base,)


class _StepReads:
    """The backend as one growth step sees it: word reads come from host
    copies of the table, fetched ``CHUNK`` words at a time; the step's
    own writes drop the copies of the chunks they touch.  Nothing else
    writes the table while a step runs, so every read returns what a
    read of the backend would — without a device round trip per word
    (a step's routing walk reads a word of every leaf)."""
    CHUNK = 1 << 16

    def __init__(self, backend):
        self._backend = backend
        self.name = backend.name
        self._chunks: Dict[int, np.ndarray] = {}

    def read(self, addr: int) -> int:
        c, off = divmod(addr, self.CHUNK)
        chunk = self._chunks.get(c)
        if chunk is None:
            chunk = self._chunks[c] = self._backend.read_words(
                c * self.CHUNK, (c + 1) * self.CHUNK)
        return int(chunk[off])

    def values(self) -> np.ndarray:
        return self._backend.values()

    def execute(self, ops):
        for op in ops:
            for a in op.addrs:
                self._chunks.pop(a // self.CHUNK, None)
        return self._backend.execute(ops)


class BzTreeIndex:
    """Multi-level BzTree over any PMwCAS backend.

    Holds no authoritative state: the word table IS the tree, so a
    crash/recover cycle on the durable backend is transparent —
    construct a fresh index over the recovered backend and it attaches
    to the existing root (rebuilding only the in-memory allocator mask
    from the words it can see).

    The client surface mirrors :class:`~repro_torch.structures.HashMap`:
    ``apply(ops)`` executes a batch of :class:`KVOp` in snapshot-
    compiled rounds (losers recompile next round), recording each round
    as a :class:`RoundTrace` for the simulator shadow differential, and
    ``check_integrity`` asserts the multi-node invariants (no torn node
    image, no half-written inner entry, every live key routed to the
    leaf that holds it).

    Capacity is bounded only by the region budget: when a node fills,
    the tree grows — sideways by splitting into a fresh region, or
    upward by a root split that swings the ``super`` word to a new
    1-entry inner root.  ``root_cap`` is the per-inner-node fanout, not
    a tree-wide ceiling.

    The region allocator's free bitmap lives on the backend's device
    when the backend has one (:attr:`KernelBackend.device`), else on
    ``device`` (default ``"cuda"``; a durable backend holds no tensors).
    """

    def __init__(self, backend: Backend, *, leaf_cap: int = 4,
                 root_cap: int = 8, n_regions: int = 8, base: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if leaf_cap < 2:
            raise ValueError("leaf_cap must be >= 2 (split needs halves)")
        if root_cap < 1 or n_regions < 1:
            raise ValueError("root_cap and n_regions must be positive")
        self.backend = backend
        self.leaf_cap = leaf_cap
        self.root_cap = root_cap
        self.base = base
        self.leaf_words = 1 + 2 * leaf_cap
        self.inner_words = 2 + 2 * root_cap
        # one region must fit the largest materialization: a root split
        # writes two half images plus the new root image in one region
        self.region_words = max(2 * self.leaf_words + self.inner_words,
                                3 * self.inner_words)
        self.pair_words = self.region_words         # compat alias
        self.super_addr = base
        self.pending_addr = base + 1
        self.region_base = base + 2
        self.n_regions = n_regions
        self.allocator = FreeListAllocator(
            n_regions, region_base=self.region_base,
            region_words=self.region_words,
            device=getattr(backend, "device", device))
        self.n_words = 2 + n_regions * self.region_words
        self.last_history: List[RoundTrace] = []
        # cumulative instrumentation (HashMap vocabulary + split counters)
        self.rounds_run = 0
        self.mwcas_submitted = 0
        self.mwcas_won = 0
        self.splits = 0
        self.root_splits = 0
        self.consolidations = 0
        self._attach_or_bootstrap()

    @staticmethod
    def words_needed(leaf_cap: int = 4, root_cap: int = 8,
                     n_regions: int = 8, base: int = 0) -> int:
        """Word-table size a backend must provide for these parameters."""
        lw, iw = 1 + 2 * leaf_cap, 2 + 2 * root_cap
        return base + 2 + n_regions * max(2 * lw + iw, 3 * iw)

    # -- layout ----------------------------------------------------------------
    def sep_addr(self, i: int, node: Optional[int] = None) -> int:
        """Separator word ``i`` of ``node`` (default: the current root,
        which must be an inner node)."""
        return self._inner_or_raise(node) + 2 + 2 * i

    def child_addr(self, i: int, node: Optional[int] = None) -> int:
        return self._inner_or_raise(node) + 3 + 2 * i

    def _inner_or_raise(self, node: Optional[int]) -> int:
        if node is not None:
            return node
        root = self.root_base()
        if not root or not self._read(root) & INNER_BIT:
            raise ValueError("root is not an inner node")
        return root

    def _slot_of(self, node_base: int) -> int:
        return (node_base - self.region_base) // self.region_words

    # -- reads -----------------------------------------------------------------
    def _read(self, addr: int) -> int:
        return int(self.backend.read(addr))

    def snapshot(self) -> np.ndarray:
        """One consistent-enough read of the whole tree region."""
        values = getattr(self.backend, "values", None)
        if callable(values):
            table = np.asarray(values(), np.int64)
            return table[self.base:self.base + self.n_words]
        return np.asarray([self._read(self.base + i)
                           for i in range(self.n_words)], np.int64)

    def _w(self, snap: Optional[np.ndarray], addr: int) -> int:
        return self._read(addr) if snap is None else int(snap[addr - self.base])

    def root_base(self, snap: Optional[np.ndarray] = None) -> int:
        return self._w(snap, self.super_addr)

    def height(self, snap: Optional[np.ndarray] = None) -> int:
        """Levels from root to leaf (1 = single-leaf tree, 0 = empty)."""
        node, h = self.root_base(snap), 0
        while node:
            h += 1
            m = self._w(snap, node)
            node = self._w(snap, node + 1) if m & INNER_BIT else 0
        return h

    def root_count(self, snap: Optional[np.ndarray] = None) -> int:
        """Visible entries of the root when it is an inner node (0 for
        a single-leaf or empty tree) — the old two-level meaning."""
        root = self.root_base(snap)
        if not root:
            return 0
        m = self._w(snap, root)
        return (m & NODE_CMASK) if m & INNER_BIT else 0

    def _node_entries(self, snap: Optional[np.ndarray], node: int
                      ) -> List[Tuple[int, int, int]]:
        """Visible (separator, child base, child word addr) of one inner
        node, sorted by separator — the sorted-on-read view."""
        cnt = self._w(snap, node) & NODE_CMASK
        out = [(self._w(snap, self.sep_addr(i, node)),
                self._w(snap, self.child_addr(i, node)),
                self.child_addr(i, node))
               for i in range(cnt)]
        out.sort()
        return out

    def _route(self, key: int, snap: Optional[np.ndarray] = None
               ) -> Tuple[int, int]:
        """(routing pointer word address, leaf base) for ``key``."""
        addr, node = self.super_addr, self.root_base(snap)
        depth = 0
        while node and self._w(snap, node) & INNER_BIT:
            depth += 1
            if depth > self.n_regions + 2:
                raise TornStructure("routing cycle")
            naddr, nnode = node + 1, self._w(snap, node + 1)
            for sep, child, caddr in self._node_entries(snap, node):
                if key >= sep:
                    naddr, nnode = caddr, child
            addr, node = naddr, nnode
        return addr, node

    def _leaves_under(self, snap: Optional[np.ndarray], node: int,
                      out: List[int], depth: int = 0) -> None:
        if depth > self.n_regions + 2:
            raise TornStructure("routing cycle")
        if self._w(snap, node) & INNER_BIT:
            self._leaves_under(snap, self._w(snap, node + 1), out, depth + 1)
            for _sep, child, _a in self._node_entries(snap, node):
                self._leaves_under(snap, child, out, depth + 1)
        else:
            out.append(node)

    def leaf_bases(self, snap: Optional[np.ndarray] = None) -> List[int]:
        """Reachable leaf bases in key order (leftmost first)."""
        root = self.root_base(snap)
        if not root:
            return []
        out: List[int] = []
        self._leaves_under(snap, root, out)
        return out

    def leaves(self) -> List[LeafNode]:
        return [LeafNode(self.backend, b, self.leaf_cap)
                for b in self.leaf_bases()]

    def lookup(self, key: int) -> Optional[int]:
        _, base = self._route(key)
        if not base:
            return None
        return LeafNode(self.backend, base, self.leaf_cap).items().get(key)

    def items(self, snap: Optional[np.ndarray] = None) -> Dict[int, int]:
        """All live (key, value) pairs across the reachable leaves."""
        snap = self.snapshot() if snap is None else snap
        out: Dict[int, int] = {}
        for lb in self.leaf_bases(snap):
            cnt = self._w(snap, lb) & NODE_CMASK
            for i in range(cnt):
                k = self._w(snap, lb + 1 + i)
                v = self._w(snap, lb + 1 + self.leaf_cap + i)
                if v != LEAF_DEAD:
                    out[k] = v
        return out

    def live_keys(self, snap: Optional[np.ndarray] = None) -> np.ndarray:
        """The key of every live entry (value not :data:`LEAF_DEAD`)
        below the count of every reachable leaf, as int64 — what SCAN
        counts.  Gathered with numpy over the snapshot; a leaf whose
        count exceeds ``leaf_cap`` (a torn image) is read word by word,
        as the per-entry walk would."""
        snap = self.snapshot() if snap is None else snap
        bases = np.asarray(self.leaf_bases(snap), np.int64)
        if not len(bases):
            return np.zeros(0, np.int64)
        rel = bases - self.base
        cnt = snap[rel] & NODE_CMASK
        if (cnt > self.leaf_cap).any():
            return np.asarray(
                [self._w(snap, lb + 1 + i) for lb in bases.tolist()
                 for i in range(self._w(snap, lb) & NODE_CMASK)
                 if self._w(snap, lb + 1 + self.leaf_cap + i) != LEAF_DEAD],
                np.int64)
        slot = np.arange(self.leaf_cap)
        keys = snap[rel[:, None] + 1 + slot]
        vals = snap[rel[:, None] + 1 + self.leaf_cap + slot]
        return keys[(slot < cnt[:, None]) & (vals != LEAF_DEAD)]

    def scan_keys(self, snap: Optional[np.ndarray] = None) -> np.ndarray:
        """:meth:`live_keys` sorted, as int64: what :func:`count_ge`
        counts a SCAN over."""
        return np.sort(self.live_keys(snap).astype(np.int64, copy=False))

    # -- bootstrap / attach ----------------------------------------------------
    def _attach_or_bootstrap(self) -> None:
        snap = self.snapshot()
        if self._w(snap, self.super_addr) == 0:
            # empty pool: an empty unfrozen leaf is all-zero words, so
            # bootstrap is nothing but the super install (one CAS) — the
            # tree starts life as a single leaf
            (grant,) = self.allocator.alloc([1])
            if grant is None:
                raise RuntimeError("no region for the bootstrap leaf")
            leaf_base = self.allocator.region(grant[0])
            (res,) = self.backend.execute(
                [MwCASOp([(self.super_addr, 0, leaf_base)])])
            if not res.success:
                raise RuntimeError("bootstrap super install lost its CAS")
            return
        # attach to an existing tree: rebuild the allocator mask from
        # what the words show — reachable nodes plus any non-zero region
        # (frozen originals and crash-orphaned halves stay claimed)
        used = {self._slot_of(b) for b in self._reachable_nodes(snap)}
        for slot in range(self.n_regions):
            lo = self.allocator.region(slot) - self.base
            if snap[lo:lo + self.region_words].any():
                used.add(slot)
        if used:
            granted = self.allocator.reserve([[s] for s in sorted(used)])
            if not all(granted):
                raise RuntimeError("attach could not reclaim region slots")

    def _node_words_of(self, snap: Optional[np.ndarray], node: int) -> int:
        return self.inner_words if self._w(snap, node) & INNER_BIT \
            else self.leaf_words

    def _collect(self, snap: Optional[np.ndarray], node: int,
                 out: Set[int], depth: int = 0) -> None:
        if not node or node in out or depth > self.n_regions + 2:
            return
        out.add(node)
        m = self._w(snap, node)
        if not m & INNER_BIT:
            return
        self._collect(snap, self._w(snap, node + 1), out, depth + 1)
        cnt = m & NODE_CMASK
        for i in range(cnt):
            self._collect(snap, self._w(snap, self.child_addr(i, node)),
                          out, depth + 1)
        if cnt < self.root_cap:
            # invisible pre-entry at the append position: protect the
            # half-materialized pair of a pending child split
            pre = self._w(snap, self.child_addr(cnt, node))
            if pre:
                self._collect(snap, pre, out, depth + 1)
                self._collect(snap, pre - self._node_words_of(snap, pre),
                              out, depth + 1)

    def _reachable_nodes(self, snap: Optional[np.ndarray]) -> Set[int]:
        """Node bases a GC/attach pass must keep: the visible tree, the
        pending new root of an in-flight root split (its halves live in
        the same region), and every invisible parent pre-entry pair."""
        out: Set[int] = set()
        self._collect(snap, self.root_base(snap), out)
        pend = self._w(snap, self.pending_addr)
        if pend:
            self._collect(snap, pend, out)
        return out

    # -- operation compilation -------------------------------------------------
    def compile_op(self, op: KVOp, snap: np.ndarray
                   ) -> Union[MwCASOp, StructResult, _NeedsSplit]:
        """One logical op -> one MwCASOp (or an immediate result, or a
        split request).  Expected values come from ``snap``, so condition
        (a) of the batch semantics passes by construction — the
        HashMap.compile_op contract, lifted to routing."""
        if not 0 < op.key < MAX_KEY:
            raise ValueError(f"key {op.key} outside (0, 2^31)")
        if op.kind == SCAN:
            return StructResult(op, OK, value=int(
                count_ge(self.scan_keys(snap), op.key)))
        _, leaf = self._route(op.key, snap)
        cap = self.leaf_cap
        meta = self._w(snap, leaf)
        cnt = meta & NODE_CMASK
        keys = [self._w(snap, leaf + 1 + i) for i in range(cnt)]
        vals = [self._w(snap, leaf + 1 + cap + i) for i in range(cnt)]
        live = {k: (i, v) for i, (k, v) in enumerate(zip(keys, vals))
                if v != LEAF_DEAD}
        if op.kind == READ:
            if op.key in live:
                return StructResult(op, OK, value=live[op.key][1])
            return StructResult(op, NOT_FOUND)
        frozen = bool(meta & FROZEN_BIT)
        if op.kind == INSERT:
            if op.key in live:
                return StructResult(op, EXISTS, value=live[op.key][1])
            if frozen:                       # pending split must complete
                return _NeedsSplit(leaf)
            for i, (k, v) in enumerate(zip(keys, vals)):
                if k == op.key and v == LEAF_DEAD:
                    # revive the dead slot in place (meta guard pins the
                    # leaf against a concurrent freeze/split)
                    return MwCASOp([(leaf, meta, meta),
                                    (leaf + 1 + cap + i, LEAF_DEAD,
                                     op.value)])
            if cnt >= cap:
                return _NeedsSplit(leaf)
            return MwCASOp([(leaf, meta, meta + 1),
                            (leaf + 1 + cnt, 0, op.key),
                            (leaf + 1 + cap + cnt, 0, op.value)])
        # UPDATE / DELETE
        if op.key not in live:
            return StructResult(op, NOT_FOUND)
        if frozen:
            return _NeedsSplit(leaf)
        idx, cur = live[op.key]
        desired = op.value if op.kind == UPDATE else LEAF_DEAD
        return MwCASOp([(leaf, meta, meta),
                        (leaf + 1 + cap + idx, cur, desired)])

    def compile_ops(self, ops: Sequence[KVOp], snap: np.ndarray, *,
                    defer_same_leaf: bool = False
                    ) -> Iterator[Union[CompiledOp, LeafClaim]]:
        """``compile_op(op, snap)`` for every op, in order — the same
        objects, built from numpy gathers over the snapshot instead of
        one Python read per word (a round compiler calls this for a
        whole queue every wave).  With ``defer_same_leaf`` (for a round
        former that defers ops sharing a word with the round, as the
        service's does) a leaf's second and later CAS ops come as a
        :class:`LeafClaim` instead of the op.

        Routing is a ``searchsorted`` over the reachable leaves' lower
        bounds in key order.  That is ``_route``'s answer whenever the
        bounds strictly increase (every separator inside its ancestors'
        range, none repeated), which :meth:`_leaf_router` checks; where
        they do not, where a leaf count runs past ``leaf_cap``, or from
        the first key outside (0, 2^31) on (``compile_op`` raises there),
        the ops are compiled one by one."""
        ops = list(ops)
        bad = next((i for i, op in enumerate(ops)
                    if not 0 < op.key < MAX_KEY), len(ops))
        router = self._leaf_router(snap) if bad else None
        if router is None:
            for op in ops:
                yield self.compile_op(op, snap)
            return
        cap = self.leaf_cap
        head = ops[:bad]
        keys = np.fromiter((op.key for op in head), np.int64, bad)
        lows, bases = router
        leaf = bases[np.searchsorted(lows, keys, side="right") - 1]
        rel = leaf - self.base
        meta = snap[rel]
        cnt = meta & NODE_CMASK
        if (cnt > cap).any() or int(rel.max()) + 1 + 2 * cap > len(snap):
            for op in ops:
                yield self.compile_op(op, snap)
            return
        slot = np.arange(cap)
        kw = snap[rel[:, None] + 1 + slot]
        vw = snap[rel[:, None] + 1 + cap + slot]
        mine = (slot < cnt[:, None]) & (kw == keys[:, None])
        live = mine & (vw != LEAF_DEAD)
        dead = mine & (vw == LEAF_DEAD)
        # the reference's ``live`` dict keeps a repeated key's LAST live
        # slot; a revive takes the FIRST dead one
        has_live = live.any(1)
        live_i = np.where(has_live, cap - 1 - np.argmax(live[:, ::-1], 1), 0)
        live_v = vw[np.arange(bad), live_i]
        dead_i = np.where(dead.any(1), np.argmax(dead, 1), -1)
        scan_keys = None
        claimed: Set[int] = set()
        for op, lb, m, c, hl, li, lv, di in zip(
                head, leaf.tolist(), meta.tolist(), cnt.tolist(),
                has_live.tolist(), live_i.tolist(), live_v.tolist(),
                dead_i.tolist()):
            kind = op.kind
            if kind == SCAN:
                if scan_keys is None:
                    scan_keys = self.scan_keys(snap)
                yield StructResult(op, OK,
                                   value=int(count_ge(scan_keys, op.key)))
            elif kind == READ:
                yield (StructResult(op, OK, value=lv) if hl
                       else StructResult(op, NOT_FOUND))
            elif kind == INSERT:
                if hl:
                    yield StructResult(op, EXISTS, value=lv)
                elif m & FROZEN_BIT or (di < 0 and c >= cap):
                    yield _NeedsSplit(lb)
                elif lb in claimed:
                    yield LeafClaim(lb)
                else:
                    if defer_same_leaf:
                        claimed.add(lb)
                    if di >= 0:                 # revive the dead slot
                        yield MwCASOp.of_distinct((
                            Target(lb, m, m),
                            Target(lb + 1 + cap + di, LEAF_DEAD, op.value)))
                    else:
                        yield MwCASOp.of_distinct((
                            Target(lb, m, m + 1),
                            Target(lb + 1 + c, 0, op.key),
                            Target(lb + 1 + cap + c, 0, op.value)))
            elif not hl:
                yield StructResult(op, NOT_FOUND)
            elif m & FROZEN_BIT:
                yield _NeedsSplit(lb)
            elif lb in claimed:
                yield LeafClaim(lb)
            else:
                if defer_same_leaf:
                    claimed.add(lb)
                yield MwCASOp.of_distinct((
                    Target(lb, m, m),
                    Target(lb + 1 + cap + li, lv,
                           op.value if kind == UPDATE else LEAF_DEAD)))
        for op in ops[bad:]:
            yield self.compile_op(op, snap)

    def _leaf_router(self, snap: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """``(lows, bases)``: the reachable leaves in key order and the
        lower bound each is routed under (-1 for the leftmost), or None
        where a ``searchsorted`` over them could differ from
        :meth:`_route` — an empty tree, a zero child pointer, a routing
        cycle, or bounds that do not strictly increase.

        Strictly increasing bounds put every separator inside the range
        of each ancestor entry and make each node's separators distinct
        (a subtree's leftmost leaf carries the subtree's bound), so the
        largest bound <= key names the leaf ``_route`` walks to."""
        root = self.root_base(snap)
        if not root:
            return None
        lows: List[int] = []
        bases: List[int] = []
        seen: Set[int] = set()

        def visit(node: int, lo: int) -> bool:
            if not node or node in seen or not 0 <= node - self.base \
                    < len(snap):
                return False
            seen.add(node)
            m = self._w(snap, node)
            if not m & INNER_BIT:
                lows.append(lo)
                bases.append(node)
                return True
            if node - self.base + 2 + 2 * (m & NODE_CMASK) > len(snap):
                return False
            if not visit(self._w(snap, node + 1), lo):
                return False
            return all(visit(child, sep) for sep, child, _a in
                       self._node_entries(snap, node))

        if not visit(root, -1):
            return None
        lo_arr = np.asarray(lows, np.int64)
        if (np.diff(lo_arr) <= 0).any():
            return None
        return lo_arr, np.asarray(bases, np.int64)

    # -- the growth protocol (DESIGN Sec. 7 & 12) ------------------------------
    def ensure_room(self, node_base: int) -> bool:
        """Public growth entry point for external round compilers (the
        sharded service layer): perform ONE two-round growth step toward
        making room under the node a :class:`NeedsSplit` verdict named —
        complete a pending root swing or parent pre-entry, split the
        node, or split an ancestor that is itself full.  Returns True
        when the tree changed (recompile and retry), False when it
        cannot grow; raises :class:`~repro_torch.structures.OutOfRegions`
        when the allocator is exhausted even after a GC pass — the
        typed FULL-vs-conflict distinction the service records."""
        with self._step_reads():
            return self._ensure_room(node_base)

    @contextlib.contextmanager
    def _step_reads(self):
        """Route the step's reads through :class:`_StepReads` when the
        backend can copy a range of words at once (a kernel table)."""
        backend = self.backend
        if not callable(getattr(backend, "read_words", None)):
            yield
            return
        self.backend = _StepReads(backend)
        try:
            yield
        finally:
            self.backend = backend

    def _ensure_room(self, node_base: int) -> bool:
        pend = self._read(self.pending_addr)
        if pend:
            return self._swing_root(pend)
        path = self._path_to(node_base)
        if path is None:
            return True          # no longer routed: a helper replaced it
        try:
            return self._grow(path)
        except OutOfRegions:
            if not self.gc_regions():
                raise
            path = self._path_to(node_base)
            if path is None:
                return True
            return self._grow(path)

    def _path_to(self, target: int, snap: Optional[np.ndarray] = None
                 ) -> Optional[List[Tuple[int, int]]]:
        """Routing path root -> ``target`` as (ptr word addr, node base)
        pairs, or None when the node is no longer reachable."""
        root = self.root_base(snap)
        if not root:
            return None

        def rec(ptr_addr: int, node: int, path: List[Tuple[int, int]],
                depth: int) -> Optional[List[Tuple[int, int]]]:
            path = path + [(ptr_addr, node)]
            if node == target:
                return path
            if depth > self.n_regions + 2:
                return None
            m = self._w(snap, node)
            if not m & INNER_BIT:
                return None
            caddrs = [node + 1] + [self.child_addr(i, node)
                                   for i in range(m & NODE_CMASK)]
            for ca in caddrs:
                hit = rec(ca, self._w(snap, ca), path, depth + 1)
                if hit:
                    return hit
            return None

        return rec(self.super_addr, root, [], 0)

    def _grow(self, path: List[Tuple[int, int]]) -> bool:
        """One growth step along ``path`` (root -> the node that needs
        room).  When the parent has no free entry slot — or is frozen
        mid-split itself — the parent grows first; the caller recompiles
        and comes back, so each call stays a single two-round window."""
        ptr_addr, node = path[-1]
        if len(path) >= 2:
            parent = path[-2][1]
            pm = self._read(parent)
            n = pm & NODE_CMASK
            if pm & FROZEN_BIT or n >= self.root_cap:
                return self._grow(path[:-1])
            sep_w = self._read(self.sep_addr(n, parent))
            child_w = self._read(self.child_addr(n, parent))
            if sep_w and child_w:
                # round 1 already committed (this node's split or a
                # sibling's): complete its install, then let the caller
                # recompile and retry
                return self._install(parent, n, sep_w, child_w)
            return self._split_child(parent, n, ptr_addr, node)
        return self._split_root(node)

    def _freeze_inner(self, node: int) -> None:
        """Idempotent 1-word freeze of an inner node (SortedNode.freeze
        for the INNER_BIT-tagged meta encoding)."""
        for _ in range(8):
            m = self._read(node)
            if m & FROZEN_BIT:
                return
            (res,) = self.backend.execute(
                [MwCASOp([(node, m, m | FROZEN_BIT)])])
            self.mwcas_submitted += 1
            if res.success:
                self.mwcas_won += 1
                return
        raise TornStructure(f"could not freeze inner@{node}")

    def _inner_halves(self, node: int, region: int
                      ) -> Tuple[List, List, int, int, int]:
        """Half images of a frozen inner node: promote the middle
        separator up, left half keeps entries below it, right half's
        ptr0 takes its child.  Returns (left image, right image,
        promoted separator, left base, right base)."""
        entries = [(s, c) for s, c, _a in self._node_entries(None, node)]
        ptr0 = self._read(node + 1)
        mid = len(entries) // 2
        sep_up, mid_child = entries[mid]
        left, right = region, region + self.inner_words

        def image(b: int, p0: int, ents: List[Tuple[int, int]]) -> List:
            t = [(b, 0, len(ents) | INNER_BIT), (b + 1, 0, p0)]
            for i, (s, c) in enumerate(ents):
                t += [(b + 2 + 2 * i, 0, s), (b + 3 + 2 * i, 0, c)]
            return t

        return (image(left, ptr0, entries[:mid]),
                image(right, mid_child, entries[mid + 1:]),
                sep_up, left, right)

    def _split_child(self, parent: int, n: int, ptr_addr: int,
                     node: int) -> bool:
        """Non-root split of ``node`` under ``parent`` (append slot
        ``n`` is free): rounds 1+2 of the uniform protocol."""
        m = self._read(node)
        (grant,) = self.allocator.alloc([1])
        if grant is None:
            return False
        region = self.allocator.region(grant[0])
        if m & INNER_BIT:
            if (m & NODE_CMASK) < 1:
                self.allocator.free(grant)
                return False
            self._freeze_inner(node)
            left_img, right_img, sep, _left, right = \
                self._inner_halves(node, region)
            targets = left_img + right_img + [
                (self.sep_addr(n, parent), 0, sep),
                (self.child_addr(n, parent), 0, right)]
            (res,) = self.backend.execute([MwCASOp(targets).sorted()])
            self.mwcas_submitted += 1
            if not res.success:
                self.allocator.free(grant)
                return False
            self.mwcas_won += 1
            return self._install(parent, n, sep, right)
        leaf = LeafNode(self.backend, node, self.leaf_cap)
        leaf.freeze()
        ks = leaf.keys()
        if len(ks) < 2:
            return self._consolidate(leaf, grant, ptr_addr)
        left_base, right_base = region, region + self.leaf_words
        sep = ks[len(ks) // 2]
        try:
            # round 1: the existing one-wide-MwCAS split, with the parent
            # pre-entry folded into the same atomic op (invisible until
            # round 2 bumps the count)
            leaf.split(left_base, right_base,
                       extra_targets=[(self.sep_addr(n, parent), 0, sep),
                                      (self.child_addr(n, parent), 0,
                                       right_base)])
        except SplitError:
            self.allocator.free(grant)       # nothing was written (atomic)
            return False
        self.mwcas_submitted += 2            # freeze + wide materialize
        self.mwcas_won += 2
        return self._install(parent, n, sep, right_base)

    def _route_in(self, parent: int, key: int) -> Tuple[int, int]:
        """(child word addr, child base) ``key`` routes to inside one
        inner node (live reads)."""
        addr, node = parent + 1, self._read(parent + 1)
        for sep, child, caddr in self._node_entries(None, parent):
            if key >= sep:
                addr, node = caddr, child
        return addr, node

    def _install(self, parent: int, n: int, sep: int,
                 right_base: int) -> bool:
        """Round 2 of a non-root split: ONE 2-word MwCAS — swing the old
        child's routing pointer to the left half while bumping the
        parent count, making the pre-published (separator, right child)
        entry visible.  The linearization point of the whole split."""
        left_base = right_base - self._node_words_of(None, right_base)
        ptr_addr, old_base = self._route_in(parent, sep)
        if old_base in (left_base, right_base):
            return True                      # already installed (helper)
        pm = self._read(parent)
        if pm & FROZEN_BIT:
            return False                     # parent mid-split; recompile
        if (pm & NODE_CMASK) != n:
            return (pm & NODE_CMASK) > n
        (res,) = self.backend.execute(
            [MwCASOp([(parent, pm, pm + 1),
                      (ptr_addr, old_base, left_base)])])
        self.mwcas_submitted += 1
        if res.success:
            self.mwcas_won += 1
            self.splits += 1
            return True
        return (self._read(parent) & NODE_CMASK) > n

    def _split_root(self, root: int) -> bool:
        """Root split: round 1 materializes BOTH halves AND the new
        1-entry root in one region with ONE wide MwCAS that also sets
        the ``pending`` word; round 2 (:meth:`_swing_root`) swings
        ``super`` while clearing ``pending``.  Grows the tree one
        level."""
        m = self._read(root)
        (grant,) = self.allocator.alloc([1])
        if grant is None:
            return False
        region = self.allocator.region(grant[0])
        if m & INNER_BIT:
            if (m & NODE_CMASK) < 1:
                self.allocator.free(grant)
                return False
            self._freeze_inner(root)
            left_img, right_img, sep, left, right = \
                self._inner_halves(root, region)
            new_root = region + 2 * self.inner_words
            targets = left_img + right_img + [
                (new_root, 0, 1 | INNER_BIT), (new_root + 1, 0, left),
                (new_root + 2, 0, sep), (new_root + 3, 0, right),
                (self.pending_addr, 0, new_root)]
            (res,) = self.backend.execute([MwCASOp(targets).sorted()])
            self.mwcas_submitted += 1
            if not res.success:
                self.allocator.free(grant)
                return False
            self.mwcas_won += 1
            return self._swing_root(new_root)
        leaf = LeafNode(self.backend, root, self.leaf_cap)
        leaf.freeze()
        ks = leaf.keys()
        if len(ks) < 2:
            return self._consolidate(leaf, grant, self.super_addr)
        left, right = region, region + self.leaf_words
        sep = ks[len(ks) // 2]
        new_root = region + 2 * self.leaf_words
        try:
            # the inherited wide split op, with the new root image and
            # the pending word folded into the same atomic round
            leaf.split(left, right, extra_targets=[
                (new_root, 0, 1 | INNER_BIT), (new_root + 1, 0, left),
                (new_root + 2, 0, sep), (new_root + 3, 0, right),
                (self.pending_addr, 0, new_root)])
        except SplitError:
            self.allocator.free(grant)
            return False
        self.mwcas_submitted += 2            # freeze + wide materialize
        self.mwcas_won += 2
        return self._swing_root(new_root)

    def _swing_root(self, new_root: int) -> bool:
        """Round 2 of a root split (also the crash-completion helper):
        ONE 2-word MwCAS swings ``super`` to the materialized new root
        while clearing ``pending``.  Idempotent: a helper that lost the
        race confirms the swing happened."""
        old = self._read(self.super_addr)
        if old == new_root:
            return True
        (res,) = self.backend.execute(
            [MwCASOp([(self.super_addr, old, new_root),
                      (self.pending_addr, new_root, 0)])])
        self.mwcas_submitted += 1
        if res.success:
            self.mwcas_won += 1
            self.splits += 1
            self.root_splits += 1
            return True
        return self._read(self.super_addr) == new_root

    def _consolidate(self, leaf: LeafNode, grant: List[int],
                     ptr_addr: int) -> bool:
        """A full leaf with < 2 live keys cannot split; materialize one
        compacted node (same one-wide-MwCAS image) and swing its routing
        word — ``ptr_addr`` from the caller's path — to it (1-word
        install, no parent entry needed)."""
        new_base = self.allocator.region(grant[0])
        ks = leaf.keys()
        (res,) = self.backend.execute(
            [MwCASOp(leaf._node_image(new_base, ks))])
        self.mwcas_submitted += 1
        if not res.success:
            self.allocator.free(grant)
            return False
        self.mwcas_won += 1
        old = self._read(ptr_addr)
        if old != leaf.base:
            return True                      # raced: already swung
        (res2,) = self.backend.execute(
            [MwCASOp([(ptr_addr, old, new_base)])])
        self.mwcas_submitted += 1
        if res2.success:
            self.mwcas_won += 1
            self.consolidations += 1
        return bool(res2.success)

    # -- round-based execution -------------------------------------------------
    def apply(self, ops: Sequence[KVOp],
              max_rounds: Optional[int] = None) -> List[StructResult]:
        """Execute one batch of logical ops; losers retry next round.

        Ops that hit a full (or frozen mid-split) leaf trigger the
        growth protocol between rounds and recompile against the grown
        tree.
        """
        max_rounds = 2 * len(ops) + 4 if max_rounds is None else max_rounds
        results: List[Optional[StructResult]] = [None] * len(ops)
        pending = list(range(len(ops)))
        self.last_history = []
        rounds = 0
        split_budget = 4 * self.n_regions + 8
        while pending and rounds < max_rounds:
            snap = self.snapshot()
            batch_ops: List[MwCASOp] = []
            owners: List[int] = []
            needs: Dict[int, List[int]] = {}
            for idx, compiled in zip(pending, self.compile_ops(
                    [ops[i] for i in pending], snap)):
                if isinstance(compiled, StructResult):
                    compiled.rounds = rounds
                    results[idx] = compiled
                elif isinstance(compiled, _NeedsSplit):
                    needs.setdefault(compiled.leaf_base, []).append(idx)
                else:
                    batch_ops.append(compiled)
                    owners.append(idx)
            if needs:
                # grow first, then recompile EVERYone against the new
                # tree shape (ops compiled above would mostly lose their
                # round anyway: the split freezes their leaf's meta)
                for leaf_base, idxs in needs.items():
                    try:
                        grew = split_budget > 0 and \
                            self.ensure_room(leaf_base)
                    except OutOfRegions:
                        grew = False         # region-exhausted == FULL here
                    if grew:
                        split_budget -= 1
                    else:
                        for idx in idxs:
                            results[idx] = StructResult(ops[idx], FULL,
                                                        rounds=rounds)
                pending = [i for i in pending if results[i] is None]
                continue
            if not batch_ops:
                pending = []
                break
            rounds += 1
            self.rounds_run += 1
            verdicts = self.backend.execute(batch_ops)
            success = np.asarray([r.success for r in verdicts])
            self.last_history.append(
                RoundTrace(ops=batch_ops, owners=owners, success=success))
            self.mwcas_submitted += len(batch_ops)
            self.mwcas_won += int(success.sum())
            still: List[int] = []
            for pos, idx in enumerate(owners):
                if success[pos]:
                    results[idx] = StructResult(ops[idx], OK, rounds=rounds)
                else:
                    still.append(idx)
            pending = still
        for idx in pending:
            results[idx] = StructResult(ops[idx], EXHAUSTED, rounds=rounds)
        assert all(r is not None for r in results)
        return results               # type: ignore[return-value]

    # -- region GC (frozen split originals stay claimed) -----------------------
    def gc_regions(self) -> int:
        """Recovery-time region GC: free regions no routing state
        references — the frozen originals of completed splits,
        consolidated-away leaves and crash-abandoned halves.  Without
        this, a long-running workload leaks one region per growth step
        until the allocator reports :class:`OutOfRegions` (the WAL side
        is pruned by ``prune_completed``; this is the word side).

        A region is live iff it holds a node reachable from ``super``,
        from the ``pending`` new root of an in-flight root split, or
        from an invisible parent pre-entry (a pending split's right
        half — its left sibling shares the region, so both stay claimed
        until the install completes).  Everything else holding non-zero
        words is residue: it is zeroed with ONE wide MwCAS (atomic — a
        crash mid-GC leaves the region whole and still unreferenced, so
        the next pass retakes it) and returned to the free list.
        Returns the number of regions freed.
        """
        snap = self.snapshot()
        live_slots = {self._slot_of(b) for b in self._reachable_nodes(snap)}
        freed = 0
        for slot in range(self.n_regions):
            lo = self.allocator.region(slot) - self.base
            words = snap[lo:lo + self.region_words]
            if slot in live_slots or not words.any():
                continue
            base_addr = self.base + lo
            targets = [(base_addr + j, int(w), 0)
                       for j, w in enumerate(words) if w]
            (res,) = self.backend.execute([MwCASOp(targets)])
            self.mwcas_submitted += 1
            if not res.success:
                continue                 # raced: next GC pass retakes it
            self.mwcas_won += 1
            self.allocator.free([slot])
            freed += 1
        return freed

    # -- integrity -------------------------------------------------------------
    def check_integrity(self, snap: Optional[np.ndarray] = None
                        ) -> Dict[int, int]:
        """Assert the multi-node invariants; return the live items.

        Checked (each is an atomicity consequence of the protocol —
        violating any means a torn MwCAS, which must never happen):

        - a non-zero ``pending`` word names a complete 1-entry inner
          image over a frozen old root (root-split round 1 is one wide
          MwCAS, so it is all-or-nothing);
        - no half-written inner entry: entries below the count are
          fully populated, the append position is all-zero or a
          complete pre-entry, and nothing exists beyond it;
        - no torn leaf image: key and value words below the arrival
          count are populated together, words beyond it are zero;
        - routing: every separator respects its ancestors' bounds,
          every live key sits in the exact leaf the separators route it
          to, and no key is live in two leaves.
        """
        snap = self.snapshot() if snap is None else snap
        root = self.root_base(snap)
        pend = self._w(snap, self.pending_addr)
        if pend:
            pm = self._w(snap, pend)
            if not pm & INNER_BIT or (pm & NODE_CMASK) != 1:
                raise TornStructure("pending root is not a 1-entry inner")
            if not (self._w(snap, pend + 1) and self._w(snap, pend + 2)
                    and self._w(snap, pend + 3)):
                raise TornStructure("pending root image is torn")
            if not root:
                raise TornStructure("pending root split on an empty tree")
            if not self._w(snap, root) & FROZEN_BIT:
                raise TornStructure("pending root split over unfrozen root")
        if not root:
            return {}                        # pre-bootstrap empty tree
        items: Dict[int, int] = {}
        self._check_node(snap, root, None, None, items, 0)
        return items

    def _check_node(self, snap: Optional[np.ndarray], node: int,
                    lo: Optional[int], hi: Optional[int],
                    items: Dict[int, int], depth: int) -> None:
        if depth > self.n_regions + 2:
            raise TornStructure("routing cycle")
        m = self._w(snap, node)
        cnt = m & NODE_CMASK
        if m & INNER_BIT:
            if cnt > self.root_cap:
                raise TornStructure(
                    f"inner@{node} count {cnt} > capacity {self.root_cap}")
            if not self._w(snap, node + 1):
                raise TornStructure(f"inner@{node} has no leftmost child")
            for i in range(cnt):
                if not self._w(snap, self.sep_addr(i, node)) or \
                        not self._w(snap, self.child_addr(i, node)):
                    raise TornStructure(
                        f"inner@{node} entry {i} below count is torn")
            for i in range(cnt, self.root_cap):
                s = self._w(snap, self.sep_addr(i, node))
                c = self._w(snap, self.child_addr(i, node))
                if i == cnt:
                    if bool(s) != bool(c):
                        raise TornStructure(
                            f"half-written pre-entry at append position "
                            f"{cnt} of inner@{node}: sep={s} child={c}")
                elif s or c:
                    raise TornStructure(
                        f"inner@{node} entry {i} beyond append position "
                        f"{cnt} is claimed")
            entries = self._node_entries(snap, node)
            seps = [sep for sep, _c, _a in entries]
            if len(set(seps)) != len(seps):
                raise TornStructure(f"duplicate separators {seps}")
            for sep in seps:
                if (lo is not None and sep < lo) or \
                        (hi is not None and sep >= hi):
                    raise TornStructure(
                        f"inner@{node} separator {sep} outside "
                        f"bounds [{lo}, {hi})")
            children = [self._w(snap, node + 1)] + [c for _s, c, _a in entries]
            lows = [lo] + seps
            highs = seps + [hi]
            for child, clo, chi in zip(children, lows, highs):
                self._check_node(snap, child, clo, chi, items, depth + 1)
            return
        if cnt > self.leaf_cap:
            raise TornStructure(f"leaf@{node} count {cnt} > capacity")
        for i in range(self.leaf_cap):
            k = self._w(snap, node + 1 + i)
            v = self._w(snap, node + 1 + self.leaf_cap + i)
            if i < cnt:
                if k == 0 or v == 0:
                    raise TornStructure(
                        f"leaf@{node} slot {i}: torn pair key={k} val={v}")
                if v != LEAF_DEAD:
                    if k in items:
                        raise TornStructure(f"key {k} live in two leaves")
                    if (lo is not None and k < lo) or \
                            (hi is not None and k >= hi):
                        raise TornStructure(
                            f"leaf@{node} holds misrouted key {k} "
                            f"(range [{lo}, {hi}))")
                    items[k] = v
            elif k or v:
                raise TornStructure(
                    f"leaf@{node} ghost words beyond count {cnt}")
