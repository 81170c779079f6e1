"""Structure-level crash-consistency checkers: the durable sweeps and
the simulator sweep.

One invariant — *no torn multi-word effect, no lost committed effect*:

- **Durable sweep** (:func:`check_durable_crash_sweep`): replay a logical
  hash-map workload against a :class:`repro_torch.pmwcas.DurableBackend`
  whose pmem pool crashes on the N-th persist, for every N until a run
  completes.  After each crash + recovery the rebuilt map must contain
  exactly the effects of the ops the client saw commit — plus at most
  the one in-flight op (committed iff its SUCCEEDED record was
  persisted before the crash; the client just never saw the verdict).
- **Tree sweep** (:func:`check_tree_crash_sweep`): the durable sweep
  lifted to the multi-node :class:`repro_torch.structures.BzTreeIndex` —
  crashing at every persist point *through a leaf split* (and, when the
  workload overflows the root, through a root split's pending-word
  handoff) must leave either the pre-split or the fully-linked
  post-split tree (DESIGN.md Sec. 7/12), never a torn node image or a
  half-installed parent entry.
- **Resize sweep** (:func:`check_hashmap_resize_sweep`): the durable
  sweep through directory doubling — every persist of decide / pump /
  split-brain client ops / finalize swing (DESIGN.md Sec. 12).
- **Migration sweep** (``repro_torch.service.check_migration_crash_sweep``):
  the same sweep lifted to the service's online key-range shard
  migration — it needs a whole ``KVService``, so it lives one layer up
  (DESIGN.md Sec. 12).

The durable sweeps also exercise WAL hygiene in their teardown: after each
recovery check the COMPLETED descriptor records are pruned
(:meth:`DurableBackend.prune_completed`) and a second crash/recover
cycle must reproduce the identical structure state.

The durable sweeps take ``group_commit`` (which flush protocol is under
sweep — the coalesced one-fence-per-round path is the default, matching
:class:`repro_torch.pmwcas.DurableBackend`) and ``batch`` (ops applied
per round, so the coalesced path commits real multi-op rounds); the
acceptable recovered states are computed from an oracle run's ROUND
composition — a crash inside a batch may recover any round prefix,
each round atomic at its commit fence (DESIGN.md Sec. 9.1).

- **Simulator sweep** (:func:`check_sim_crash_sweep`): a compiled
  structure round, shadowed as increments, crashed at micro-op steps of
  the cycle-accurate simulator; every crash point is one simulation of
  one batched launch (``repro_torch.core.run_sims``).
"""
from __future__ import annotations

import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import PMemPool, SimulatedCrash
from repro_torch.pmwcas import (Algorithm, DurableBackend, MwCASOp, OURS,
                                SimSession, check_crash_consistency,
                                resolve, run_sims)

from .hashmap import DELETE, HashMap, INSERT, KVOp, OK, UPDATE


class CrashCheckError(AssertionError):
    """Recovered structure state the committed history cannot explain."""


def replay_effects(ops_with_status: Iterable[Tuple[KVOp, str]]
                   ) -> Dict[int, int]:
    """Client-side model: the live map after a sequence of (op, status)."""
    model: Dict[int, int] = {}
    for op, status in ops_with_status:
        if status != OK:
            continue
        if op.kind == INSERT or op.kind == UPDATE:
            model[op.key] = op.value
        elif op.kind == DELETE:
            model.pop(op.key, None)
    return model


def _durable_crash_sweep(kvops: Sequence[KVOp], root, attach, *,
                         committer: str, max_crash_points: int,
                         what: str, group_commit: bool = True,
                         batch: int = 1) -> int:
    """The shared sweep engine: ``attach(backend)`` builds/attaches the
    structure under test (it may itself persist — a crashing bootstrap
    is part of the sweep) and must expose ``apply`` +
    ``check_integrity``.

    ``group_commit`` selects the flush protocol under sweep (the
    coalesced one-fence-per-round path vs the per-op 3k+2-persist
    protocol); ``batch`` applies ops ``batch`` at a time so the
    coalesced path commits real multi-op rounds — the in-flight window
    is then the whole torn round (atomic at the round-record fence:
    either every round winner's effect recovers, or none does)."""
    root = pathlib.Path(root)
    batches = [list(kvops[i:i + batch])
               for i in range(0, len(kvops), batch)]
    # oracle pass on a clean pool: per-op statuses plus the per-batch
    # ROUND composition, so a crash inside batch j has exactly the
    # acceptable states {committed + first r rounds of batch j} — each
    # round is atomic at its (group or per-op) commit fence
    oracle = attach(DurableBackend(pool=PMemPool(root / "oracle"),
                                   committer=committer,
                                   group_commit=group_commit))
    oracle_rounds: List[List[List[Tuple[KVOp, str]]]] = []
    for b in batches:
        res = oracle.apply(b)
        hist = getattr(oracle, "last_history", None)
        if hist is None:
            # no round trace: treat the whole batch as one in-flight unit
            oracle_rounds.append([list(zip(b, [r.status for r in res]))])
        else:
            oracle_rounds.append(
                [[(b[idx], OK) for pos, idx in enumerate(tr.owners)
                  if tr.success[pos]] for tr in hist])
    for crash_at in range(max_crash_points + 1):
        pool = PMemPool(root / f"crash{crash_at}",
                        crash_after_persists=crash_at)
        backend = DurableBackend(pool=pool, committer=committer,
                                 group_commit=group_commit)
        committed: List[Tuple[KVOp, str]] = []
        inflight: Optional[int] = None
        crashed = False
        struct = None
        try:
            struct = attach(backend)
        except SimulatedCrash:
            crashed = True
        if struct is not None:
            for j, b in enumerate(batches):
                try:
                    res = struct.apply(b)
                except SimulatedCrash:
                    inflight = j
                    crashed = True
                    break
                committed.extend(zip(b, (r.status for r in res)))
        # crash (drop unpersisted writes), reopen, recover, re-attach
        recovered = backend.crash()
        items = attach(recovered).check_integrity()   # nothing torn
        base = replay_effects(committed)
        acceptable = [base]
        if inflight is not None:
            rounds = oracle_rounds[inflight]
            for r in range(1, len(rounds) + 1):
                eff = [e for rnd in rounds[:r] for e in rnd]
                acceptable.append(replay_effects(committed + eff))
        if items not in acceptable:
            raise CrashCheckError(
                f"crash_at={crash_at}: recovered {what} {items}, expected "
                f"one of {acceptable} (committed={len(committed)} ops, "
                f"inflight batch={inflight})")
        # teardown WAL hygiene: pruning spent descriptors must not
        # change what a further crash/recover cycle reconstructs
        recovered.prune_completed()
        re2 = recovered.crash()
        struct2 = attach(re2)
        if struct2.check_integrity() != items:
            raise CrashCheckError(
                f"crash_at={crash_at}: prune_completed changed recovery")
        # teardown region hygiene (the word-side analogue): GC-ing
        # unreferenced pair regions must not change the live items,
        # at any crash point — including mid-split residue
        gc = getattr(struct2, "gc_regions", None)
        if gc is not None:
            gc()
            if struct2.check_integrity() != items:
                raise CrashCheckError(
                    f"crash_at={crash_at}: region GC changed live items")
            if attach(re2.crash()).check_integrity() != items:
                raise CrashCheckError(
                    f"crash_at={crash_at}: region GC does not survive a "
                    "further crash/recover cycle")
        if not crashed:
            return crash_at
    raise CrashCheckError(
        f"{what} sweep never completed within {max_crash_points} persists")


def check_durable_crash_sweep(kvops: Sequence[KVOp], n_buckets: int,
                              root, *, committer: str = "wal",
                              max_crash_points: int = 400,
                              group_commit: bool = True,
                              batch: int = 1) -> int:
    """Crash-at-every-persist sweep over a whole logical workload.

    Returns the number of crash points swept (== persists of a clean
    run).  Raises :class:`CrashCheckError` (or
    :class:`repro_torch.structures.TornStructure`) on any torn or lost state.
    ``group_commit``/``batch`` select the flush protocol and the round
    width under sweep (see :func:`_durable_crash_sweep`): with group
    commit and ``batch > 1`` the sweep crosses every persist of the
    COALESCED path, including the torn-round window.
    """
    return _durable_crash_sweep(
        kvops, root, lambda backend: HashMap(backend, n_buckets),
        committer=committer, max_crash_points=max_crash_points,
        what="map", group_commit=group_commit, batch=batch)


def check_hashmap_resize_sweep(kvops: Sequence[KVOp], n_buckets: int,
                               root, *, max_doublings: int = 2,
                               committer: str = "wal",
                               max_crash_points: int = 1200,
                               group_commit: bool = True,
                               batch: int = 1) -> int:
    """Crash-at-every-persist sweep through directory doubling.

    The workload is expected to overflow generation 0 (size it with more
    inserts than ``n_buckets``), so the sweep crosses every persist of
    the decide (MIG_BIT CAS), the pump (4-word moves), the guarded
    split-brain client ops and the finalize swing.  After every crash +
    recovery the re-attached map must pass
    :meth:`HashMap.check_integrity` (pairs untorn in every generation,
    retired generations drained, no key live twice, future arrays
    all-zero — i.e. the table is pre-growth, mid-growth or post-growth,
    never torn) and hold exactly the committed effects; the live items
    are growth-invariant, so the engine's acceptable-state computation
    needs no growth awareness at all.  Returns crash points swept.
    """
    return _durable_crash_sweep(
        kvops, root,
        lambda backend: HashMap(backend, n_buckets,
                                max_doublings=max_doublings),
        committer=committer, max_crash_points=max_crash_points,
        what="elastic map", group_commit=group_commit, batch=batch)


def check_tree_crash_sweep(kvops: Sequence[KVOp], root, *,
                           leaf_cap: int = 2, root_cap: int = 4,
                           n_regions: int = 4, committer: str = "wal",
                           max_crash_points: int = 1200,
                           group_commit: bool = True,
                           device: Union[str, torch.device] = "cuda"
                           ) -> int:
    """Crash-at-every-persist sweep over a multi-node tree workload.

    The workload is expected to drive :class:`BzTreeIndex` through at
    least one leaf split (size it so a leaf overflows), so the sweep
    crosses every persist of freeze, the wide half-materialization and
    the 2-word parent install.  After every crash + recovery the
    re-attached tree must pass :meth:`BzTreeIndex.check_integrity` (no
    torn node, no half-installed parent entry — i.e. the tree is the
    pre-split or the fully-linked post-split one) and hold exactly the
    effects the client saw commit, plus at most the one in-flight op.
    ``device`` holds the trees' region allocators (the durable backend
    itself holds no tensors).  Returns the number of crash points
    swept.
    """
    from .bztree_index import BzTreeIndex

    def _attach(backend):
        return BzTreeIndex(backend, leaf_cap=leaf_cap, root_cap=root_cap,
                           n_regions=n_regions, device=device)

    return _durable_crash_sweep(
        kvops, root, _attach, committer=committer,
        max_crash_points=max_crash_points, what="tree",
        group_commit=group_commit)


def check_sim_crash_sweep(ops: Sequence[MwCASOp], *,
                          algorithm: Union[str, Algorithm] = OURS,
                          crash_steps: Optional[Sequence[int]] = None,
                          n_steps: int = 4000, seed: int = 0,
                          device: Union[str, torch.device] = "cuda") -> int:
    """Sweep simulator crash points over a shadowed structure round.

    ``ops`` is a compiled structure batch (e.g. ``HashMap`` round or
    BzTree inserts); each op becomes one simulated thread executing an
    increment over the op's (compressed) address set.  Every probed step
    is ``SimSession.crash_at`` — recovery from the persisted descriptors
    plus the central crash invariant — and additionally asserts per-op
    atomicity for ops with private addresses.  The crash points run as
    simulations of ONE launch on ``device`` (``"cuda"``, the default: the
    simulator kernel; ``"cpu"``: its plain version).  Returns the number
    of crash points checked.
    """
    from .differential import shadow_batch

    # mixed widths are fine: shadow_batch pads every op to the round's
    # max width with fresh private words (growth rounds batch 4-word
    # moves next to 1-word generation CASes)
    k = max(op.k for op in ops)
    n_shadow, shadow = shadow_batch(ops)
    T = len(shadow)
    table = np.asarray([[list(op.addrs)] for op in shadow], np.int32)

    session = (SimSession().with_algorithm(resolve(algorithm))
               .with_threads(T).with_words(n_shadow).with_k(k)
               .with_max_ops(1).with_steps(n_steps).with_seed(seed)
               .with_ops(table))
    if crash_steps is None:
        rng = np.random.default_rng(seed)
        crash_steps = sorted(set(
            rng.integers(1, n_steps, size=12).tolist()))

    # which shadow addresses belong to exactly one op (private)
    counts: Dict[int, int] = {}
    for op in shadow:
        for a in op.addrs:
            counts[a] = counts.get(a, 0) + 1
    results = run_sims([session.spec(drain=False, cut=int(step))
                        for step in crash_steps], device=device)
    checked = 0
    for step, r in zip(crash_steps, results):
        rec, hist = check_crash_consistency(session.cfg, r.state)
        assert rec.shape == (n_shadow,)
        for op in shadow:
            if any(counts[a] > 1 for a in op.addrs):
                continue                      # shared word: counts mix
            per_word = {int(hist[a]) for a in op.addrs}
            if len(per_word) != 1:
                raise CrashCheckError(
                    f"crash@{step}: op over {op.addrs} committed "
                    f"unevenly: {sorted(per_word)} — torn multi-word op")
        checked += 1
    return checked
