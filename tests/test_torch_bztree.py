"""The port's BzTree node and multi-node index against the JAX package's.

The same seeded logical streams go through
``repro.structures.BzTreeIndex`` on ``KernelBackend(use_kernel=False)``
(the reference's bit-identical oracle path; one case on the Pallas
kernel in interpret mode) and through ``repro_torch.structures.
BzTreeIndex`` on ``KernelBackend(device="cpu")`` (the kernel's plain
PyTorch version), batch by batch: per-op statuses, values and rounds,
the word tables bit for bit after every batch, the allocator masks, and
the counters ``rounds_run/mwcas_submitted/mwcas_won/splits/root_splits/
consolidations`` must be equal.  Then the protocol itself: exactly two
MwCAS rounds per split (root and non-root), the invisible pre-entry, a
pending split completed after a durable crash, region GC, the tree's
crash-at-every-persist sweep (same crash-point count as the reference)
and ``run_struct_differential`` for both structures.  Every check is
exact.
"""
import dataclasses

import numpy as np
import pytest

import repro.pmwcas as ref_pm
import repro.structures as ref_st
import repro_torch.pmwcas as pm
import repro_torch.structures as st

COUNTERS = ("rounds_run", "mwcas_submitted", "mwcas_won", "splits",
            "root_splits", "consolidations")


def _kernel(pkg, n_words):
    if pkg is ref_st:
        return ref_pm.KernelBackend(n_words=n_words, use_kernel=False)
    return pm.KernelBackend(n_words=n_words, device="cpu")


def _tree(pkg, backend=None, **shape):
    shape = {**dict(leaf_cap=4, root_cap=4, n_regions=24), **shape}
    if backend is None:
        backend = _kernel(pkg, pkg.BzTreeIndex.words_needed(**shape))
    kw = {} if pkg is ref_st else dict(device="cpu")
    return pkg.BzTreeIndex(backend, **shape, **kw)


def _ops(pkg, ops):
    return [pkg.KVOp(*op) for op in ops]


def _results(res):
    return [(r.status, r.value, r.rounds) for r in res]


def _same_tree(ref, port):
    assert np.array_equal(port.backend.values(), ref.backend.values())
    assert np.array_equal(port.allocator.mask(), ref.allocator.mask())
    assert [getattr(port, c) for c in COUNTERS] == \
        [getattr(ref, c) for c in COUNTERS]
    assert port.check_integrity() == ref.check_integrity()


def _targets(ops):
    """Ops as plain (addr, expected, desired) tuples: the two packages'
    ``Target`` classes never compare equal to each other."""
    return [[(t.addr, t.expected, t.desired) for t in op.targets]
            for op in ops]


def _same_history(ref, port):
    assert len(port.last_history) == len(ref.last_history)
    for a, b in zip(ref.last_history, port.last_history):
        assert _targets(a.ops) == _targets(b.ops)
        assert a.owners == b.owners
        assert np.asarray(a.success).tolist() == b.success.tolist()


# ---------------------------------------------------------------------------
# the node
# ---------------------------------------------------------------------------

def test_node_ops_and_split_match():
    """``SortedNode`` inserts (single and batched), the full/frozen/exists
    verdicts, the one-wide-MwCAS split and the pointer swing."""
    out = []
    for pkg in (ref_st, st):
        kb = _kernel(pkg, 64)
        node = pkg.SortedNode(kb, base=0, capacity=4)
        got = [node.insert(42), node.insert(7), node.insert(7)]
        got += node.insert_batch([19, 3, 8])
        got += [node.insert(50), node.count, node.frozen]
        left, right, sep = node.split(10, 20)
        got += [node.frozen, node.insert(60), left.keys(), right.keys(), sep,
                left.insert(15), pkg.swap_pointer(kb, 50, 0, left.base),
                pkg.read_pointer(kb, 50),
                pkg.swap_pointer(kb, 50, 0, right.base)]
        with pytest.raises(pkg.SplitError):
            node.split(10, 30)                 # the left region is dirty
        out.append((got, kb.values().tolist()))
    assert out[0] == out[1]
    assert st.FROZEN_BIT == ref_st.FROZEN_BIT == 1 << 31
    assert st.COUNT_MASK == ref_st.COUNT_MASK
    with pytest.raises(ValueError, match="capacity"):
        st.SortedNode(None, 0, 1)


def test_node_on_durable_backend_matches(tmp_path):
    out = []
    for pkg, sub in ((ref_pm, "ref"), (pm, "port")):
        db = pkg.DurableBackend(tmp_path / sub)
        spkg = ref_st if pkg is ref_pm else st
        node = spkg.SortedNode(db, base=0, capacity=4)
        sts = node.insert_batch([42, 7, 19, 23])
        left, right, sep = node.split(10, 20)
        db2 = db.crash()
        out.append((sts, sep, spkg.SortedNode(db2, 10, 4).keys(),
                    spkg.SortedNode(db2, 20, 4).keys(),
                    spkg.SortedNode(db2, 0, 4).frozen,
                    db.durability_stats.as_row()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the index under seeded workloads
# ---------------------------------------------------------------------------

MIXES = {"A": ref_st.YCSB_A, "B": ref_st.YCSB_B, "C": ref_st.YCSB_C,
         "E": ref_st.YCSB_E,
         "insert_heavy": ref_st.WorkloadSpec(read=0.1, update=0.1,
                                             insert=0.6, delete=0.15,
                                             scan=0.05)}


def _stream(pkg, mix, seed):
    spec = getattr(pkg, "WorkloadSpec")(**dataclasses.asdict(
        dataclasses.replace(MIXES[mix], n_ops=64, n_keys=48, seed=seed,
                            batch=8, alpha=0.9)))
    return (list(pkg.batches(pkg.load_phase(spec), spec.batch))
            + list(pkg.batches(pkg.compile_workload(spec), spec.batch)))


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", (3, 11))
def test_index_under_ycsb_matches(mix, seed):
    """Batch by batch: identical results, tables, masks and counters;
    the stream grows the tree to height 3 through root splits."""
    ref, port = _tree(ref_st), _tree(st)
    for b_ref, b_port in zip(_stream(ref_st, mix, seed),
                             _stream(st, mix, seed)):
        assert _results(port.apply(b_port)) == _results(ref.apply(b_ref))
        _same_history(ref, port)
        _same_tree(ref, port)
    assert port.height() == ref.height() >= 3
    assert port.root_splits == ref.root_splits >= 2
    for k in range(1, 49):
        assert port.lookup(k) == ref.lookup(k)
    assert port.items() == ref.items()
    assert port.leaf_bases() == ref.leaf_bases()


def test_scan_count_matches_the_entry_walk():
    """SCAN's numpy count equals the reference's per-entry walk, also on
    a snapshot whose leaf count runs past the capacity (a torn image:
    the port then walks entry by entry, as the reference does)."""
    ref, port = _tree(ref_st), _tree(st)
    ops = [(ref_st.INSERT, k, k) for k in range(3, 60, 4)]
    ref.apply(_ops(ref_st, ops))
    port.apply(_ops(st, ops))
    snap = port.snapshot()
    leaf = port.leaf_bases()[1]
    torn = snap.copy()
    torn[leaf] += port.leaf_cap + 2            # count past the capacity
    for s in (snap, torn):
        for key in (1, 17, 30, 59, 200):
            r = ref.compile_op(ref_st.KVOp(ref_st.SCAN, key), s.copy())
            p = port.compile_op(st.KVOp(st.SCAN, key), s.copy())
            assert (p.status, p.value) == (r.status, r.value)
    assert sorted(port.live_keys(snap).tolist()) == sorted(port.items())
    with pytest.raises(ValueError, match="2\\^31"):
        port.compile_op(st.KVOp(st.SCAN, 1 << 31), snap)


def _corrupt(tree, snap, how):
    """A copy of ``snap`` with one routing or leaf invariant broken."""
    bad = snap.copy()
    root = tree.root_base(snap) - tree.base
    leaf = tree.leaf_bases(snap)[2] - tree.base
    if how == "count_past_cap":
        bad[leaf] += tree.leaf_cap + 3
    elif how == "duplicate_separator":
        bad[root + 2 + 2] = bad[root + 2]
    elif how == "separator_out_of_order":
        bad[root + 2] = bad[root + 2 + 2] + 5
    elif how == "zero_child":
        bad[root + 3] = 0
    elif how == "duplicate_live_key":
        bad[leaf + 2] = bad[leaf + 1]
    elif how == "dead_and_live_twin":
        bad[leaf + 2] = bad[leaf + 1]
        bad[leaf + 1 + tree.leaf_cap + 1] = st.LEAF_DEAD
    return bad


@pytest.mark.parametrize("how", ("intact", "count_past_cap",
                                 "duplicate_separator",
                                 "separator_out_of_order", "zero_child",
                                 "duplicate_live_key", "dead_and_live_twin"))
def test_compile_ops_equals_compile_op(how):
    """The batch compiler gives ``compile_op``'s objects op for op — on a
    sound snapshot (numpy routing) and on snapshots with a broken
    invariant (where it falls back or the gathers must still agree) —
    and the reference's ``compile_op`` gives the same."""
    ref, port = _tree(ref_st, root_cap=8), _tree(st, root_cap=8)
    ops = [(ref_st.INSERT, k, 3 * k) for k in range(2, 120, 3)]
    ref.apply(_ops(ref_st, ops))
    port.apply(_ops(st, ops))
    snap = _corrupt(port, port.snapshot(), how)
    rng = np.random.default_rng(len(how))
    kinds = (st.READ, st.INSERT, st.UPDATE, st.DELETE, st.SCAN)
    batch = [(kinds[int(rng.integers(5))], int(rng.integers(1, 130)),
              int(rng.integers(1, 99))) for _ in range(300)]

    def norm(c):
        if isinstance(c, (st.StructResult, ref_st.StructResult)):
            return ("result", c.status, c.value)
        if isinstance(c, (st.NeedsSplit, ref_st.NeedsSplit)):
            return ("split", c.leaf_base)
        return ("op",) + tuple(map(tuple, _targets([c])[0]))

    def each(tree, pkg, mode):
        out = []
        if mode == "batch":
            gen = tree.compile_ops(_ops(pkg, batch), snap.copy())
            while True:
                try:
                    out.append(norm(next(gen)))
                except StopIteration:
                    return out
                except Exception as e:           # same error, same place
                    return out + [type(e).__name__]
        for op in _ops(pkg, batch):
            try:
                out.append(norm(tree.compile_op(op, snap.copy())))
            except Exception as e:
                return out + [type(e).__name__]
        return out

    want = each(ref, ref_st, "single")
    assert each(port, st, "single") == want
    assert each(port, st, "batch") == want
    assert len(want) > 1


@pytest.mark.parametrize("round_cap", (2, 5, 64))
def test_leaf_claims_form_the_same_rounds(round_cap):
    """``compile_ops(..., defer_same_leaf=True)`` yields a ``LeafClaim``
    exactly where a leaf's second or later CAS op stands, and the
    service's round former (conflict-defer, round cap) schedules, defers
    and holds back the same entries as with the full ops."""
    import repro_torch.service as svc_mod
    port = _tree(st, root_cap=8)
    port.apply(_ops(st, [(st.INSERT, k, k) for k in range(2, 200, 5)]
                    + [(st.DELETE, k) for k in range(7, 200, 35)]))
    snap = port.snapshot()
    rng = np.random.default_rng(round_cap)
    kinds = (st.INSERT, st.INSERT, st.UPDATE, st.DELETE, st.READ)
    ops = _ops(st, [(kinds[int(rng.integers(5))], int(rng.integers(1, 210)),
                     int(rng.integers(1, 99))) for _ in range(400)])
    full = list(port.compile_ops(ops, snap))
    lean = list(port.compile_ops(ops, snap, defer_same_leaf=True))
    seen = set()
    n_claims = 0
    for f, c in zip(full, lean):
        if isinstance(c, st.bztree_index.LeafClaim):
            n_claims += 1
            assert isinstance(f, pm.MwCASOp) and c.leaf_base in seen
            assert c.addrs == (f.targets[0].addr,)
        else:
            assert c == f
            if isinstance(f, pm.MwCASOp):
                seen.add(f.targets[0].addr)
    assert n_claims > 20

    class Entry:
        def __init__(self, i, local):
            self.i, self.local = i, local

    forms = []
    for compiled in (full, lean):
        q = [Entry(i, c) for i, c in enumerate(compiled)
             if isinstance(c, (pm.MwCASOp, st.bztree_index.LeafClaim))]
        rounds, left, defers, overs = svc_mod.build_rounds({0: q}, round_cap)
        forms.append(([e.i for e in rounds.get(0, [])],
                      [e.i for e in left.get(0, [])], defers, overs))
    assert forms[0] == forms[1]


@pytest.mark.parametrize("case", ("revive_and_consolidate",
                                  "region_exhaustion"))
def test_consolidation_revive_and_exhaustion_match(case):
    """Deletes, in-place revival and a consolidation (a full leaf with
    < 2 live keys); region exhaustion (FULL, the leaf not wedged)."""
    I, D, U, R = ref_st.INSERT, ref_st.DELETE, ref_st.UPDATE, ref_st.READ
    if case == "revive_and_consolidate":
        shape = dict(leaf_cap=2, root_cap=2, n_regions=5)
        stream = ([(I, 5, 50), (I, 3, 30)], [(D, 5)], [(I, 5, 55)],
                  [(D, 5), (D, 3)], [(I, 7, 70)], [(R, 7)])
    else:
        shape = dict(leaf_cap=2, root_cap=4, n_regions=1)
        stream = ([(I, 5, 50), (I, 3, 30)], [(I, 9, 90)], [(U, 5, 55)],
                  [(D, 3)])
    ref, port = _tree(ref_st, **shape), _tree(st, **shape)
    statuses = []
    for batch in stream:
        res = _results(port.apply(_ops(st, batch)))
        assert res == _results(ref.apply(_ops(ref_st, batch)))
        _same_tree(ref, port)
        statuses += [r[0] for r in res]
    if case == "revive_and_consolidate":
        assert port.consolidations == 1 and port.splits == 0
    else:
        assert statuses[2] == st.FULL and statuses[3:] == [st.OK, st.OK]


# ---------------------------------------------------------------------------
# the split protocol
# ---------------------------------------------------------------------------

def _record(tree):
    executed = []
    real = tree.backend.execute
    tree.backend.execute = lambda ops: (executed.append(
        [op.k for op in ops]), real(ops))[1]
    return executed


@pytest.mark.parametrize("root", (True, False))
def test_split_is_exactly_two_rounds(root):
    """``test_tree_split_is_exactly_two_mwcas_rounds`` and its non-root
    twin on both packages: freeze, ONE wide op, ONE 2-word swing, then
    the retried insert — the same widths batch by batch."""
    widths = []
    for pkg in (ref_st, st):
        t = _tree(pkg, leaf_cap=2, root_cap=4, n_regions=4)
        pre = [(pkg.INSERT, 5, 50), (pkg.INSERT, 3, 30)]
        if not root:
            pre.append((pkg.INSERT, 9, 90))
        t.apply(_ops(pkg, pre))
        executed = _record(t)
        (r,) = t.apply(_ops(pkg, [(pkg.INSERT, 9 if root else 8, 80)]))
        assert r.status == pkg.OK
        widths.append((executed, t.splits, t.root_splits))
    want = ([[1], [2 * 3 + 4 + 1], [2], [3]], 1, 1) if root else \
        ([[1], [2 * 3 + 2], [2], [3]], 2, 1)
    assert widths[0] == widths[1] == want


def test_pre_entry_invisible_until_install():
    out = []
    for pkg in (ref_st, st):
        t = _tree(pkg, leaf_cap=2, root_cap=4, n_regions=6)
        t.apply(_ops(pkg, [(pkg.INSERT, k, 10 * k) for k in (5, 3, 9)]))
        root, n = t.root_base(), t.root_count()
        before = t.check_integrity()
        leaf = pkg.LeafNode(t.backend, t.leaf_bases()[1], 2)
        (grant,) = t.allocator.alloc([1])
        pair = t.allocator.region(grant[0])
        sep = leaf.keys()[1]
        leaf.split(pair, pair + t.leaf_words,
                   extra_targets=[(t.sep_addr(n), 0, sep),
                                  (t.child_addr(n), 0, pair + t.leaf_words)])
        seen = [t.root_count(), t.check_integrity() == before]
        seen += [t._install(root, n, sep, pair + t.leaf_words),
                 t.root_count(), t.check_integrity() == before,
                 t.leaf_bases()]
        out.append((seen, t.backend.values().tolist()))
    assert out[0] == out[1]
    assert out[1][0][:2] == [1, True] and out[1][0][3] == 2


@pytest.mark.parametrize("root", (True, False))
def test_pending_split_completed_after_durable_crash(tmp_path, root):
    """Round 1 by hand, then a crash before round 2: the re-attached tree
    is the pre-split one, and the next insert completes the split from
    persisted state alone — identically in both packages."""
    out = []
    for pkg, ppkg in ((ref_st, ref_pm), (st, pm)):
        kw = dict(leaf_cap=2, root_cap=4, n_regions=4 if root else 6)
        db = ppkg.DurableBackend(tmp_path / pkg.__name__)
        t = _tree(pkg, db, **kw)
        t.apply(_ops(pkg, [(pkg.INSERT, 5, 50), (pkg.INSERT, 3, 30)]
                     + ([] if root else [(pkg.INSERT, 9, 90)])))
        leaf = pkg.LeafNode(db, t.root_base() if root
                            else t.leaf_bases()[1], 2)
        (grant,) = t.allocator.alloc([1])
        region = t.allocator.region(grant[0])
        left, right = region, region + t.leaf_words
        sep = leaf.keys()[1]
        if root:
            new_root = region + 2 * t.leaf_words
            extra = [(new_root, 0, 1 | pkg.INNER_BIT), (new_root + 1, 0, left),
                     (new_root + 2, 0, sep), (new_root + 3, 0, right),
                     (t.pending_addr, 0, new_root)]
        else:
            n = t.root_count()
            extra = [(t.sep_addr(n), 0, sep), (t.child_addr(n), 0, right)]
        leaf.split(left, right, extra_targets=extra)
        before = t.check_integrity()
        t2 = _tree(pkg, db.crash(), **kw)
        seen = [t2.root_base(), int(t2.backend.read(t2.pending_addr)),
                t2.check_integrity() == before, t2.allocator.mask().tolist()]
        (r,) = t2.apply(_ops(pkg, [(pkg.INSERT, 7 if not root else 9, 70)]))
        seen += [r.status, t2.root_base(), t2.root_count(),
                 int(t2.backend.read(t2.pending_addr)),
                 t2.check_integrity(), t2.splits, t2.root_splits,
                 t2.mwcas_submitted, t2.mwcas_won]
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][4] == st.OK


def test_region_gc_counts_match(tmp_path):
    """GC of frozen originals (auto-GC inside ``ensure_room`` at region
    exhaustion, then explicit passes), and GC after a durable crash."""
    out = []
    for pkg, ppkg in ((ref_st, ref_pm), (st, pm)):
        t = _tree(pkg, leaf_cap=2, root_cap=8, n_regions=3)
        res = t.apply(_ops(pkg, [(pkg.INSERT, k, k)
                                 for k in (10, 20, 30, 40)]))
        seen = [_results(res), t.allocator.n_free]
        seen.append(_results(t.apply(_ops(pkg, [(pkg.INSERT, 50, 50)]))))
        seen += [t.gc_regions(), t.gc_regions(), t.check_integrity(),
                 t.allocator.mask().tolist(), t.backend.values().tolist()]
        db = ppkg.DurableBackend(tmp_path / pkg.__name__)
        t = _tree(pkg, db, leaf_cap=2, root_cap=4, n_regions=4)
        t.apply(_ops(pkg, [(pkg.INSERT, k, k) for k in (5, 3, 9, 7)]))
        t2 = _tree(pkg, db.crash(), leaf_cap=2, root_cap=4, n_regions=4)
        seen += [t2.allocator.mask().tolist(), t2.gc_regions(),
                 t2.check_integrity()]
        t3 = _tree(pkg, db.crash().crash(), leaf_cap=2, root_cap=4,
                   n_regions=4)
        seen += [t3.check_integrity(), t3.allocator.n_free]
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][9] >= 1                  # GC after the crash freed some


def test_tree_on_the_pallas_kernel():
    """One splitting stream with the reference on its Pallas kernel in
    interpret mode (as ``test_tree_on_real_pallas_kernel`` runs it)."""
    n = ref_st.BzTreeIndex.words_needed(2, 4, 4)
    ref = ref_st.BzTreeIndex(ref_pm.KernelBackend(n_words=n, use_kernel=True),
                             leaf_cap=2, root_cap=4, n_regions=4)
    port = _tree(st, leaf_cap=2, root_cap=4, n_regions=4)
    ops = [(ref_st.INSERT, k, 10 * k) for k in (5, 3, 9)]
    assert _results(port.apply(_ops(st, ops))) == \
        _results(ref.apply(_ops(ref_st, ops)))
    _same_tree(ref, port)
    assert port.splits == 1


# ---------------------------------------------------------------------------
# crash sweep and differential
# ---------------------------------------------------------------------------

SWEEP_OPS = [("insert", 5, 50), ("insert", 3, 30), ("insert", 9, 90),
             ("update", 5, 55), ("delete", 3)]


@pytest.mark.parametrize("group_commit", (False, True))
def test_tree_crash_sweep_same_crash_points(tmp_path, group_commit):
    """``test_tree_crash_sweep_through_split`` on both packages: every
    persist through freeze, wide materialization and install, per-op and
    group commit, with the same number of crash points."""
    kw = dict(leaf_cap=2, root_cap=4, n_regions=4, group_commit=group_commit)
    n_ref = ref_st.check_tree_crash_sweep(_ops(ref_st, SWEEP_OPS),
                                          tmp_path / "ref", **kw)
    n_port = st.check_tree_crash_sweep(_ops(st, SWEEP_OPS),
                                       tmp_path / "port", device="cpu", **kw)
    assert n_port == n_ref
    assert n_port > (40 if not group_commit else 0)


def test_tree_crash_sweep_through_root_split(tmp_path):
    """A longer stream through a root split of an inner root (height 3)."""
    ops = [("insert", k, k) for k in (10, 20, 30, 40, 50, 60, 70, 15)]
    kw = dict(leaf_cap=2, root_cap=2, n_regions=12)
    n_port = st.check_tree_crash_sweep(_ops(st, ops), tmp_path / "port",
                                       device="cpu", **kw)
    assert n_port == ref_st.check_tree_crash_sweep(_ops(ref_st, ops),
                                                   tmp_path / "ref", **kw)


def _report_key(rep):
    return (rep.statuses, rep.items, rep.rounds, rep.agree)


@pytest.mark.parametrize("mix", ("A", "E", "insert_heavy"))
def test_struct_differential_bztree_matches(tmp_path, mix):
    spec = dataclasses.replace(MIXES[mix], n_ops=24, n_keys=12, seed=13,
                               batch=4)
    ops = ref_st.load_phase(spec) + ref_st.compile_workload(spec)
    kw = dict(structure="bztree", leaf_cap=2, root_cap=8, n_regions=16)
    ref = ref_st.run_struct_differential(ops, durable_root=tmp_path / "r",
                                         **kw)
    port = st.run_struct_differential(_ops(st, [(o.kind, o.key, o.value)
                                                for o in ops]),
                                      durable_root=tmp_path / "p",
                                      device="cpu", **kw)
    assert port.agree and ref.agree
    assert _report_key(port) == _report_key(ref)
    assert port.sim_rounds_checked == ref.sim_rounds_checked > 0
    assert port.sim_rounds_skipped == ref.sim_rounds_skipped
    tree = port.structs["kernel"]
    assert tree.splits >= 1
    assert st.replay_rounds(tree.last_history, device="cpu") == \
        (len(tree.last_history), True)


@pytest.mark.parametrize("max_doublings", (0, 2))
def test_struct_differential_hashmap_matches(tmp_path, max_doublings):
    spec = ref_st.WorkloadSpec(n_ops=40, n_keys=20, read=0.3, update=0.3,
                               insert=0.3, delete=0.1, seed=5, batch=8)
    ops = ref_st.load_phase(spec) + ref_st.compile_workload(spec)
    n_buckets = 8 if max_doublings else 32
    ref = ref_st.run_struct_differential(
        ops, n_buckets, durable_root=tmp_path / "r",
        max_doublings=max_doublings)
    port = st.run_struct_differential(
        _ops(st, [(o.kind, o.key, o.value) for o in ops]), n_buckets,
        durable_root=tmp_path / "p", device="cpu",
        max_doublings=max_doublings)
    assert _report_key(port) == _report_key(ref)
    assert port.agree
    assert (port.sim_rounds_checked, port.sim_rounds_skipped) == \
        (ref.sim_rounds_checked, ref.sim_rounds_skipped)


def test_struct_differential_refuses_the_simulator():
    """The simulator is ported: the differential replays every round on
    it and refuses only what the reference refuses (an unknown algorithm
    or structure); the simulator's crash sweep refuses an empty batch."""
    ops = [st.KVOp(st.INSERT, 3, 30), st.KVOp(st.UPDATE, 3, 31)]
    rep = st.run_struct_differential(ops, 4, algorithm="ours_df",
                                     device="cpu")
    assert rep.agree and rep.sim_rounds_checked >= 1
    with pytest.raises(ValueError, match="unknown algorithm"):
        st.run_struct_differential(ops, 4, algorithm="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown structure"):
        st.run_struct_differential([], 4, structure="skiplist", device="cpu")
    with pytest.raises(ValueError):
        st.check_sim_crash_sweep([], device="cpu")


def test_verdict_helpers_and_shadow_batch_match():
    rng = np.random.default_rng(9)
    for _ in range(20):
        raw = [sorted(rng.choice(12, int(rng.integers(1, 4)),
                                 replace=False).tolist()) for _ in range(6)]
        ops = {pkg: [pkg_pm.MwCASOp([(a, 0, 1) for a in addrs])
                     for addrs in raw]
               for pkg, pkg_pm in ((ref_st, ref_pm), (st, pm))}
        for fn in ("conservative_verdicts", "winner_blocking_verdicts"):
            assert getattr(st, fn)(ops[st]).tolist() == \
                getattr(ref_st, fn)(ops[ref_st]).tolist()
        n_r, sh_r = ref_st.shadow_batch(ops[ref_st])
        n_p, sh_p = st.shadow_batch(ops[st])
        assert n_p == n_r
        assert _targets(sh_p) == _targets(sh_r)
