"""The port's ``DurableBackend``, ``run_differential`` and durable crash
sweeps against the JAX package's.

Seeded batches — ``increment_batch``es, and batches with addresses
shared across ops, guard words (desired == expected) and stale guards —
run through ``repro.pmwcas.DurableBackend`` and
``repro_torch.pmwcas.DurableBackend``: verdicts, read values and
``DurabilityStats`` must be equal, and the port's
``KernelBackend(device="cpu")`` must give the durable verdicts, as the
reference's ``run_differential`` requires of its kernel.  The port's
structure sweeps then run at the sizes the reference's own tests use,
with the same outcome.  Every check is exact.
"""
import numpy as np
import pytest
import torch

import repro.pmwcas as ref_pm
import repro.structures as ref_st
import repro_torch.pmwcas as pm
import repro_torch.structures as st


def _guard_batch(rng, n_words, values, n_ops=24, k=3):
    """Ops over a small address range (so ops share addresses), each
    with a guard word: mostly current, sometimes stale; moving words
    mostly current too."""
    ops = []
    for _ in range(n_ops):
        addrs = sorted(rng.choice(n_words, k, replace=False).tolist())
        targets = []
        for j, a in enumerate(addrs):
            cur = int(values[a])
            if j == 0:                                   # the guard word
                exp = cur if rng.random() < 0.8 else cur + 1
                targets.append((a, exp, exp))
            else:
                exp = cur if rng.random() < 0.9 else cur + 2
                targets.append((a, exp, exp + 1))
        ops.append(targets)
    return ops


def _batches(seed, n_batches=4, n_words=12):
    """Seeded rounds as plain target lists (each package builds its own
    ``MwCASOp``s), all drawn against the initial values: the first round
    mostly current, later rounds a mix of current and stale words."""
    rng = np.random.default_rng(seed)
    values = rng.integers(1, 5, n_words)
    return values, [_guard_batch(rng, n_words, values)
                    for _ in range(n_batches)]


def _durable_run(pkg, root, values, batches, **kw):
    b = pkg.DurableBackend(root, **kw)
    b.seed({a: int(v) for a, v in enumerate(values)})
    verdicts, reads = [], []
    for batch in batches:
        res = b.execute([pkg.MwCASOp(t) for t in batch])
        verdicts.append([r.success for r in res])
        reads.append([b.read(a) for a in range(len(values))])
    return b, verdicts, reads


DURABLE_KW = {
    "group": dict(),
    "per_op": dict(group_commit=False),
    "marker": dict(committer="marker"),
    "epoch": dict(epoch_rounds=4, checkpoint_every=2),
}


@pytest.mark.parametrize("mode", sorted(DURABLE_KW))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_durable_backend_matches_reference(tmp_path, mode, seed):
    values, batches = _batches(seed)
    kw = DURABLE_KW[mode]
    ref, ref_v, ref_r = _durable_run(ref_pm, tmp_path / "ref", values,
                                     batches, **kw)
    port, v, r = _durable_run(pm, tmp_path / "port", values, batches, **kw)
    assert (v, r) == (ref_v, ref_r)
    flat = [x for row in v for x in row]
    assert any(flat) and not all(flat)
    assert port.durability_stats.as_row() == ref.durability_stats.as_row()
    assert port.epoch_pending == ref.epoch_pending
    assert port.sync() == ref.sync()
    assert port.checkpoint() == ref.checkpoint()
    assert port.prune_completed() == ref.prune_completed()
    assert port.durability_stats.as_row() == ref.durability_stats.as_row()
    # crash: unpersisted writes dropped, recovered, stats carried over
    stats = port.durability_stats
    rec, ref_rec = port.crash(), ref.crash()
    assert rec.durability_stats is stats
    assert [rec.read(a) for a in range(len(values))] == \
        [ref_rec.read(a) for a in range(len(values))] == r[-1]
    # the kernel's plain version decides each round the same way
    kernel = pm.KernelBackend(values=np.asarray(values, np.uint32),
                              device="cpu")
    for batch, want in zip(batches, v):
        got = [res.success for res in
               kernel.execute([pm.MwCASOp(t) for t in batch])]
        assert got == want


def _triples(ops):
    return [[(t.addr, t.expected, t.desired) for t in op.targets]
            for op in ops]


@pytest.mark.parametrize("k", [2, 4, 16, 32])
def test_run_differential_on_the_cpu(tmp_path, k):
    n_ops = 48
    init, ops = pm.increment_batch(n_ops * k, k, n_ops, seed=k)
    ref_init, ref_ops = ref_pm.increment_batch(n_ops * k, k, n_ops, seed=k)
    assert np.array_equal(init, ref_init)
    assert _triples(ops) == _triples(ref_ops)
    report = pm.run_differential(ops, init, durable_root=tmp_path / "d",
                                 device="cpu")
    assert report.agree, report.summary()
    assert sorted(report.verdicts) == ["durable", "kernel", "sim"]
    v = report.verdicts["kernel"]
    assert np.array_equal(report.verdicts["sim"], v)
    assert v.any() and not v.all()
    # the durable side against the reference's committer on the batch
    durable = ref_pm.DurableBackend(tmp_path / "ref")
    durable.seed({a: int(init[a]) for op in ref_ops for a in op.addrs})
    assert [r.success for r in durable.execute(ref_ops)] == v.tolist()


def test_run_differential_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init, ops = pm.increment_batch(8, 2, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.run_differential(ops, init)


def test_make_backend_durable_and_later_kinds(tmp_path):
    b = pm.make_backend("durable", n_words=99, root=tmp_path / "b")
    assert isinstance(b, pm.DurableBackend) and b.name == "durable"
    assert b.pool.root == tmp_path / "b"
    assert "durable" in pm.BACKEND_FACTORIES
    sim = pm.make_backend("sim", n_words=8, device="cpu")
    assert isinstance(sim, pm.SimBackend) and sim.name == "sim"
    with pytest.raises(ValueError, match="epoch_rounds > 1"):
        pm.DurableBackend(tmp_path / "x", group_commit=False,
                          epoch_rounds=2)
    with pytest.raises(ValueError, match="committer"):
        pm.DurableBackend(tmp_path / "y", committer="nope")
    # the marker baseline has no rounds: group commit quietly off
    assert pm.DurableBackend(tmp_path / "z",
                             committer="marker").group_commit is False


# ---------------------------------------------------------------------------
# the structure sweeps, on the port, at the reference tests' sizes
# ---------------------------------------------------------------------------

def _ops(pkg, spec):
    return [pkg.KVOp(getattr(pkg, kind), key, *val) for kind, key, *val in
            spec]


MAP_OPS = [("INSERT", 5, 100), ("INSERT", 7, 200), ("UPDATE", 5, 111),
           ("DELETE", 7), ("INSERT", 9, 300)]
BATCHED_OPS = [("INSERT", 5, 100), ("INSERT", 7, 200), ("INSERT", 9, 300),
               ("UPDATE", 5, 111), ("INSERT", 12, 400), ("UPDATE", 7, 222)]
RESIZE_OPS = [("INSERT", k, k * 3) for k in range(7, 90, 7)] + \
    [("UPDATE", 14, 999), ("DELETE", 21)]


@pytest.mark.parametrize("group_commit", [False, True])
def test_durable_crash_sweep_on_the_port(tmp_path, group_commit):
    """``tests/test_structures.py::test_hashmap_durable_crash_at_every_
    persist`` on both packages: the same number of crash points."""
    args = dict(n_buckets=8, group_commit=group_commit)
    n = st.check_durable_crash_sweep(_ops(st, MAP_OPS),
                                     root=tmp_path / "port", **args)
    assert n == ref_st.check_durable_crash_sweep(
        _ops(ref_st, MAP_OPS), root=tmp_path / "ref", **args)
    assert n > (20 if not group_commit else 0)


def test_structure_sweep_through_batched_rounds_on_the_port(tmp_path):
    """``tests/test_group_commit.py::test_structure_sweep_through_
    batched_rounds`` on both packages."""
    n = st.check_durable_crash_sweep(_ops(st, BATCHED_OPS), n_buckets=8,
                                     root=tmp_path / "port",
                                     group_commit=True, batch=3)
    assert n == ref_st.check_durable_crash_sweep(
        _ops(ref_st, BATCHED_OPS), n_buckets=8, root=tmp_path / "ref",
        group_commit=True, batch=3)
    assert n >= 2


def test_hashmap_resize_sweep_on_the_port(tmp_path):
    """``tests/test_elastic.py::test_resize_crash_sweep`` on both
    packages: every persist through gen 0 -> 1 -> 2."""
    n = st.check_hashmap_resize_sweep(_ops(st, RESIZE_OPS), 3,
                                      tmp_path / "port", max_doublings=2,
                                      batch=3)
    assert n == ref_st.check_hashmap_resize_sweep(
        _ops(ref_st, RESIZE_OPS), 3, tmp_path / "ref", max_doublings=2,
        batch=3)
    assert n > 10


def test_sweeps_of_later_slices_raise(tmp_path):
    """The tree sweep (ROADMAP Queue 1 #4) and the simulator's sweep
    (Queue 1 #7) both run now; the simulator's refuses an empty batch,
    as the reference's does."""
    ops = [st.KVOp(st.INSERT, k, 10 * k) for k in (5, 3, 9)]
    assert st.check_tree_crash_sweep(ops, tmp_path, device="cpu") > 1
    batch = [pm.MwCASOp.increment([0, 1], [0, 0]),
             pm.MwCASOp.increment([1, 2], [0, 0])]
    assert st.check_sim_crash_sweep(batch, crash_steps=[5, 40, 300],
                                    n_steps=400, device="cpu") == 3
    with pytest.raises(ValueError):
        st.check_sim_crash_sweep([], device="cpu")
    with pytest.raises(st.CrashCheckError):
        raise st.CrashCheckError("exported")
