"""The port's ``SimBackend`` and the simulator's place in the
differentials, against the JAX reference on the CPU.

``SimBackend`` (``device="cpu"``: the plain version of the simulator
kernel's backend mode) must give the reference's verdicts, word values
and per-thread counters on ``increment_batch`` seeds for the four
algorithms, on mixed widths with real desired values, and refuse the
same batches (``UnsupportedBatch``, the ``attempt_cap`` errors).  Then
the three-way ``run_differential``, ``run_struct_differential`` with the
simulator for both structures, and ``KVService(backend="sim")`` on a
small stream equal the reference's.  Zero tolerance throughout.
"""
import numpy as np
import pytest

import repro.pmwcas as R
import repro.service as RSV
import repro.structures as RS
import repro_torch.pmwcas as PM
import repro_torch.service as PSV
import repro_torch.structures as PS

TOMBSTONE = 2**32 - 1


def _p_ops(ops):
    return [PM.MwCASOp([(t.addr, t.expected, t.desired) for t in op.targets])
            for op in ops]


def _run_both(n_words, ops, values, **kw):
    rb = R.SimBackend(n_words, values=values, **kw)
    pb = PM.SimBackend(n_words, values=values, device="cpu", **kw)
    rv = [r.success for r in rb.execute(ops)]
    pv = [r.success for r in pb.execute(_p_ops(ops))]
    return rb, pb, rv, pv


@pytest.mark.parametrize("alg,k,seed", [("ours", 2, 0), ("ours_df", 3, 5),
                                        ("original", 2, 0), ("pcas", 1, 5)])
def test_sim_backend_matches_reference(alg, k, seed):
    init, ops = R.increment_batch(32, k, 10, seed=seed)
    rb, pb, rv, pv = _run_both(32, ops, init, algorithm=alg)
    assert rv == pv and any(pv)
    assert np.array_equal(rb.values(), pb.values())
    assert np.array_equal(rb.counters.astype(np.int64), pb.counters)
    # the table carries across batches: a second batch from the new values
    ops2 = [R.MwCASOp.increment(op.addrs, [int(rb.read(a)) for a in op.addrs])
            for op in ops[:3]]
    assert [r.success for r in rb.execute(ops2)] == \
        [r.success for r in pb.execute(_p_ops(ops2))]
    assert np.array_equal(rb.values(), pb.values())


def test_sim_backend_mixed_widths_and_real_values():
    """Mixed widths (pads), real desired values including TOMBSTONE, and
    an (a)-passing loser; the same verdicts, values and counters."""
    values = np.zeros(16, np.uint32)
    values[[1, 4, 9]] = [7, 3, 2**31]
    ops = [R.MwCASOp([(1, 7, 5), (4, 3, TOMBSTONE)]),
           R.MwCASOp([(2, 0, 9)]),
           R.MwCASOp([(4, 3, 3), (6, 0, 1), (9, 2**31, 8)]),
           R.MwCASOp([(10, 0, 2**31 + 5), (11, 0, 1), (12, 0, 2), (13, 0, 3)])]
    for alg in ("ours_df", "original"):
        rb, pb, rv, pv = _run_both(16, ops, values, algorithm=alg)
        assert rv == pv == [True, True, False, True]
        assert np.array_equal(rb.values(), pb.values())
        assert np.array_equal(rb.counters.astype(np.int64), pb.counters)
        assert pb.read(4) == TOMBSTONE


def test_sim_backend_refuses_what_the_reference_refuses():
    values = np.arange(8, dtype=np.uint32)
    cases = [
        ([], {}),                                               # empty
        ([R.MwCASOp([(3, 3, 4), (1, 1, 2)])], {}),              # unsorted
        ([R.MwCASOp([(1, 1, 2)]), R.MwCASOp([(9, 0, 1)])], {}),  # range
        ([R.MwCASOp([(2, 5, 6)])], {}),                         # stale
        ([R.MwCASOp([(2, 2, 9)])], dict(algorithm="pcas")),     # not +1
        ([R.MwCASOp([(1, 1, 2), (2, 2, 3)])], dict(algorithm="pcas")),
    ]
    for ops, kw in cases:
        with pytest.raises(R.UnsupportedBatch) as r_err:
            R.SimBackend(8, values=values, **kw).execute(ops)
        with pytest.raises(PM.UnsupportedBatch) as p_err:
            PM.SimBackend(8, values=values, device="cpu",
                          **kw).execute(_p_ops(ops))
        assert str(p_err.value) == str(r_err.value)
    ops = [R.MwCASOp([(1, 1, 5), (4, 4, 9)]), R.MwCASOp([(2, 2, 3)])]
    for cap, msg in ((1, "read phase did not converge"),
                     (3, "attempt of op 0 did not converge")):
        with pytest.raises(RuntimeError, match=msg):
            R.SimBackend(8, values=values, attempt_cap=cap).execute(ops)
        with pytest.raises(RuntimeError, match=msg):
            PM.SimBackend(8, values=values, attempt_cap=cap,
                          device="cpu").execute(_p_ops(ops))
    b = PM.make_backend("sim", n_words=8, device="cpu")
    assert isinstance(b, PM.SimBackend) and b.name == "sim"
    assert "sim" in PM.BACKEND_FACTORIES
    with pytest.raises(ValueError, match="n_words"):
        PM.make_backend("sim", device="cpu")


@pytest.mark.parametrize("n_words,k,n_ops,seed", [(24, 3, 8, 0),
                                                  (48, 2, 16, 3)])
def test_run_differential_three_way_matches(tmp_path, n_words, k, n_ops,
                                            seed):
    init, ops = R.increment_batch(n_words, k, n_ops, seed=seed)
    ref = R.run_differential(ops, init, durable_root=tmp_path / "r",
                             use_kernel=False)
    port = PM.run_differential(_p_ops(ops), init, durable_root=tmp_path / "p",
                               device="cpu")
    assert list(port.verdicts) == list(ref.verdicts) == \
        ["sim", "kernel", "durable"]
    for name in ref.verdicts:
        assert np.array_equal(port.verdicts[name], ref.verdicts[name])
        assert np.array_equal(port.values[name], ref.values[name])
    assert port.agree and ref.agree
    assert port.summary() == ref.summary()


def test_struct_differential_with_the_simulator_matches(tmp_path):
    """The reference test's native-sim op list: three rounds, each
    replayed on the simulator in both packages (the tree's differential,
    with the simulator, is ``tests/test_torch_bztree.py``'s)."""
    def ops(pkg):
        return ([pkg.KVOp(pkg.INSERT, k, (k << 8) | 1) for k in (2, 6, 10, 14)]
                + [pkg.KVOp(pkg.UPDATE, 2, 123456), pkg.KVOp(pkg.DELETE, 6),
                   pkg.KVOp(pkg.INSERT, 18, 7), pkg.KVOp(pkg.DELETE, 10),
                   pkg.KVOp(pkg.INSERT, 6, 999)])
    for alg in ("ours",):
        ref = RS.run_struct_differential(ops(RS), 8, algorithm=alg,
                                         durable_root=tmp_path / f"r{alg}")
        port = PS.run_struct_differential(ops(PS), 8, algorithm=alg,
                                          durable_root=tmp_path / f"p{alg}",
                                          device="cpu")
        assert port.agree and ref.agree
        assert (port.sim_rounds_checked, port.sim_rounds_skipped) == \
            (ref.sim_rounds_checked, ref.sim_rounds_skipped) == (3, 0)
        assert port.statuses == ref.statuses and port.items == ref.items


def test_kv_service_on_sim_shards_matches(tmp_path):
    """``KVService(backend="sim")``: two hash-map shards on the simulator,
    a seeded mixed stream; futures, items and word tables equal."""
    outs = []
    for pkg, svc_mod, extra in ((RS, RSV, {}), (PS, PSV, dict(device="cpu"))):
        spec = pkg.WorkloadSpec(n_ops=48, n_keys=24, read=0.25, update=0.3,
                                insert=0.35, delete=0.1, alpha=0.9, seed=4)
        svc = svc_mod.KVService(n_shards=2, backend="sim", n_buckets=16,
                                round_cap=8, **extra)
        futs = svc.submit_many(pkg.load_phase(spec, 0.5))
        futs += [svc.submit(op, client=i % 4)
                 for i, op in enumerate(pkg.compile_workload(spec))]
        svc.drain()
        outs.append(([(f.status, f.result.value, f.done_step) for f in futs],
                     svc.items(), [b.values().tolist() for b in svc.backends],
                     svc.stats.steps))
        assert all(b.name == "sim" for b in svc.backends)
    assert outs[0] == outs[1]
