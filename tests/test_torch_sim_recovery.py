"""Crash recovery on the port's simulator against the JAX reference, on
the CPU.

Over the crash grid of ``tests/test_recovery.py::test_crash_sweep``
(every 53rd step of a 1,200-step schedule, four algorithms): the crashed
state bit for bit, ``recover``, ``committed_histogram`` and the verdict
of ``check_crash_consistency`` equal the reference's.  The reference's
fault at ORIGINAL, seed 8016, step 365 (ROADMAP Queue 3) is pinned: both
packages crash to the same state and raise the same ``RecoveryError``.
The port's own sweeps (every crash point of the exhaustive prefix,
``check_sim_crash_sweep``) run as simulations of one ``run_sims`` call.
"""
import functools

import numpy as np
import pytest

import repro.pmwcas as R
import repro.structures as RS
import repro_torch.core as P
import repro_torch.pmwcas as PM
import repro_torch.structures as PS
from repro_torch.core.model import FIELDS

ALGS = [("ours", 3), ("ours_df", 3), ("original", 2), ("pcas", 1)]
PIN = dict(algorithm="original", n_threads=6, n_words=32, k=2, n_steps=600,
           max_ops=16, seed=8016, alpha=1.0)
PIN_MSG = "crash invariant violated at words [15]: recovered=[1] expected=[2]"


def _kw(alg, k, **over):
    kw = dict(algorithm=alg, n_threads=4, n_words=64, k=k, n_steps=1200,
              max_ops=32, seed=3)
    kw.update(over)
    return kw


def _verdict(mod, cfg, state):
    try:
        rec, hist = mod.check_crash_consistency(cfg, state)
    except mod.RecoveryError as e:
        return ("error", str(e))
    return ("ok", rec.tolist(), hist.tolist())


def _same_state(ref, port):
    for f in FIELDS:
        assert np.array_equal(np.asarray(ref[f]).astype(np.int64)
                              if f == "counters" else np.asarray(ref[f]),
                              port[f]), f"field {f} differs"


@pytest.mark.parametrize("alg,k", ALGS)
def test_crash_sweep_recovery_matches(alg, k):
    r_cfg, p_cfg = R.SimConfig(**_kw(alg, k)), P.SimConfig(**_kw(alg, k))
    steps = list(range(1, 1200, 53))
    ports = P.run_sims([(p_cfg, None, None, False, s) for s in steps],
                       device="cpu")
    for step, port in zip(steps, ports):
        ref = R.run_until(r_cfg, step)
        _same_state(ref.state, port.state)
        assert np.array_equal(R.recover(r_cfg, ref.state),
                              P.recover(p_cfg, port.state))
        assert np.array_equal(R.committed_histogram(r_cfg, ref.state),
                              P.committed_histogram(p_cfg, port.state))
        assert _verdict(R, r_cfg, ref.state) == \
            _verdict(P, p_cfg, port.state)
        assert _verdict(P, p_cfg, port.state)[0] == "ok"


def test_pinned_original_fault_is_the_references():
    """ROADMAP Queue 3: the reference's ORIGINAL helper counts a dirty
    installed descriptor word as installed without flushing it; a crash
    at step 365 recovers word 15 to 1 where 2 is committed.  The port
    keeps the reference's semantics and gives the same answer."""
    r_cfg, p_cfg = R.SimConfig(**PIN), P.SimConfig(**PIN)
    ref = R.run_until(r_cfg, 365)
    port = P.run_until(p_cfg, 365, device="cpu")
    _same_state(ref.state, port.state)
    with pytest.raises(R.RecoveryError) as r_err:
        R.check_crash_consistency(r_cfg, ref.state)
    with pytest.raises(P.RecoveryError) as p_err:
        P.check_crash_consistency(p_cfg, port.state)
    assert str(p_err.value) == str(r_err.value) == PIN_MSG
    with pytest.raises(P.RecoveryError, match=r"words \[15\]"):
        PM.SimSession().configure(**PIN).with_device("cpu").crash_at(365)
    # the diagnosis: thread 3 promoted its descriptor into word 15 (dirty
    # in the cache, never flushed), helper 1 persisted Succeeded for it
    st = port.state
    assert int(st["pmem"][15]) >> 3 == 1
    assert int(st["cache"][15]) & 7 == 3          # TAG_DESC_DIRTY
    assert int(st["cache"][15]) >> 3 == int(st["d_ver"][3]) * 6 + 3
    assert int(st["d_state_p"][3]) == 2           # ST_SUCCEEDED persisted


@pytest.mark.parametrize("alg,k", ALGS)
def test_recovery_idempotent(alg, k):
    r_cfg, p_cfg = R.SimConfig(**_kw(alg, k)), P.SimConfig(**_kw(alg, k))
    port = P.run_until(p_cfg, 777, device="cpu")
    rec1 = P.recover(p_cfg, port.state)
    rec2 = P.recover(p_cfg, dict(port.state, pmem=rec1))
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(rec1, R.recover(r_cfg, R.run_until(r_cfg,
                                                             777).state))


@functools.lru_cache(maxsize=None)
def _exhaustive(alg, k):
    cfg = P.SimConfig(**_kw(alg, k, n_words=16, n_steps=400, alpha=1.0))
    return cfg, P.run_sims([(cfg, None, None, False, s)
                            for s in range(1, 400)], device="cpu")


@pytest.mark.parametrize("alg,k", ALGS)
def test_crash_exhaustive_prefix_on_the_port(alg, k):
    """Every crash point 1-399 of the hot schedule, as simulations of one
    ``run_sims`` call, recovers consistently."""
    cfg, results = _exhaustive(alg, k)
    for r in results:
        P.check_crash_consistency(cfg, r.state)


def test_check_sim_crash_sweep_count_matches():
    batch = [R.MwCASOp.increment([a, a + 1], [0, 0]) for a in (0, 2, 4)]
    batch.append(R.MwCASOp.increment([1, 4], [0, 0]))
    p_batch = [PM.MwCASOp.increment(op.addrs, [0] * op.k) for op in batch]
    n_ref = RS.check_sim_crash_sweep(batch, n_steps=1200)
    assert PS.check_sim_crash_sweep(p_batch, n_steps=1200,
                                    device="cpu") == n_ref > 1
    steps = [3, 60, 200]
    assert PS.check_sim_crash_sweep(p_batch, crash_steps=steps,
                                    n_steps=1200, algorithm=PM.OURS_DF,
                                    device="cpu") == len(steps)
