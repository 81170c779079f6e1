"""The port's cycle-accurate simulator against the JAX reference on the CPU.

The same configs go through ``repro.pmwcas`` (the jitted ``lax.scan``)
and ``repro_torch.pmwcas`` / ``repro_torch.core`` on ``device="cpu"``
(the plain version of the simulator kernel, ``core.engine.Machine``).
The tolerance is zero everywhere: every field of the state (words, line
owners, descriptors, registers, reference counts, counters) bit for bit,
``summary()`` and the drain rounds equal.  The reference's counters are
int32 (x64 off) and compared as int64.  Configs are few and reused, as
each costs the reference a jit compile: a dense alpha = 1 schedule for
each algorithm, ORIGINAL with helping, and 8-byte blocks (false
sharing).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.pmwcas as R
import repro_torch.core as P
import repro_torch.pmwcas as PM
from repro_torch.core import engine
from repro_torch.core.model import FIELDS

CASES = {
    "ours_dense": ("ours", dict(n_threads=4, n_words=64, k=3, n_steps=1200,
                                max_ops=32, seed=3, alpha=1.0)),
    "ours_df_dense": ("ours_df", dict(n_threads=4, n_words=64, k=3,
                                      n_steps=1200, max_ops=32, seed=3,
                                      alpha=1.0)),
    "original_helping": ("original", dict(n_threads=8, n_words=32, k=2,
                                          n_steps=3000, max_ops=32, seed=7,
                                          alpha=1.0)),
    "pcas_dense": ("pcas", dict(n_threads=4, n_words=64, k=1, n_steps=1200,
                                max_ops=32, seed=3, alpha=1.0)),
    "ours_false_sharing": ("ours", dict(n_threads=8, n_words=512, k=1,
                                        n_steps=3000, max_ops=128, seed=7,
                                        alpha=1.0, block_bytes=8)),
}
UNTIL = ("ours_dense", "ours_df_dense", "original_helping", "pcas_dense")
CUTS = (1, 365, 1199)


def _cfgs(name):
    alg, kw = CASES[name]
    return (R.SimConfig(algorithm=alg, **kw),
            P.SimConfig(algorithm=alg, **kw))


@functools.lru_cache(maxsize=None)
def _ref_run(name, cut=None):
    cfg, _ = _cfgs(name)
    return R.run_sim(cfg) if cut is None else R.run_until(cfg, cut)


def _assert_same_state(ref_state, port_state):
    for f in FIELDS:
        r, p = np.asarray(ref_state[f]), np.asarray(port_state[f])
        if f == "counters":
            r = r.astype(np.int64)
        assert r.shape == p.shape, f
        assert np.array_equal(r, p), f"field {f} differs"
        if f not in ("counters",):
            assert r.dtype == p.dtype, f"field {f}: {r.dtype} != {p.dtype}"


@pytest.mark.parametrize("name", list(CASES))
def test_run_sim_drained_whole_state_matches(name):
    ref = _ref_run(name)
    port = P.run_sim(_cfgs(name)[1], device="cpu")
    _assert_same_state(ref.state, port.state)
    assert port.drained and port.drain_rounds == ref.drain_rounds
    assert port.summary() == ref.summary()
    assert np.array_equal(port.expected_histogram(), ref.expected_histogram())
    assert port.percentile_latency_cycles(99) == \
        ref.percentile_latency_cycles(99)
    assert port.mean_latency_cycles() == ref.mean_latency_cycles()
    assert np.array_equal(port.payload_values("cache"),
                          ref.payload_values("cache"))
    assert np.array_equal(port.tags("pmem"), ref.tags("pmem"))


@pytest.mark.parametrize("name", UNTIL)
def test_run_until_whole_state_matches(name):
    _, cfg = _cfgs(name)
    for cut in CUTS:
        port = P.run_until(cfg, cut, device="cpu")
        _assert_same_state(_ref_run(name, cut).state, port.state)
        assert not port.drained and port.drain_rounds == 0


@pytest.mark.parametrize("seed,n_words,k,alpha", [
    (0, 64, 3, 0.0), (3, 64, 3, 1.0), (11, 1 << 12, 1, 1.0),
    (5, 8, 4, 1.0),                   # dense: the resample loop runs
])
def test_generate_ops_and_schedule_match(seed, n_words, k, alpha):
    kw = dict(n_threads=5, n_words=n_words, k=k, max_ops=16, n_steps=999,
              seed=seed, alpha=alpha)
    r_cfg, p_cfg = R.SimConfig(**kw), P.SimConfig(**kw)
    assert np.array_equal(R.generate_ops(r_cfg), P.generate_ops(p_cfg))
    assert np.array_equal(R.generate_schedule(r_cfg),
                          P.generate_schedule(p_cfg))
    assert P.generate_ops(p_cfg).dtype == np.int32
    assert np.array_equal(R.zipf_probs(n_words, alpha),
                          P.zipf_probs(n_words, alpha))


@pytest.mark.parametrize("name,n", [("original_helping", 1000),
                                    ("ours_dense", 365)])
def test_carried_state_continues_to_the_reference(name, n):
    """The reference's state at step n, carried across, continues on the
    port to the end of the schedule and drains to the reference's
    drained state."""
    _, cfg = _cfgs(name)
    st = P.state_from_arrays(cfg, _ref_run(name, n).state, device="cpu")
    sched = P.generate_schedule(cfg)
    port = P.run_state(cfg, st, sched[n:], drain=True)
    ref = _ref_run(name)
    _assert_same_state(ref.state, port.state)
    assert port.drain_rounds == ref.drain_rounds


def test_run_sims_equals_one_run_a_simulation():
    specs = []
    for name in CASES:
        cfg = _cfgs(name)[1]
        specs += [(cfg, None, None, True, None), (cfg, None, None, False, 365)]
    batched = P.run_sims(specs, device="cpu")
    for spec, got in zip(specs, batched):
        cfg, _, _, drain, cut = spec
        alone = (P.run_sim(cfg, device="cpu") if cut is None
                 else P.run_until(cfg, cut, device="cpu"))
        _assert_same_state(alone.state, got.state)
        assert got.drain_rounds == alone.drain_rounds


def test_step_is_one_micro_op():
    """``engine.step`` over the schedule's first 400 entries is
    ``run_until(400)``."""
    _, cfg = _cfgs("original_helping")
    st = P.init_state(cfg, device="cpu")
    for tid in P.generate_schedule(cfg)[:400]:
        engine.step(cfg, st, int(tid))
    _assert_same_state(_ref_run("original_helping", 400).state,
                       P.state_to_arrays(st))


def test_state_carry_across_round_trips():
    _, cfg = _cfgs("ours_dense")
    ref = _ref_run("ours_dense", 365).state
    st = P.state_from_arrays(cfg, ref, device="cpu")
    assert st["cache"].dtype == torch.int32
    assert st["counters"].dtype == torch.int64
    assert st["success"].dtype == torch.bool
    _assert_same_state(ref, P.state_to_arrays(st))
    bad = dict(ref, pmem=np.zeros(7, np.uint32))
    with pytest.raises(ValueError, match="pmem"):
        P.state_from_arrays(cfg, bad, device="cpu")
    words = np.array([0, 1, 2**29 - 1], np.uint32)
    enc = P.model.encode(torch.as_tensor(words.astype(np.int64)), 3)
    v, tag = P.model.decode(enc)
    assert v.tolist() == words.tolist() and tag.tolist() == [3, 3, 3]
    assert P.model.np_encode(5, 2) == 42 and P.model.np_decode(42) == (5, 2)


def test_strategies_match_the_reference():
    assert [a.name for a in PM.STRATEGIES] == [a.name for a in R.STRATEGIES]
    for ra, pa in zip(R.STRATEGIES, PM.STRATEGIES):
        assert dataclasses.asdict(ra) == dataclasses.asdict(pa)
        for k in (1, 2, 3, 4):
            assert ra.cas_per_op(k) == pa.cas_per_op(k)
            assert ra.flush_per_op(k) == pa.flush_per_op(k)
            assert ra.supports_k(k) == pa.supports_k(k)
        assert PM.resolve(pa.name) is pa and str(pa) == pa.name
    with pytest.raises(ValueError, match="unknown algorithm"):
        PM.resolve("nope")


def test_session_builds_the_reference_config():
    def chain(mod):
        return (mod.SimSession().with_algorithm(mod.ORIGINAL).with_threads(6)
                .with_words(96).with_k(2).with_skew(0.5).with_blocks(32)
                .with_steps(700).with_max_ops(8).with_seed(4)
                .with_backoff(2, 64))
    r, p = chain(R), chain(PM)
    assert dataclasses.asdict(r.cfg) == dataclasses.asdict(p.cfg)
    assert r.describe() == p.describe()
    assert p.cfg.n_lines == r.cfg.n_lines
    assert p.cfg.desc_line(3) == r.cfg.desc_line(3)
    assert p.with_device("cpu").device == "cpu" and p.device == "cuda"


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfgs("ours_dense")[1]
    with pytest.raises(RuntimeError, match="cuda"):
        P.run_sim(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PM.SimSession().configure(n_threads=2, n_words=8).run()
    with pytest.raises(RuntimeError, match="cuda"):
        PM.SimBackend(8)
