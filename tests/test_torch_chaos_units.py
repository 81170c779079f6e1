"""repro_torch.chaos against repro.chaos on the CPU: the statechart
substrate, the client and fault machines, the history recorder and the
linearizability checker, each fed the same inputs in both packages.

Every comparison is exact: machine traces (byte for byte), the ops a
client draws, the directives a fault machine emits, the checker's
``CheckStats`` and the message of every rejection.  The scenario runs
are in ``tests/test_torch_chaos_scenarios.py``.
"""
import dataclasses

import pytest

import repro.chaos as R
import repro_torch
import repro_torch.chaos as T

PACKAGES = pytest.mark.parametrize("mod", [R, T], ids=["ref", "port"])


# ---------------------------------------------------------------------------
# statechart substrate (tests/test_chaos.py's cases, in both packages)
# ---------------------------------------------------------------------------

def _toggle(mod, seed=0):
    return mod.Machine("t", "off", [
        mod.Transition("off", "flip", "on"),
        mod.Transition("on", "flip", "off"),
        mod.Transition("*", "reset", "off"),
    ], seed)


@PACKAGES
def test_statechart_transitions_and_trace(mod):
    m = _toggle(mod)
    for ev in ("flip", "flip", "noise", "reset"):
        m.post(ev)
    assert m.process() == 3
    assert m.state == "off"
    assert m.trace_lines() == [
        "t:off--flip-->on", "t:on--flip-->off",
        "t:off--noise-->.", "t:off--reset-->off"]


@PACKAGES
def test_statechart_declaration_order_and_guards(mod):
    hits = []
    m = mod.Machine("g", "s", [
        mod.Transition("s", "go", "a", guard=lambda m, e: e.get("n", 0) > 3,
                       action=lambda m, e: hits.append("first")),
        mod.Transition("s", "go", "b",
                       action=lambda m, e: hits.append("second")),
    ], 0)
    m.post("go", n=1)
    m.process()
    assert m.state == "b" and hits == ["second"]
    m2 = mod.Machine("g", "s", m.transitions, 0)
    m2.post("go", n=5)
    m2.process()
    assert m2.state == "a" and hits[-1] == "first"


@PACKAGES
def test_event_payload_access(mod):
    ev = mod.Event("e", {"k": 7})
    assert ev["k"] == 7 and ev.get("missing", 9) == 9


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_machine_rng_draws_match(seed):
    """The machines' generator is numpy's, seeded as the reference's."""
    a, b = _toggle(R, seed), _toggle(T, seed)
    assert a.rng.integers(0, 1 << 30, 64).tolist() == \
        b.rng.integers(0, 1 << 30, 64).tolist()


# ---------------------------------------------------------------------------
# client machines
# ---------------------------------------------------------------------------

@PACKAGES
def test_client_machine_issue_await_cycle(mod):
    spec = mod.ClientSpec(think_lo=0, think_hi=0)
    c = mod.ClientMachine("c0", spec, seed=1)
    c.post("tick", wave=1)
    c.process()
    assert c.state == "await" and c.outbox is not None
    assert 1 <= c.outbox.key <= spec.n_keys
    c.post("tick", wave=2)      # still awaiting: no second issue
    c.process()
    assert c.issued == 1
    c.post("done", status="ok")
    c.process()
    assert c.state == "think"


@PACKAGES
def test_client_spec_rejects_bad_mix(mod):
    with pytest.raises(ValueError, match="sum"):
        mod.ClientSpec(read=0.5, update=0.5, insert=0.1, delete=0.0,
                       scan=0.0)


def _drive_client(mod, spec_kw, seed, waves=80):
    """A scripted session: ticks every wave, the verdict two waves after
    each issue (a crash every 13th), a storm from wave 20 to 35 on the
    last shard and a stall at wave 40.  Returns what the machine did."""
    c = mod.ClientMachine("c3", mod.ClientSpec(**spec_kw), seed=seed)
    ops, issued_at = [], None
    for wave in range(1, waves + 1):
        if wave == 20:
            c.post("storm", shard=c.spec.n_shards - 1)
        if wave == 35:
            c.post("calm")
        if wave == 40:
            c.post("stall", waves=5)
        c.post("tick", wave=wave)
        c.process()
        if c.outbox is not None:
            op, c.outbox = c.outbox, None
            ops.append((wave, op.kind, op.key, op.value))
            issued_at = wave
        if issued_at is not None and wave - issued_at == 2:
            c.post("crashed" if wave % 13 == 0 else "done")
            c.process()
            issued_at = None
    return (c.trace_lines(), ops, c.issued, c.lost_to_crash, c.hot_offset,
            c.think_left)


CLIENT_SPECS = [
    dict(),
    dict(n_keys=32, alpha=1.1, read=0.35, update=0.3, insert=0.2,
         delete=0.1, scan=0.05, storm_bias=0.9, n_shards=2),
    dict(n_keys=24, alpha=0.9, drift_every=8, drift_step=3, n_shards=2),
    dict(n_keys=32, alpha=1.2, drift_every=6, drift_step=5, think_hi=3,
         n_shards=3),
]


@pytest.mark.parametrize("spec_kw", CLIENT_SPECS,
                         ids=["default", "storm", "drift", "drift3"])
@pytest.mark.parametrize("seed", [0, 5])
def test_client_machine_matches_reference(spec_kw, seed):
    ref = _drive_client(R, spec_kw, seed)
    port = _drive_client(T, spec_kw, seed)
    assert ref[1], "the scripted session issued nothing"
    assert port == ref


# ---------------------------------------------------------------------------
# fault machines
# ---------------------------------------------------------------------------

@PACKAGES
def test_fault_machine_crash_schedule_fires_after_first_wave(mod):
    fm = mod.FaultMachine(mod.FaultSpec(kind=mod.CRASH_AT_PERSIST,
                                        n_shards=2, first_wave=3), seed=4)
    fm.post("tick", wave=1)
    fm.process()
    assert fm.state == "idle" and not fm.directives
    fm.post("tick", wave=3)
    fm.process()
    assert fm.state == "armed"
    (kind, shard, ahead), = fm.drain_directives()
    assert kind == "arm_crash" and shard in (0, 1) and ahead >= 0
    fm.post("crash", wave=5)
    fm.process()
    assert fm.state == "idle" and fm.fired == 1 and fm.next_wave > 5


@PACKAGES
def test_fault_machine_storm_start_and_end(mod):
    fm = mod.FaultMachine(mod.FaultSpec(kind=mod.SHARD_STORM, n_shards=2,
                                        first_wave=2, storm_len=3), seed=0)
    fm.post("tick", wave=2)
    fm.process()
    assert fm.state == "storming"
    (kind, _shard), = fm.drain_directives()
    assert kind == "storm"
    fm.post("tick", wave=fm.until)
    fm.process()
    assert fm.state == "calm"
    assert fm.drain_directives() == [("calm",)]


@PACKAGES
def test_fault_spec_rejects_unknown_kind(mod):
    with pytest.raises(ValueError, match="unknown fault kind"):
        mod.FaultSpec(kind="meteor")


def _drive_fault(mod, kind, seed, waves=90):
    """Ticks every wave (a scan in flight on odd waves); an armed trap
    springs three waves after it was armed.  Returns every directive by
    wave, the trace and the counters."""
    fm = mod.FaultMachine(mod.FaultSpec(kind=kind, n_shards=3, n_clients=6,
                                        first_wave=4, gap_lo=5, gap_hi=9,
                                        storm_len=6), seed=seed)
    out, armed_at = [], None
    for wave in range(1, waves + 1):
        fm.post("tick", wave=wave, scans_pending=wave % 2)
        fm.process()
        if fm.state == "armed" and armed_at is None:
            armed_at = wave
        if armed_at is not None and wave - armed_at == 3:
            fm.post("crash", wave=wave)
            fm.process()
            armed_at = None
        out.extend((wave,) + d for d in fm.drain_directives())
    return out, fm.trace_lines(), fm.fired, fm.next_wave, fm.until


@pytest.mark.parametrize("kind", R.FAULT_KINDS)
@pytest.mark.parametrize("seed", [0, 3])
def test_fault_machine_matches_reference(kind, seed):
    ref = _drive_fault(R, kind, seed)
    assert ref[0] and ref[2] > 0, "the fault never fired"
    assert _drive_fault(T, kind, seed) == ref


def test_fault_vocabulary_matches_reference():
    for name in ("ARM_CRASH", "STALL", "STORM", "CALM", "MIGRATE",
                 "ARM_MIG_CRASH", "CRASH_AT_PERSIST", "CRASH_MID_SCAN",
                 "STRAGGLER", "SHARD_STORM", "CRASH_MID_MIGRATION",
                 "EPOCH_BOUNDARY", "FAULT_KINDS"):
        assert getattr(T, name) == getattr(R, name), name


# ---------------------------------------------------------------------------
# history recorder and linearizability checker
# ---------------------------------------------------------------------------

def test_history_recorder_lines_match_reference():
    lines = []
    for mod in (R, T):
        h = mod.HistoryRecorder()
        h.base({2: 20, 1: 10})
        h.invoke(1, "c0", 1, "insert", 3, 30)
        h.complete(1, 1, "ok", None)
        h.crash(2)
        h.adopt(2, {1: 10, 3: 30, 2: 20})
        h.final({3: 30, 1: 10, 2: 20})
        lines.append(h.canonical_lines())
    assert lines[0] == lines[1]
    assert lines[1][0] == '["base",[[1,10],[2,20]]]'


def _history(*events):
    return [("base", [[1, 10], [2, 20]])] + list(events)


GOOD = {
    "read-update-scan": _history(
        ("invoke", 1, "c0", 1, "read", 1, 0),
        ("invoke", 1, "c1", 2, "update", 2, 99),
        ("complete", 1, 1, "ok", 10),
        ("complete", 1, 2, "ok", None),
        ("invoke", 2, "c0", 3, "scan", 1, 0),
        ("complete", 2, 3, "ok", 2),
        ("final", [[1, 10], [2, 99]])),
    "insert-exists-delete": _history(
        ("invoke", 1, "c0", 1, "insert", 2, 7),
        ("invoke", 1, "c1", 2, "delete", 1, 0),
        ("complete", 1, 1, "exists", 20),
        ("complete", 1, 2, "ok", None),
        ("invoke", 2, "c0", 3, "read", 1, 0),
        ("invoke", 2, "c1", 4, "update", 5, 1),
        ("complete", 2, 3, "not_found", None),
        ("complete", 2, 4, "not_found", None),
        ("invoke", 3, "c0", 5, "insert", 4, 40),
        ("complete", 3, 5, "full", None),
        ("final", [[2, 20]])),
    "crash-adopt-without": _history(
        ("invoke", 2, "c0", 1, "insert", 3, 30), ("crash", 2),
        ("adopt", 2, [[1, 10], [2, 20]]), ("final", [[1, 10], [2, 20]])),
    "crash-adopt-with": _history(
        ("invoke", 2, "c0", 1, "insert", 3, 30), ("crash", 2),
        ("adopt", 2, [[1, 10], [2, 20], [3, 30]]),
        ("final", [[1, 10], [2, 20], [3, 30]])),
    "crash-two-inflight": _history(
        ("invoke", 2, "c0", 1, "update", 1, 11),
        ("invoke", 2, "c1", 2, "delete", 1, 0),
        ("invoke", 2, "c2", 3, "read", 2, 0), ("crash", 2),
        ("adopt", 2, [[2, 20]]), ("final", [[2, 20]])),
}


@pytest.mark.parametrize("name", sorted(GOOD))
def test_checker_accepts_like_reference(name):
    ref, port = R.check_history(GOOD[name]), T.check_history(GOOD[name])
    assert ref.ok
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


BAD = {
    "wrong-read-value": _history(
        ("invoke", 1, "c0", 1, "read", 1, 0),
        ("invoke", 1, "c1", 2, "update", 2, 99),
        ("complete", 1, 1, "ok", 11), ("final", [[1, 10], [2, 20]])),
    "read-misses-live": _history(
        ("invoke", 1, "c0", 1, "read", 1, 0),
        ("complete", 1, 1, "not_found", None)),
    "update-misses-live": _history(
        ("invoke", 1, "c1", 2, "update", 2, 99),
        ("complete", 1, 2, "not_found", None)),
    "double-mutation": _history(
        ("invoke", 1, "c0", 1, "update", 1, 5),
        ("invoke", 1, "c1", 2, "update", 1, 6),
        ("complete", 1, 1, "ok", None), ("complete", 1, 2, "ok", None)),
    "final-mismatch": _history(("final", [[1, 10]])),
    "unreachable-adopt": _history(
        ("invoke", 2, "c0", 1, "insert", 3, 30), ("crash", 2),
        ("adopt", 2, [[1, 10], [2, 20], [3, 31]])),
    "scan-miscount": _history(
        ("invoke", 1, "c0", 1, "scan", 2, 0),
        ("complete", 1, 1, "ok", 2)),
    "insert-over-live": _history(
        ("invoke", 1, "c0", 1, "insert", 1, 5),
        ("complete", 1, 1, "ok", None)),
    "completion-without-invocation": _history(
        ("complete", 1, 9, "ok", 1)),
    "never-completed": _history(
        ("invoke", 1, "c0", 1, "read", 1, 0), ("final", [[1, 10], [2, 20]])),
    "unknown-event": _history(("bogus", 1)),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_checker_rejects_like_reference(name):
    with pytest.raises(R.LinearizabilityError) as ref:
        R.check_history(BAD[name])
    with pytest.raises(T.LinearizabilityError) as port:
        T.check_history(BAD[name])
    assert str(port.value) == str(ref.value)
    assert issubclass(T.LinearizabilityError, AssertionError)


# ---------------------------------------------------------------------------
# the families, and what parity with the reference needs of them
# ---------------------------------------------------------------------------

def test_families_match_reference():
    assert list(T.FAMILIES) == list(R.FAMILIES)
    for name in R.FAMILIES:
        for seed, waves in ((0, 60), (3, 17)):
            ref = R.FAMILIES[name](seed=seed, waves=waves)
            port = T.FAMILIES[name](seed=seed, waves=waves)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
    for seed, waves in ((0, 60), (1, 30)):
        assert [dataclasses.asdict(s)
                for s in T.default_scenarios(seed=seed, waves=waves)] == \
            [dataclasses.asdict(s)
             for s in R.default_scenarios(seed=seed, waves=waves)]
    assert [f.name for f in dataclasses.fields(T.Scenario)] == \
        [f.name for f in dataclasses.fields(R.Scenario)]


def test_chaos_slos_match_reference():
    from repro.chaos.driver import CHAOS_SLOS as ref
    from repro_torch.chaos.driver import CHAOS_SLOS as port
    assert [dataclasses.asdict(s) for s in port] == \
        [dataclasses.asdict(s) for s in ref]


@pytest.mark.parametrize("name", sorted(R.FAMILIES))
def test_no_family_prunes_under_epochs_or_checkpoints(name):
    """The port fixes two reference faults of ``prune_completed`` (inside
    an open epoch; under a checkpoint image; ROADMAP Queue 3), so the
    port's traces can equal the reference's only where a scenario never
    prunes with epochs or checkpoints on.  A family that breaks this
    precondition must fail here, not as a trace mismatch."""
    for mod in (R, T):
        sc = mod.FAMILIES[name](seed=0, waves=60)
        if sc.wal_prune_every > 0:
            assert sc.epoch_rounds == 1 and sc.checkpoint_every == 0, (
                f"{sc.name}: prunes every {sc.wal_prune_every} waves with "
                f"epoch_rounds={sc.epoch_rounds}, "
                f"checkpoint_every={sc.checkpoint_every}")


def test_public_surface_matches_reference():
    assert sorted(T.__all__) == sorted(R.__all__)
    import repro
    for name in ("Scenario", "ScenarioDriver", "ChaosReport",
                 "ClientMachine", "ClientSpec", "FaultMachine", "FaultSpec",
                 "Machine", "Transition", "Event", "HistoryRecorder",
                 "check_history", "CheckStats", "LinearizabilityError",
                 "chaos_sweep", "default_scenarios", "run_scenario"):
        assert hasattr(repro, name)
        assert getattr(repro_torch, name) is getattr(T, name), name
    assert repro_torch.chaos is T
