"""repro_torch.chaos scenarios against repro.chaos on the CPU.

Each of the seven families runs in both packages at the reference
tests' reduced sizes (50 waves; 40 for the extra seeds of
``drifting_skew`` and ``crash_mid_migration``; 12 for ``sim_native``),
the port with ``device="cpu"`` (the plain versions of the kernels).
Compared exactly: the canonical trace (every machine's statechart trace
and every history event, byte for byte), the final items, every integer
of ``ChaosReport`` and the ``CheckStats``.  The SLO block depends on
the wall clock, so only its structure is compared: the section, the
spec names, kinds and bounds, the evaluation counts and the windows.

Crash traps are armed ``persist_count + delta`` ahead, so the traces
agree only if the port's durable shards issue the reference's persists
one for one through migrations, epochs, prunes and crashes.
"""
import dataclasses
import importlib.util
import pathlib

import pytest

import repro.chaos as R
import repro_torch.chaos as T
from repro_torch.obs import (disable_tracing, enable_tracing, get_tracer,
                             validate_slo_report)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _run(mod, scenario, tmp_path, sub):
    root = tmp_path / sub if scenario.backend == "durable" else None
    kw = {"device": "cpu"} if mod is T else {}
    driver = mod.ScenarioDriver(scenario, durable_root=root, **kw)
    return driver, driver.run()


def _slo_shape(slo):
    return (slo["section"], slo["observations"], slo["windows"],
            [(s["name"], s["metric"], s["kind"], s["bound"],
              s["error_budget"], s["evaluations"]) for s in slo["specs"]])


def _assert_same(ref, port):
    assert ref.check.ok, ref.summary()
    # trace lines, final items, every integer and the checker's stats
    assert chip_smoke.chaos_mismatch(port, ref) == []
    validate_slo_report(port.slo)
    assert _slo_shape(port.slo) == _slo_shape(ref.slo)
    assert port.summary().split(" — ")[1] == ref.summary().split(" — ")[1]


CASES = [(name, 0, 12 if name == "sim_native" else 50)
         for name in R.FAMILIES]
CASES += [(name, seed, 40) for name in ("drifting_skew",
                                        "crash_mid_migration")
          for seed in (1, 3)]


@pytest.mark.parametrize("family, seed, waves", CASES,
                         ids=[f"{f}-s{s}-w{w}" for f, s, w in CASES])
def test_family_matches_reference(family, seed, waves, tmp_path):
    ref = R.FAMILIES[family](seed=seed, waves=waves)
    port = T.FAMILIES[family](seed=seed, waves=waves)
    _, a = _run(R, ref, tmp_path, "ref")
    _, b = _run(T, port, tmp_path, "port")
    _assert_same(a, b)
    if port.backend == "durable" and family != "epoch_boundary":
        assert b.crashes >= 1, "the family must cover crash/recover"


@pytest.mark.parametrize("waves", [20, 60])
def test_kernel_storm_matches_reference(waves, tmp_path):
    _, a = _run(R, chip_smoke.kernel_storm(R, 0, waves), tmp_path, "ref")
    _, b = _run(T, chip_smoke.kernel_storm(T, 0, waves), tmp_path, "port")
    _assert_same(a, b)
    assert b.crashes == 0 and b.faults_fired >= 1


def test_kernel_shards_refuse_crash(tmp_path):
    driver, _ = _run(T, chip_smoke.kernel_storm(T, 0, 6), tmp_path, "port")
    with pytest.raises(TypeError):
        driver.svc.crash()


# ---------------------------------------------------------------------------
# the port's own runs: tamper, determinism, accounting (tests/test_chaos.py)
# ---------------------------------------------------------------------------

def test_checker_rejects_tampered_port_history(tmp_path):
    """Tamper with one completed verdict of a real port run: the checker
    must notice."""
    driver, rep = _run(T, T.hot_key_storm(seed=0, waves=30), tmp_path, "t")
    assert rep.check.ok and rep.crashes >= 1
    events = list(driver.recorder.events)
    idx = next(i for i, ev in enumerate(events)
               if ev[0] == "complete" and ev[3] == "ok"
               and ev[4] is not None)
    wave, seq, status, val = events[idx][1:]
    events[idx] = ("complete", wave, seq, status, (val or 0) + 1)
    with pytest.raises(T.LinearizabilityError):
        T.check_history(events)
    # the reference's checker rejects the same tampered history
    with pytest.raises(R.LinearizabilityError):
        R.check_history(events)


def test_port_determinism_across_runs(tmp_path):
    sc = T.crash_mid_migration(seed=1, waves=40)
    _, a = _run(T, sc, tmp_path, "a")
    _, b = _run(T, sc, tmp_path, "b")
    assert a.crashes >= 1 and a.migrations >= 1
    assert a.trace_lines == b.trace_lines
    assert a.final_items == b.final_items
    _, c = _run(T, dataclasses.replace(sc, seed=4), tmp_path, "c")
    assert c.trace_lines != a.trace_lines, "seed must matter"


def test_crash_accounting_and_pruning(tmp_path):
    _, rep = _run(T, T.drifting_skew(seed=0, waves=50), tmp_path, "d")
    assert rep.crashes >= 1 and rep.check.crashes == rep.crashes
    assert rep.check.indeterminate == rep.ops_invoked - rep.ops_completed
    assert rep.wal_pruned > 0
    assert rep.wal_records < rep.ops_completed
    assert rep.slo["observations"] == rep.waves_run
    assert "LINEARIZABLE" in rep.summary() and rep.ops_per_s > 0


def test_fault_injections_are_trace_instants(tmp_path):
    enable_tracing().clear()
    try:
        _, rep = _run(T, T.hot_key_storm(seed=0, waves=30), tmp_path, "i")
    finally:
        disable_tracing()
    assert rep.faults_fired > 0
    events = get_tracer().events()
    faults = [e for e in events if e["name"] == "chaos.fault"]
    assert faults and all(e["ph"] == "i" and "kind" in e["args"]
                          for e in faults)
    kinds = {e["args"]["kind"] for e in faults}
    assert {"storm", "crash_trap", "crash"} <= kinds
    assert any(e["name"] == "chaos.crash_recover" for e in events)


def test_chaos_sweep_runs_every_family(tmp_path):
    reports = T.chaos_sweep(T.default_scenarios(seed=1, waves=16),
                            durable_root=str(tmp_path), device="cpu")
    assert [r.scenario.family for r in reports] == list(T.FAMILIES)
    assert all(r.check.ok for r in reports)
    ref = R.chaos_sweep(R.default_scenarios(seed=1, waves=16),
                        durable_root=str(tmp_path / "ref"))
    assert [r.trace_lines for r in reports] == [r.trace_lines for r in ref]
