"""repro_torch.obs's SLO engine, exporters and stats folds against
repro.obs on the CPU.

- ``SloEngine``: the same observation streams (``tests/test_obs_v2.py``'s
  cases and seeded random ones) give identical reports, verdict for
  verdict; ``SloSpec`` and ``validate_slo_report`` accept and reject the
  same inputs.
- ``chrome_trace``: the same span sequence through either tracer gives
  the same event structure (name, phase, category, parent, arguments;
  times aside); it validates, and ``export_chrome_trace`` /
  ``export_jsonl`` round-trip through JSON.
- ``fold_*``: each fold of stats from a port run gives the registry rows
  the reference's fold gives of the reference's stats from the same run
  (wall-clock gauges, named ``*_us``, compared by name only).
- layering: ``repro_torch.obs`` imports nothing of the port outside
  itself.
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.chaos as RC
import repro.obs as R
import repro.service as RS
import repro.structures as RST
import repro_torch.chaos as TC
import repro_torch.obs as T
import repro_torch.service as TS
import repro_torch.structures as TST
from repro.pmwcas import make_backend as ref_make_backend
from repro_torch.pmwcas import make_backend as port_make_backend

PACKAGES = pytest.mark.parametrize("mod", [R, T], ids=["ref", "port"])


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------

def _engine_reports(mod, specs, stream, short=8, long=64):
    eng = mod.SloEngine([mod.SloSpec(**s) for s in specs], short_window=short,
                        long_window=long)
    out = []
    for obs in stream:
        eng.observe(obs)
        out.append(eng.evaluate())
    return out, eng.report(section="unit", extra_field=1)


LAT = dict(name="lat", metric="p99_us", bound=100.0, kind="ceiling",
           error_budget=0.25)
TPUT = dict(name="tput", metric="ops", bound=10.0, kind="floor",
            error_budget=0.0, description="ops floor")
GHOST = dict(name="ghost", metric="nope_us", bound=1.0, kind="ceiling")

STREAMS = {
    # tests/test_obs_v2.py: a short burst inside the budget, then a
    # sustained breach that burns both windows
    "burst-then-sustained": ([LAT], [{"p99_us": 50.0}] * 14
                             + [{"p99_us": 500.0}] * 18, 4, 16),
    "missing-metric": ([GHOST], [{"something_else": 5.0}], 8, 64),
    "zero-budget-floor": ([TPUT, LAT], [{"ops": 12.0}, {"ops": 9.0},
                                        {"ops": 11.0, "p99_us": 101.0}],
                          2, 4),
}


def _random_stream(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        obs = {}
        if rng.random() < 0.9:
            obs["p99_us"] = float(rng.gamma(2.0, 40.0))
        if rng.random() < 0.7:
            obs["ops"] = float(rng.normal(12.0, 3.0))
        out.append(obs)
    return out


for _seed in (0, 1, 2):
    STREAMS[f"random-s{_seed}"] = ([LAT, TPUT, GHOST], _random_stream(_seed),
                                   8, 32)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_slo_engine_matches_reference(name):
    specs, stream, short, long = STREAMS[name]
    ref = _engine_reports(R, specs, stream, short, long)
    port = _engine_reports(T, specs, stream, short, long)
    assert port == ref
    T.validate_slo_report(port[1])


def test_slo_burst_fires_only_on_both_windows():
    specs, stream, short, long = STREAMS["burst-then-sustained"]
    per_obs, _ = _engine_reports(T, specs, stream, short, long)
    burst = per_obs[15][0]
    assert burst["burn_short"] >= 1.0 and burst["burn_long"] < 1.0
    assert burst["ok"]
    assert not per_obs[-1][0]["ok"]


BAD_SPECS = [dict(name="bad", metric="m", bound=1.0, kind="sideways"),
             dict(name="bad", metric="m", bound=1.0, kind="ceiling",
                  error_budget=1.0),
             dict(name="bad", metric="m", bound=1.0, kind="floor",
                  error_budget=-0.1)]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=["kind", "budget1", "neg"])
@PACKAGES
def test_slo_spec_rejects(mod, kw):
    with pytest.raises(ValueError):
        mod.SloSpec(**kw)


@PACKAGES
def test_slo_engine_rejects_bad_windows(mod):
    with pytest.raises(ValueError):
        mod.SloEngine([], short_window=8, long_window=4)


def _good_report():
    eng = R.SloEngine([R.SloSpec(**LAT)])
    eng.observe({"p99_us": 50.0})
    return json.loads(json.dumps(eng.report(section="unit")))


def _bad_reports():
    out = {"not-dict": "yes",
           "ok-not-bool": {"specs": [], "ok": "yes", "observations": 0,
                           "windows": {"short": 1, "long": 1}}}
    doc = _good_report()
    doc["specs"][0]["violations"] = 99
    out["violations-over-evaluations"] = doc
    doc = _good_report()
    doc["windows"]["long"] = 1.5
    out["window-float"] = doc
    doc = _good_report()
    doc["specs"][0]["kind"] = "sideways"
    out["spec-kind"] = doc
    doc = _good_report()
    doc["specs"][0]["burn_long"] = True
    out["burn-bool"] = doc
    doc = _good_report()
    doc["specs"][0] = 3
    out["spec-not-dict"] = doc
    return out


@pytest.mark.parametrize("name", sorted(_bad_reports()))
def test_validate_slo_report_rejects_like_reference(name):
    bad = _bad_reports()[name]
    with pytest.raises(ValueError) as ref:
        R.validate_slo_report(bad)
    with pytest.raises(ValueError) as port:
        T.validate_slo_report(bad)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _traced(mod):
    t = mod.SpanTracer()
    t.enable()
    with t.span("scenario", family="x"):
        with t.span("wave", n=1) as sp:
            with t.span("dispatch"):
                pass
            t.instant("chaos.fault", kind="storm", shard=1)
            sp.set(done=3)
        with t.span("wave", n=2):
            pass
    t.instant("tick")
    return t


def _structure(obj):
    return [(e["name"], e["ph"], e.get("cat"), e.get("s"), e.get("args"))
            for e in obj["traceEvents"]]


def test_chrome_trace_structure_matches_reference():
    ref = R.chrome_trace(_traced(R))
    port = T.chrome_trace(_traced(T))
    T.validate_chrome_trace(port)
    R.validate_chrome_trace(port)
    assert _structure(port) == _structure(ref)
    assert port["otherData"] == ref["otherData"]
    assert port["displayTimeUnit"] == ref["displayTimeUnit"]
    assert [sorted(e) for e in port["traceEvents"]] == \
        [sorted(e) for e in ref["traceEvents"]]


def test_span_tree_matches_reference():
    ref = R.span_tree(R.chrome_trace(_traced(R))["traceEvents"])
    port = T.span_tree(T.chrome_trace(_traced(T))["traceEvents"])
    assert port == ref == {"scenario": ["wave"], "wave": ["dispatch"]}


def test_export_chrome_trace_and_jsonl_roundtrip(tmp_path):
    t = _traced(T)
    path = T.export_chrome_trace(tmp_path / "trace.json", t)
    obj = json.loads(path.read_text())
    T.validate_chrome_trace(obj)
    assert obj == json.loads(json.dumps(T.chrome_trace(t)))
    lines = T.export_jsonl(tmp_path / "events.jsonl", t).read_text() \
        .splitlines()
    assert [json.loads(ln) for ln in lines] == t.events()
    assert len(lines) == len(t)


@pytest.mark.parametrize("bad", [
    "not a dict",
    {},
    {"traceEvents": [{"ph": "X", "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "x", "ph": "Q", "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": -1, "dur": 1}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 0, "pid": "one"}]},
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 0, "args": [1]}]},
], ids=["str", "empty", "nameless", "phase", "ts", "dur", "pid", "args"])
def test_validator_rejects_like_reference(bad):
    with pytest.raises(ValueError) as ref:
        R.validate_chrome_trace(bad)
    with pytest.raises(ValueError) as port:
        T.validate_chrome_trace(bad)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# stats folds, over stats from parity runs
# ---------------------------------------------------------------------------

def _rows(fold, stats, **labels):
    """The rows ``fold`` writes into a fresh registry of its own package,
    and the names and labels of its wall-clock (``*_us``) rows."""
    mod = R if fold.__module__.startswith("repro.") else T
    reg = mod.MetricsRegistry()
    fold(stats, reg, **labels)
    fold(stats, reg, **labels)           # folds are idempotent
    rows = reg.as_rows()
    timed = sorted((r["name"], sorted(r["labels"].items())) for r in rows
                   if r["name"].endswith("_us"))
    return [r for r in rows if not r["name"].endswith("_us")], timed


def _chaos_pair(family, tmp_path, waves=30, **replace):
    out = []
    for mod, kw in ((RC, {}), (TC, {"device": "cpu"})):
        sc = mod.FAMILIES[family](seed=0, waves=waves)
        if replace:
            sc = dataclasses.replace(sc, **replace)
        root = (tmp_path / mod.__name__ if sc.backend == "durable"
                else None)
        driver = mod.ScenarioDriver(sc, durable_root=root, **kw)
        driver.run()
        out.append(driver)
    return out


@pytest.mark.parametrize("family", ["crash_mid_migration", "epoch_boundary"])
def test_fold_durability_and_service_match_reference(family, tmp_path):
    ref, port = _chaos_pair(family, tmp_path)
    a = RS.collect_durability(ref.svc.backends)
    b = TS.collect_durability(port.svc.backends)
    assert b.ops_committed > 0
    assert _rows(T.fold_durability, b, run=family) == \
        _rows(R.fold_durability, a, run=family)
    assert _rows(T.fold_service, port.svc.stats) == \
        _rows(R.fold_service, ref.svc.stats)
    assert _rows(T.fold_check, port.report.check, family=family) == \
        _rows(R.fold_check, ref.report.check, family=family)


def test_fold_dispatch_and_service_match_reference_on_kernel_shards(
        tmp_path):
    ref, port = _chaos_pair("hot_key_storm", tmp_path, backend="kernel",
                            faults=())
    assert port.svc.stats.dispatch is not None
    assert port.svc.stats.dispatch.dispatches > 0
    assert _rows(T.fold_dispatch, port.svc.stats.dispatch) == \
        _rows(R.fold_dispatch, ref.svc.stats.dispatch)
    rows, timed = _rows(T.fold_service, port.svc.stats, cell="storm")
    assert (rows, timed) == _rows(R.fold_service, ref.svc.stats, cell="storm")
    assert any(r["name"] == "dispatch.dispatches" for r in rows)
    assert ("service.p99_latency_us", [("cell", "storm")]) in timed


@pytest.mark.parametrize("seed", [0, 4])
def test_fold_workload_matches_reference(seed):
    stats = []
    for st, make, kw in ((RST, ref_make_backend, {}),
                         (TST, port_make_backend, {"device": "cpu"})):
        n = st.HashMap.words_needed(48)
        m = st.HashMap(make("kernel", n_words=n, **kw), 48)
        spec = st.WorkloadSpec(n_ops=96, n_keys=40, alpha=0.9, seed=seed,
                               batch=12)
        stats.append(st.run_workload(m, spec))
    a, b = stats
    assert b.n_ops == 96 and b.mwcas_won > 0
    assert _rows(T.fold_workload, b, seed=seed) == \
        _rows(R.fold_workload, a, seed=seed)


# ---------------------------------------------------------------------------
# layering: obs sits at the bottom of the port's import graph
# ---------------------------------------------------------------------------

OBS_DIR = pathlib.Path(T.__file__).resolve().parent


@pytest.mark.parametrize("path", sorted(OBS_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_obs_imports_nothing_of_the_port_outside_obs(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("repro_torch",
                                                         "repro")]
    assert not bad, f"{path.name} imports {bad}"
