"""The port's raw-op ``BatchScheduler``, migration crash sweep and BzTree
``KVService`` shards against the JAX package's.

Identical seeded submit streams of raw ``MwCASOp``s — shard-local ops
with shared targets (conflict-defer), stale expected values, and
cross-shard ops — go through ``repro.service.BatchScheduler`` over
``KernelBackend(use_kernel=False)`` shards and through
``repro_torch.service.BatchScheduler`` over ``KernelBackend(device=
"cpu")`` shards: per-future ``OpResult`` (success, latency in rounds),
the integer ``ServiceStats`` (defers, rounds, cross rounds) and the word
tables must be equal.  Then durable shards: a crash at every persist of
a mixed batch on a shard pool and on the decision-journal pool, the
online migration sweep, and BzTree ``KVService`` shards on kernel and
durable backends before and after ``crash()``.  Every check is exact.
"""
import importlib.util
import pathlib

import pytest

import repro.pmwcas as ref_pm
import repro.service as ref_svc
import repro.structures as ref_st
from repro import PMemPool as RefPool, SimulatedCrash as RefCrash
import repro_torch.pmwcas as pm
import repro_torch.service as svc_mod
import repro_torch.structures as st
from repro_torch.checkpoint import PMemPool, SimulatedCrash
from test_torch_service import _drive, _int_stats

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
raw_stream = chip_smoke.raw_stream     # the seeded raw ops phase 8 also runs

PKGS = {"ref": (ref_pm, ref_svc, ref_st, RefPool, RefCrash),
        "port": (pm, svc_mod, st, PMemPool, SimulatedCrash)}


def _kernel(name, words):
    pkg = PKGS[name][0]
    if name == "ref":
        return pkg.KernelBackend(n_words=words, use_kernel=False)
    return pkg.KernelBackend(n_words=words, device="cpu")


def _sched(name, n_shards, words, backends=None, **kw):
    _, svc, *_ = PKGS[name]
    backends = backends or [_kernel(name, words) for _ in range(n_shards)]
    return backends, svc.BatchScheduler(
        backends, svc.ShardRouter(n_shards, words_per_shard=words), **kw)


def _run_raw(name, stream, n_shards, words, window, **kw):
    pkg = PKGS[name][0]
    backends, sched = _sched(name, n_shards, words, **kw)
    futs = []
    for start in range(0, len(stream), window):
        futs += [sched.submit(pkg.MwCASOp(t), client=i % 8)
                 for i, t in enumerate(stream[start:start + window])]
        sched.step()
    sched.drain()
    return dict(
        results=[(f.result.index, f.result.success, f.result.backend,
                  f.latency_rounds, f.shard, f.client) for f in futs],
        stats=_int_stats(sched.stats),
        tables=[b.values().tolist() for b in backends],
        reads=[sched.read(a) for a in range(n_shards * words)])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("window", (5, 64))
def test_raw_streams_match_reference(seed, window):
    kw = dict(round_cap=4)
    ref = _run_raw("ref", raw_stream(seed, 4, 16, 96, 0.15), 4, 16, window,
                   **kw)
    port = _run_raw("port", raw_stream(seed, 4, 16, 96, 0.15), 4, 16,
                    window, **kw)
    assert port == ref
    assert port["stats"]["cross_rounds"] > 0
    assert sum(s["defers"] for s in port["stats"]["shards"]) > 0
    assert port["stats"]["dispatch"]["dispatches"] > 0   # stacked launches


def test_serial_executor_and_single_shard_match():
    """The per-shard serial engine (one shard, and a forced serial
    executor) gives the stacked engine's verdicts, as in the reference."""
    stream = raw_stream(7, 4, 16, 96, cross=0.0)
    serial = {}
    for name in ("ref", "port"):
        svc = PKGS[name][1]
        serial[name] = _run_raw(name, stream, 4, 16, 16,
                                executor=svc.SerialShardExecutor())
        assert serial[name]["stats"]["dispatch"]["serial_rounds"] > 0
    stacked = _run_raw("port", stream, 4, 16, 16)
    assert serial["port"] == serial["ref"]
    assert [r[1] for r in stacked["results"]] == \
        [r[1] for r in serial["port"]["results"]]
    assert stacked["tables"] == serial["port"]["tables"]
    one = [_run_raw(n, raw_stream(8, 1, 16, 96, cross=0.0), 1, 16, 8)
           for n in PKGS]
    assert one[0] == one[1]


def test_cross_shard_global_round_semantics():
    """``test_cross_shard_op_executes_atomically_and_serialized``, the
    validation failure and two cross ops in one global round, on both."""
    out = []
    for name in PKGS:
        pkg = PKGS[name][0]
        _, sched = _sched(name, 3, 8)
        f_local = sched.submit(pkg.MwCASOp([(0, 0, 1)]))
        fx = sched.submit(pkg.MwCASOp([(1, 0, 2), (9, 0, 3), (17, 0, 4)]))
        fa = sched.submit(pkg.MwCASOp([(2, 0, 1), (10, 0, 1)]))
        fb = sched.submit(pkg.MwCASOp([(2, 0, 2), (10, 0, 2)]))
        fs = sched.submit(pkg.MwCASOp([(3, 5, 1), (18, 0, 1)]))   # stale
        sched.drain()
        out.append(([f.success for f in (f_local, fx, fa, fb, fs)],
                     [f.latency_rounds for f in (f_local, fx, fa, fb, fs)],
                     [sched.read(a) for a in range(24)],
                     _int_stats(sched.stats)))
        with pytest.raises(PKGS[name][1].ServiceError):
            sched.submit(pkg.MwCASOp([(0, 1, 2)]))
            sched.drain(max_steps=0)
    assert out[0] == out[1]
    assert out[1][0] == [True, True, True, False, False]
    assert out[1][3]["cross_rounds"] == 1 and out[1][3]["cross_ops"] == 4


_W, _S = 8, 3
_MIXED = [[(0, 0, 1)], [(8, 0, 2)], [(16, 0, 3)], [(1, 0, 4), (9, 0, 5)],
          [(10, 0, 6), (17, 0, 7)], [(2, 0, 8)]]


def _crash_sweep(name, root: pathlib.Path, crash_shard, crash_journal,
                 group_commit=True):
    """``tests/test_service.py::_crash_sweep`` for one package: the
    recovered reads at every crash point, and the number swept."""
    pkg, svc, _st, Pool, Crash = PKGS[name]
    seen = []
    crash_at = 0
    while True:
        tag = f"c{crash_at}_"
        pools = [Pool(root / f"{tag}s{i}", crash_after_persists=(
            crash_at if i == crash_shard else None)) for i in range(_S)]
        backends = [pkg.DurableBackend(pool=p, group_commit=group_commit)
                    for p in pools]
        jpool = Pool(root / f"{tag}j", crash_after_persists=(
            crash_at if crash_journal else None))
        sched = svc.BatchScheduler(
            backends, svc.ShardRouter(_S, words_per_shard=_W), round_cap=4,
            journal=svc.CrossShardJournal(jpool))
        futs = sched.submit_many([pkg.MwCASOp(t) for t in _MIXED])
        crashed = False
        try:
            sched.drain()
        except Crash:
            crashed = True
        recovered = [b.crash() for b in backends]
        sched2 = svc.BatchScheduler(
            recovered, svc.ShardRouter(_S, words_per_shard=_W), round_cap=4,
            journal=svc.CrossShardJournal(jpool.crash()))
        redone = sched2.recover()
        seen.append(([f.done and f.success for f in futs], redone,
                     [sched2.read(a) for a in range(_S * _W)]))
        if not crashed:
            return seen
        crash_at += 1
        assert crash_at < 200, "sweep did not terminate"


@pytest.mark.parametrize("where", ("shard_per_op", "shard_group",
                                   "journal"))
def test_crash_during_sharded_round_matches(tmp_path, where):
    kw = dict(shard_per_op=dict(crash_shard=1, crash_journal=False,
                                group_commit=False),
              shard_group=dict(crash_shard=1, crash_journal=False),
              journal=dict(crash_shard=None, crash_journal=True))[where]
    ref = _crash_sweep("ref", tmp_path / "ref", **kw)
    port = _crash_sweep("port", tmp_path / "port", **kw)
    assert port == ref
    assert len(port) > 1
    final = port[-1][2]
    for targets in _MIXED:                     # a clean run lands all
        for a, _e, d in targets:
            assert final[a] == d
    for _ok, _redone, reads in port:           # never half-applied
        for pair in ([(1, 4), (9, 5)], [(10, 6), (17, 7)]):
            vals = [reads[a] for a, _d in pair]
            assert vals in ([d for _a, d in pair], [0, 0])


def test_recover_is_idempotent_on_both(tmp_path):
    out = []
    for name in PKGS:
        pkg, svc, _st, Pool, _c = PKGS[name]
        backends = [pkg.DurableBackend(pool=Pool(tmp_path / name / f"s{i}"))
                    for i in range(2)]
        journal = svc.CrossShardJournal(Pool(tmp_path / name / "j"))
        journal.decide("x0", [(0, 0, 0, 3), (1, 0, 0, 4)])
        sched = svc.BatchScheduler(backends,
                                   svc.ShardRouter(2, words_per_shard=4),
                                   journal=journal)
        out.append((sched.recover(), sched.read(0), sched.read(4),
                    sched.recover(), sched.durability_stats().as_row()))
    assert out[0] == out[1] == [(1, 3, 4, 0, out[1][4])][0]


@pytest.mark.parametrize("setup", (
    dict(epoch_rounds=3, wal_prune_every=0),
    dict(epoch_rounds=1, wal_prune_every=3)))
def test_scheduler_durable_epochs_and_prunes_match(tmp_path, setup):
    """Durable shards with epochs (``drain`` syncs them), and apart from
    them the WAL prune cadence (pruning inside an open epoch is the
    reference fault the port fixes, ROADMAP Queue 3), each with the
    journal prune cadence: the flush ledger, the pruned counts and the
    tables equal the reference's."""
    out = []
    stream = raw_stream(5, 2, 8, 48, cross=0.2)
    for name in PKGS:
        pkg, svc, _st, Pool, _c = PKGS[name]
        backends = [pkg.DurableBackend(tmp_path / name / f"s{i}",
                                       epoch_rounds=setup["epoch_rounds"])
                    for i in range(2)]
        _, sched = _sched(name, 2, 8, backends=backends, round_cap=4,
                          journal=svc.CrossShardJournal(
                              Pool(tmp_path / name / "j")),
                          journal_prune_every=1,
                          wal_prune_every=setup["wal_prune_every"])
        futs = sched.submit_many([pkg.MwCASOp(t) for t in stream])
        sched.drain()
        out.append(([f.success for f in futs], _int_stats(sched.stats),
                     sched.durability_stats().as_row(),
                     [sched.read(a) for a in range(16)],
                     [b.epoch_pending for b in backends]))
    assert out[0] == out[1]
    stats = out[1][1]
    assert stats["journal_pruned"] > 0 and out[1][4] == [0, 0]
    if setup["epoch_rounds"] > 1:
        assert stats["epoch_syncs"] >= 1
    else:
        assert stats["wal_pruned"] > 0


def test_migration_crash_sweep_matches(tmp_path):
    """``tests/test_elastic.py::test_migration_crash_sweep`` on both."""
    load = {k: 100 + k for k in range(1, 13)}
    kw = dict(lo=3, hi=9, dst=2, n_shards=3, n_buckets=16)
    n_ref = ref_svc.check_migration_crash_sweep(load, tmp_path / "ref", **kw)
    n_port = svc_mod.check_migration_crash_sweep(load, tmp_path / "port",
                                                 device="cpu", **kw)
    assert n_port == n_ref > 4


def _tree_outcome(svc, futs):
    return dict(
        results=[(f.op.kind, f.op.key, f.status, f.result.value,
                  f.result.rounds, f.done_step, f.shard) for f in futs],
        items=svc.check_integrity(),
        splits=[(t.splits, t.root_splits, t.consolidations, t.rounds_run,
                 t.mwcas_submitted, t.mwcas_won, t.height())
                for t in svc.structs],
        masks=[t.allocator.mask().tolist() for t in svc.structs])


def _tree_streams(pkg, seed, **kw):
    spec = dict(n_ops=160, n_keys=80, read=0.2, update=0.2, insert=0.35,
                delete=0.1, scan=0.15, alpha=0.9, seed=seed)
    spec.update(kw)
    spec = pkg.WorkloadSpec(**spec)
    return pkg.load_phase(spec, 0.5), pkg.client_streams(spec, 8)


TREE = dict(leaf_cap=4, root_cap=2, n_regions=48)


@pytest.mark.parametrize("backend", ("kernel", "durable"))
@pytest.mark.parametrize("seed", (1, 2))
def test_bztree_service_matches_before_and_after_crash(tmp_path, backend,
                                                       seed):
    """BzTree shards on both packages: futures, items, split counters,
    allocator masks and the integer stats; on durable shards again after
    ``crash()`` and a second window on the recovered services (kernel
    shards cannot crash, in either package)."""
    outs = []
    for name in PKGS:
        _pkg, svc, pst, *_ = PKGS[name]
        kw = dict(structure="bztree", backend=backend, round_cap=8, **TREE)
        if backend == "durable":
            kw["durable_root"] = tmp_path / name
        if name == "port":
            kw["device"] = "cpu"
        else:
            kw["use_kernel"] = False
        s = svc.KVService(4, **kw)
        load, streams = _tree_streams(pst, seed)
        futs = _drive(s, load, streams, window=32)
        out = [_tree_outcome(s, futs), _int_stats(s.stats),
               s.stats.conflict_rate]
        if backend == "kernel":
            out.append([b.values().tolist() for b in s.backends])
            with pytest.raises(TypeError, match="cannot crash"):
                s.crash()
        else:
            out.append(s.durability_stats().as_row())
            s2 = s.crash()
            out.append(s2.check_integrity())
            more_load, more = _tree_streams(pst, seed + 10, n_ops=64)
            futs2 = _drive(s2, [], more, window=16)
            out += [_tree_outcome(s2, futs2), _int_stats(s2.stats),
                    s2.gc_regions(), s2.check_integrity()]
        outs.append(out)
    assert outs[0] == outs[1]
    port = outs[1][0]
    assert sum(sp[0] for sp in port["splits"]) > 4
    assert any(sp[6] >= 3 for sp in port["splits"])    # a root split ran
    assert outs[1][2] == 0.0                           # conflict_rate


def test_bztree_service_gc_scan_and_exhaustion_match():
    """``test_kvservice_bztree_shards_split_and_gc``, the scan across
    shards and the typed region exhaustion, on both packages."""
    out = []
    for name in PKGS:
        _pkg, svc, pst, *_ = PKGS[name]
        dev = dict(device="cpu") if name == "port" else dict(use_kernel=False)
        s = svc.KVService(2, structure="bztree", leaf_cap=2, root_cap=4,
                          n_regions=6, round_cap=4, **dev)
        res = s.apply([pst.KVOp(pst.INSERT, k, k) for k in range(1, 13)])
        seen = [[r.status for r in res], s.check_integrity(), s.gc_regions(),
                s.check_integrity(), [b.values().tolist() for b in s.backends]]
        seen += [(r.status, r.value) for r in s.apply(
            [pst.KVOp(pst.SCAN, 1), pst.KVOp(pst.SCAN, 7),
             pst.KVOp(pst.READ, 5)])]
        full = svc.KVService(1, structure="bztree", leaf_cap=2, root_cap=8,
                             n_regions=2, round_cap=4, **dev)
        res = full.apply([pst.KVOp(pst.INSERT, k, k) for k in range(1, 9)])
        seen += [[r.status for r in res], full.stats.shards[0].out_of_regions]
        tiny = svc.KVService(1, structure="bztree", leaf_cap=2, root_cap=4,
                             n_regions=4, max_op_rounds=0, **dev)
        seen.append([r.status for r in tiny.apply(
            [pst.KVOp(pst.INSERT, k, k) for k in (1, 2, 3)])])
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][2] >= 1 and out[1][5] == (st.OK, 12)
    assert out[1][-2] >= 1 and out[1][-1] == [st.OK, st.OK, st.EXHAUSTED]
    with pytest.raises(ValueError, match="2\\^31"):
        svc_mod.KVService(2, structure="bztree", device="cpu").apply(
            [st.KVOp(st.SCAN, 1 << 31)])
