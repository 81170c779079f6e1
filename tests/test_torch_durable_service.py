"""Durable KV service shards of the port against the JAX package's.

The same seeded LOAD stream and YCSB streams go through
``repro.service.KVService(backend="durable")`` and
``repro_torch.service.KVService(backend="durable", device="cpu")`` in
four setups — group commit, the per-op protocol, epochs with
checkpoints, and WAL pruning on a wave cadence.  Futures (status, value,
rounds, deciding wave, shard), ``items()``, the integer ``ServiceStats``
(``acks_held``, ``epoch_syncs`` and ``wal_pruned`` among them) and
``durability_stats().as_row()`` must be equal; then both services
``crash()`` and are compared again, and a second window runs on the
recovered services.  A migration over durable shards with a
``durable_root``, a crash with an epoch open, and ``chip_smoke.py``'s
durable phase rehearsed on the CPU (its ledger against the reference's)
close the file.  Every check is exact.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

import repro.obs as ref_obs
import repro.pmwcas as ref_pm
import repro.service as ref_svc
import repro.structures as ref_st
import repro_torch.obs as obs
import repro_torch.pmwcas as pm
import repro_torch.service as svc_mod
import repro_torch.structures as st
from test_torch_service import _drive, _int_stats

N_SHARDS, N_BUCKETS, ROUND_CAP = 4, 64, 8

SETUPS = {
    "group": dict(),
    "per_op": dict(group_commit=False),
    "epoch_ckpt": dict(epoch_rounds=4, checkpoint_every=2),
    "wal_prune": dict(wal_prune_every=4),
}


def _streams(pkg, n_clients, seed, **kw):
    spec = dict(n_ops=192, n_keys=96, read=0.3, update=0.4, insert=0.2,
                delete=0.1, alpha=0.99, seed=seed)
    spec.update(kw)
    spec = pkg.WorkloadSpec(**spec)
    return pkg.load_phase(spec, fraction=1.0), pkg.client_streams(
        spec, n_clients)


def _pair(tmp_path, **kw):
    ref = ref_svc.KVService(N_SHARDS, backend="durable",
                            n_buckets=N_BUCKETS, round_cap=ROUND_CAP,
                            durable_root=tmp_path / "ref", **kw)
    port = svc_mod.KVService(N_SHARDS, backend="durable",
                             n_buckets=N_BUCKETS, round_cap=ROUND_CAP,
                             durable_root=tmp_path / "port", device="cpu",
                             **kw)
    return ref, port


def _futures(futs):
    return [(f.op.kind, f.op.key, f.status,
             None if f.result is None else f.result.value,
             None if f.result is None else f.result.rounds, f.done_step,
             f.shard) for f in futs]


def _same(ref, port, ref_futs, futs):
    assert _futures(futs) == _futures(ref_futs)
    assert port.items() == ref.items()
    assert port.check_integrity() == ref.check_integrity()
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    assert port.durability_stats().as_row() == \
        ref.durability_stats().as_row()
    assert port.pending_count == ref.pending_count == 0


@pytest.mark.parametrize("n_clients", [4, 8])
@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_durable_service_matches_reference(tmp_path, setup, n_clients):
    kw = SETUPS[setup]
    ref, port = _pair(tmp_path, **kw)
    ref_futs = _drive(ref, *_streams(ref_st, n_clients, 21))
    futs = _drive(port, *_streams(st, n_clients, 21))
    _same(ref, port, ref_futs, futs)
    assert port.stats.conflict_rate == 0.0
    if setup == "epoch_ckpt":
        assert port.stats.acks_held > 0 and port.stats.epoch_syncs > 0
        assert port.durability_stats().checkpoints > 0
    if setup == "wal_prune":
        assert port.stats.wal_pruned > 0
    if setup == "per_op":
        assert port.durability_stats().op_commits > 0
    # crash both, compare, and run a second window on the recovered pair
    ref, port = ref.crash(), port.crash()
    _same(ref, port, ref_futs, futs)
    ref_futs = _drive(ref, [], _streams(ref_st, n_clients, 22)[1])
    futs = _drive(port, [], _streams(st, n_clients, 22)[1])
    _same(ref, port, ref_futs, futs)


def test_durable_migration_matches_reference(tmp_path):
    """Online key-range migration over durable shards, the decision log
    under ``durable_root/miglog``; then a crash."""
    ref, port = _pair(tmp_path, epoch_rounds=2)
    for svc, pkg in ((ref, ref_st), (port, st)):
        load, _ = _streams(pkg, 4, 5)
        svc.apply(load)
        svc.migrate_range(10, 40, dst=2)
        svc.apply([pkg.KVOp(pkg.UPDATE, k, 7) for k in range(10, 40)])
    assert (tmp_path / "port" / "miglog").is_dir()
    assert port.router.ranges == ref.router.ranges == [(10, 40, 2)]
    _same(ref, port, [], [])
    ref, port = ref.crash(), port.crash()
    assert port.router.ranges == ref.router.ranges == [(10, 40, 2)]
    _same(ref, port, [], [])


def test_crash_with_an_epoch_open_loses_no_ack(tmp_path):
    """Acks are held until the epoch that decided them closes: a crash
    with an epoch open loses only unacknowledged work, in both
    packages alike."""
    ref, port = _pair(tmp_path, epoch_rounds=4)
    outs = []
    for svc, pkg in ((ref, ref_st), (port, st)):
        load, streams = _streams(pkg, 4, 9)
        svc.apply(load)
        futs = [svc.submit(op, client=c) for c, s in enumerate(streams)
                for op in s]
        svc.step()
        svc.step()
        held = svc.pending_count
        assert any(f.done for f in futs), "no ack before the crash"
        rec = svc.crash()
        items = rec.check_integrity()
        last = {f.op.key: f for f in futs}       # the last op on each key
        for key, f in last.items():
            if f.done and f.status == pkg.OK:
                if f.op.kind in (pkg.INSERT, pkg.UPDATE):
                    assert items.get(key) == f.op.value
                elif f.op.kind == pkg.DELETE:
                    assert key not in items
        outs.append((held, _futures(futs), items,
                     _int_stats(rec.stats)))
    assert outs[0][0] > 0, "no ack was held: the epoch never stayed open"
    assert outs[1] == outs[0]


def test_durable_service_options_validate(tmp_path):
    with pytest.raises(ValueError, match="wal_prune_every"):
        svc_mod.KVService(2, backend="durable", device="cpu",
                          wal_prune_every=-1)
    with pytest.raises(ValueError, match="epoch_rounds > 1"):
        svc_mod.KVService(2, backend="durable", device="cpu",
                          group_commit=False, epoch_rounds=2)
    # durable shards without a decision log cannot migrate
    svc = svc_mod.KVService(2, backend="durable", device="cpu")
    with pytest.raises(ValueError, match="migration decision log"):
        svc.start_migration(0, 4, 1)
    roots = [b.pool.root for b in svc_mod.KVService(
        2, backend="durable", device="cpu",
        durable_root=tmp_path).backends]
    assert roots == [tmp_path / "shard0", tmp_path / "shard1"]
    assert dataclasses.is_dataclass(svc.durability_stats())


# ---------------------------------------------------------------------------
# chip_smoke.py's durable phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_ledger_matches_reference(tmp_path):
    """The smoke's per-op / group / marker ledger (the reference bench's
    window): the same integers from both packages."""
    smoke = _chip_smoke()
    ref = smoke.durable_ledger(ref_svc, ref_st, ref_pm, ref_obs, {},
                               tmp_path / "ref")
    port = smoke.durable_ledger(svc_mod, st, pm, obs, dict(device="cpu"),
                                tmp_path / "port")
    assert port == ref
    assert port["group"]["redundant_fences"] == 0
    assert port["per_op"]["redundant_fences"] > 0
    assert port["group"]["flushes_per_commit"] < \
        port["per_op"]["flushes_per_commit"] < \
        port["marker"]["flushes_per_commit"]


def test_chip_smoke_durable_slice_on_the_cpu(tmp_path):
    """The smoke's durable YCSB-A at a small size: every check it makes
    on the card (integrity, acknowledged writes across two crashes, no
    held ack, no redundant fence, the WAL cap) passes on the CPU."""
    row = _chip_smoke().durable_slice(svc_mod, st, obs,
                                      torch.device("cpu"), 0, records=128,
                                      ops=256, parent=tmp_path)
    assert row["held_at_crash"] > 0 and row["durability"]["checkpoints"] > 0
    assert row["redundant_fences"] == {}
    assert list(tmp_path.iterdir()) == []        # the pools are removed
