"""SCAN through the service, port against the JAX package, on kernel and
durable shards.

A SCAN's count covers every shard: the shard that compiles it reads its
own wave snapshot and each OTHER shard's fresh snapshot (on durable
shards, slot by slot through ``DurableBackend.read``).  Six seeds × two
mixes — 25% scans among reads, updates, inserts and deletes, and 95%
scans (YCSB-E's share) — go through ``repro.service.KVService`` and
``repro_torch.service.KVService(device="cpu")``; futures, ``items()``,
the word tables (kernel shards) and the integer ``ServiceStats`` must be
equal.  Every check is exact.
"""
import pytest

import repro.service as ref_svc
import repro.structures as ref_st
import repro_torch.service as svc_mod
import repro_torch.structures as st
from test_torch_service import _drive, _int_stats

N_SHARDS, N_BUCKETS, ROUND_CAP, N_CLIENTS = 4, 64, 8, 6

MIXES = {
    "scan25": dict(read=0.25, update=0.25, insert=0.15, delete=0.1,
                   scan=0.25),
    "scan95": dict(read=0.0, update=0.0, insert=0.05, delete=0.0,
                   scan=0.95),
}


def _streams(pkg, mix, seed):
    spec = pkg.WorkloadSpec(n_ops=96, n_keys=80, alpha=0.99, seed=seed,
                            **MIXES[mix])
    return pkg.load_phase(spec, fraction=0.5), pkg.client_streams(
        spec, N_CLIENTS)


def _services(backend, tmp_path):
    common = dict(n_buckets=N_BUCKETS, round_cap=ROUND_CAP)
    if backend == "kernel":
        return (ref_svc.KVService(N_SHARDS, use_kernel=False, **common),
                svc_mod.KVService(N_SHARDS, device="cpu", **common))
    return (ref_svc.KVService(N_SHARDS, backend="durable",
                              durable_root=tmp_path / "ref", **common),
            svc_mod.KVService(N_SHARDS, backend="durable", device="cpu",
                              durable_root=tmp_path / "port", **common))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("backend", ["kernel", "durable"])
def test_scan_through_service_matches_reference(tmp_path, backend, mix,
                                                seed):
    ref, port = _services(backend, tmp_path)
    ref_futs = _drive(ref, *_streams(ref_st, mix, seed))
    futs = _drive(port, *_streams(st, mix, seed))
    assert [(f.op.kind, f.op.key, f.status, f.result.value,
             f.result.rounds, f.done_step, f.shard) for f in futs] == \
        [(f.op.kind, f.op.key, f.status, f.result.value, f.result.rounds,
          f.done_step, f.shard) for f in ref_futs]
    scans = [f for f in futs if f.op.kind == st.SCAN]
    assert scans and all(f.status == st.OK for f in scans)
    assert port.items() == ref.items()
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    if backend == "kernel":
        assert [b.values().tolist() for b in port.backends] == \
            [b.values().tolist() for b in ref.backends]
    else:
        assert port.durability_stats().as_row() == \
            ref.durability_stats().as_row()
