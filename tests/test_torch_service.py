"""The port's sharded KV service against the JAX reference, end to end.

One seeded LOAD stream and one YCSB-A stream (8 clients) go through
``repro.service.KVService(use_kernel=False)`` — the reference's
bit-identical oracle path; Pallas interpret mode is too slow for whole
runs — and through ``repro_torch.service.KVService(device="cpu")``.
Both must give the same per-future status, value and deciding wave, the
same final items and word tables, and the same integer ``ServiceStats``
and ``DispatchStats`` counters.  The wall-clock microsecond histograms
are left out of the comparison: they time two different host stacks,
so only their sample counts must agree.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.pmwcas as ref_pm
import repro.service as ref_svc
import repro.structures as ref_st
import repro_torch.pmwcas as pm
import repro_torch.service as svc_mod
import repro_torch.structures as st

N_SHARDS, N_BUCKETS, ROUND_CAP, N_CLIENTS = 4, 64, 8, 8
US_FIELDS = ("latency_us", "queue_us", "dispatch_us", "persist_us",
             "retry_waves")


def _spec(**kw):
    base = dict(n_ops=256, n_keys=96, read=0.5, update=0.5, insert=0.0,
                delete=0.0, alpha=0.99, seed=21)
    base.update(kw)
    return base


def _streams(pkg, **kw):
    """The LOAD stream and the per-client YCSB-A streams, built by
    ``pkg``'s own workload compiler (the two must agree op for op)."""
    spec = pkg.WorkloadSpec(**_spec(**kw))
    return pkg.load_phase(spec, fraction=1.0), pkg.client_streams(
        spec, N_CLIENTS)


def _drive(svc, load, streams, window=N_SHARDS * ROUND_CAP):
    """Bounded-window clients: submit about ``window`` ops per wave."""
    futs = []
    arrivals = [(0, op) for op in load]
    arrivals += [(c, s[i]) for i in range(max(map(len, streams)))
                 for c, s in enumerate(streams) if i < len(s)]
    for start in range(0, len(arrivals), window):
        futs += [svc.submit(op, client=c)
                 for c, op in arrivals[start:start + window]]
        svc.step()
    svc.drain()
    return futs


def _outcome(svc, futs):
    return dict(
        results=[(f.op.kind, f.op.key, f.status, f.result.value,
                  f.result.rounds, f.done_step, f.shard) for f in futs],
        items=svc.items(),
        tables=[b.values().tolist() for b in svc.backends])


def _int_stats(stats):
    out = {f.name: getattr(stats, f.name)
           for f in dataclasses.fields(stats)
           if f.name not in US_FIELDS + ("mig_pause_us", "dispatch",
                                         "shards")}
    out["shards"] = [dataclasses.asdict(s) for s in stats.shards]
    out["dispatch"] = (None if stats.dispatch is None
                       else dataclasses.asdict(stats.dispatch))
    out["us_counts"] = [getattr(stats, f).count for f in US_FIELDS]
    return out


def _pair(**kw):
    ref = ref_svc.KVService(N_SHARDS, n_buckets=N_BUCKETS,
                            round_cap=ROUND_CAP, use_kernel=False, **kw)
    port = svc_mod.KVService(N_SHARDS, n_buckets=N_BUCKETS,
                             round_cap=ROUND_CAP, device="cpu", **kw)
    return ref, port


def test_workload_streams_match_reference():
    ref_load, ref_streams = _streams(ref_st)
    load, streams = _streams(st)
    assert [dataclasses.astuple(o) for o in load] == \
        [dataclasses.astuple(o) for o in ref_load]
    assert [[dataclasses.astuple(o) for o in s] for s in streams] == \
        [[dataclasses.astuple(o) for o in s] for s in ref_streams]
    assert np.array_equal(pm.zipf_probs(50, 0.99),
                          ref_pm.zipf_probs(50, 0.99))


@pytest.mark.parametrize("window", [N_SHARDS * ROUND_CAP, 5])
def test_ycsb_a_service_matches_reference(window):
    ref, port = _pair()
    ref_futs = _drive(ref, *_streams(ref_st), window=window)
    futs = _drive(port, *_streams(st), window=window)
    assert _outcome(port, futs) == _outcome(ref, ref_futs)
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    assert port.check_integrity() == ref.check_integrity()
    assert port.stats.conflict_rate == 0.0


def test_directory_doubling_service_matches_reference():
    kw = dict(max_doublings=1)
    spec = dict(n_keys=120, n_ops=96, read=0.2, update=0.3, insert=0.3,
                delete=0.2, seed=4)
    ref = ref_svc.KVService(N_SHARDS, n_buckets=16, round_cap=ROUND_CAP,
                            use_kernel=False, **kw)
    port = svc_mod.KVService(N_SHARDS, n_buckets=16, round_cap=ROUND_CAP,
                             device="cpu", **kw)
    ref_futs = _drive(ref, *_streams(ref_st, **spec))
    futs = _drive(port, *_streams(st, **spec))
    assert _outcome(port, futs) == _outcome(ref, ref_futs)
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    assert [s.resizes for s in port.structs] == \
        [s.resizes for s in ref.structs]
    assert sum(s.resizes for s in port.structs) > 0   # doubling happened
    port.check_integrity()


def test_load_word_tables_continues_from_reference_state():
    load, streams = _streams(st)
    ref_load, ref_streams = _streams(ref_st)
    half = [s[:len(s) // 2] for s in ref_streams]
    rest = [s[len(s) // 2:] for s in ref_streams]
    ref, _ = _pair()
    _drive(ref, ref_load, half)
    port = svc_mod.KVService(N_SHARDS, n_buckets=N_BUCKETS,
                             round_cap=ROUND_CAP, device="cpu")
    svc_mod.load_word_tables(port, [b.values() for b in ref.backends])
    assert port.items() == ref.items()
    port_rest = [s[len(s) // 2:] for s in streams]
    ref_futs = _drive(ref, [], rest)
    futs = _drive(port, [], port_rest)
    assert [(f.status, f.result.value) for f in futs] == \
        [(f.status, f.result.value) for f in ref_futs]
    assert _outcome(port, [])["tables"] == _outcome(ref, [])["tables"]
    assert port.check_integrity() == ref.check_integrity()


def test_load_word_tables_validates_shape_and_shards():
    port = svc_mod.KVService(2, n_buckets=4, device="cpu")
    good = [np.zeros(8, np.uint32), np.zeros(8, np.uint32)]
    with pytest.raises(ValueError, match="tables for"):
        svc_mod.load_word_tables(port, good[:1])
    with pytest.raises(ValueError, match="shape"):
        svc_mod.load_word_tables(port, [np.zeros(9, np.uint32)] * 2)
    with pytest.raises(TypeError, match="uint32"):
        svc_mod.load_word_tables(port, [np.zeros(8, np.int64)] * 2)
    good[1][3] = st.TOMBSTONE
    svc_mod.load_word_tables(port, good)
    assert port.backends[1].read(3) == st.TOMBSTONE


@pytest.mark.parametrize("max_doublings", [0, 1])
def test_hashmap_on_one_kernel_backend_matches_reference(max_doublings):
    spec_kw = dict(n_ops=160, n_keys=40, read=0.3, update=0.3, insert=0.25,
                   delete=0.15, alpha=0.8, seed=9, batch=16)
    n_buckets = 16 if max_doublings else 64
    words = ref_st.HashMap.words_needed(n_buckets, max_doublings)
    ref_map = ref_st.HashMap(ref_pm.KernelBackend(n_words=words,
                                                  use_kernel=False),
                             n_buckets, max_doublings=max_doublings)
    port_map = st.HashMap(pm.KernelBackend(n_words=words, device="cpu"),
                          n_buckets, max_doublings=max_doublings)
    ref_spec = ref_st.WorkloadSpec(**spec_kw)
    spec = st.WorkloadSpec(**spec_kw)
    ref_stats = ref_st.run_workload(ref_map, ref_spec,
                                    ref_st.load_phase(ref_spec, 0.5)
                                    + ref_st.compile_workload(ref_spec))
    stats = st.run_workload(port_map, spec,
                            st.load_phase(spec, 0.5)
                            + st.compile_workload(spec))
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert port_map.backend.values().tolist() == \
        ref_map.backend.values().tolist()
    assert port_map.check_integrity() == ref_map.check_integrity()
    assert (port_map.resizes, port_map.keys_migrated) == \
        (ref_map.resizes, ref_map.keys_migrated)


def test_migration_matches_reference(tmp_path):
    ref, port = (
        ref_svc.KVService(N_SHARDS, n_buckets=N_BUCKETS, round_cap=ROUND_CAP,
                          use_kernel=False, migration_pool=tmp_path / "ref"),
        svc_mod.KVService(N_SHARDS, n_buckets=N_BUCKETS, round_cap=ROUND_CAP,
                          device="cpu", migration_pool=tmp_path / "port"))
    for svc, pkg in ((ref, ref_st), (port, st)):
        load, _ = _streams(pkg)
        svc.apply(load)
        svc.migrate_range(10, 40, dst=2)
        svc.apply([pkg.KVOp(pkg.UPDATE, k, 7) for k in range(10, 40)])
    assert port.router.ranges == ref.router.ranges == [(10, 40, 2)]
    assert port.items() == ref.items()
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    assert [b.values().tolist() for b in port.backends] == \
        [b.values().tolist() for b in ref.backends]


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="bztree"):
        svc_mod.KVService(2, structure="bztree", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #3"):
        svc_mod.KVService(2, backend="durable", device="cpu")
    with pytest.raises(NotImplementedError, match="durable_root"):
        svc_mod.KVService(2, durable_root="x", device="cpu")
    with pytest.raises(TypeError, match="use_kernel"):
        svc_mod.KVService(2, use_kernel=False, device="cpu")
    with pytest.raises(NotImplementedError):
        svc_mod.KVService(2, device="cpu").crash()


def test_service_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the raise cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        svc_mod.KVService(2)


# ---------------------------------------------------------------------------
# the persistent [S, W] shard table of the stacked dispatch
# ---------------------------------------------------------------------------

def _storage(backend):
    return backend.word_table().untyped_storage().data_ptr()


def _rows_of_one_tensor(port):
    """Every shard's table is row ``i`` of one ``[S, W]`` storage; returns
    that storage's address."""
    base = _storage(port.backends[0])
    for i, b in enumerate(port.backends):
        assert _storage(b) == base
        assert b.word_table().data_ptr() == base + i * b.n_words * 4
    return base


def test_shard_tables_are_rows_of_one_persistent_tensor(monkeypatch):
    """From the first stacked dispatch on, the shards' tables are views of
    one storage, whose address stays put wave after wave; no wave stacks
    or writes a table back, and the run still equals the reference's,
    ``DispatchStats`` included."""
    ref, port = _pair()
    ref_futs = _drive(ref, *_streams(ref_st))
    assert len({_storage(b) for b in port.backends}) == N_SHARDS
    seen = []
    step = port.step

    def checked_step():
        done = step()
        seen.append(_rows_of_one_tensor(port))
        return done

    def refuse(*a, **kw):
        raise AssertionError("a wave stacked or wrote back a table")

    monkeypatch.setattr(port, "step", checked_step)
    monkeypatch.setattr(torch, "stack", refuse)
    monkeypatch.setattr(pm.KernelBackend, "set_word_table", refuse)
    futs = _drive(port, *_streams(st))
    monkeypatch.undo()
    assert len(seen) > 3 and len(set(seen)) == 1
    assert _outcome(port, futs) == _outcome(ref, ref_futs)
    assert _int_stats(port.stats) == _int_stats(ref.stats)
    assert port.stats.dispatch.dispatches > 3


def test_load_word_tables_writes_through_the_bound_rows():
    """``load_word_tables`` after the tables are bound copies into the
    rows: the same storage, the new words, and the next waves match a
    reference continued from the same tables."""
    load, streams = _streams(st)
    ref_load, ref_streams = _streams(ref_st)
    ref, port = _pair()
    _drive(ref, ref_load, [s[:len(s) // 2] for s in ref_streams])
    _drive(port, load[:64], [[]])
    base = _rows_of_one_tensor(port)
    tables = [b.values() for b in ref.backends]
    svc_mod.load_word_tables(port, tables)
    assert _rows_of_one_tensor(port) == base
    assert [b.values().tolist() for b in port.backends] == \
        [t.tolist() for t in tables]
    ref_futs = _drive(ref, [], [s[len(s) // 2:] for s in ref_streams])
    futs = _drive(port, [], [s[len(s) // 2:] for s in streams])
    assert [(f.status, f.result.value) for f in futs] == \
        [(f.status, f.result.value) for f in ref_futs]
    assert _outcome(port, [])["tables"] == _outcome(ref, [])["tables"]
    assert _rows_of_one_tensor(port) == base


def test_stacked_dispatch_checks_addresses_on_the_host(monkeypatch):
    """The executor hands the kernel the batch's largest address from its
    host array (so the range check waits for no device) and refuses an
    out-of-range address before anything is dispatched."""
    backends = [pm.KernelBackend(n_words=16, device="cpu") for _ in range(2)]
    ex = svc_mod.StackedKernelExecutor(round_cap=4)
    calls = []
    real = svc_mod.executor.pmwcas_apply_stacked

    def spy(words, addr, exp, des, **kw):
        calls.append((int(addr.max()), kw))
        return real(words, addr, exp, des, **kw)

    monkeypatch.setattr(svc_mod.executor, "pmwcas_apply_stacked", spy)
    out = ex.execute(backends, {0: [pm.MwCASOp([(3, 0, 5), (11, 0, 6)])],
                                1: [pm.MwCASOp([(2, 0, 7)])]})
    assert out == {0: [True], 1: [True]}
    assert calls == [(11, {"addr_max": 11})]
    assert backends[0].read(11) == 6 and backends[1].read(2) == 7
    with pytest.raises(ValueError, match="out of range"):
        ex.execute(backends, {1: [pm.MwCASOp([(16, 0, 1)])]})
    assert len(calls) == 1 and ex.stats.dispatches == 1
    assert backends[1].values().tolist() == [0, 0, 7] + [0] * 13
