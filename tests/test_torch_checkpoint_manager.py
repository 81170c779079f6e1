"""The port's ``CheckpointManager`` / ``AsyncCheckpointManager`` on the CPU,
mirroring ``tests/test_checkpoint.py``'s manager tests (round trip,
elastic reshard, versioned updates, async overlap) and held to the
reference's managers (``from repro import CheckpointManager``): on the
same state the restored trees are equal leaf for leaf (dtype, shape and
values), and every save costs the same persists and the same commit
stats.  A crash at every persist of a save recovers the old checkpoint
or the new one whole, never a mix.  The payload bytes differ (the port
stores leaves under their key paths, the reference a pickled treedef).
"""
import numpy as np
import pytest

from repro import AsyncCheckpointManager as JaxAsyncManager
from repro import CheckpointManager as JaxManager
from repro_torch.checkpoint import (AsyncCheckpointManager,
                                    CheckpointManager, SimulatedCrash)


def _state(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                   "b": np.ones(4, np.float32),
                   "units": {"layer0": {"wq": rng.standard_normal(
                       (2, 4, 6)).astype(np.float32)}}},
        "opt": {"m": {"w": np.zeros((4, 4), np.float32)},
                "step": np.asarray(seed + 3, np.int32)},
        "data_state": {"seed": np.asarray(0), "step": np.asarray(7 + seed)},
        "meta_state": {"next_step": np.asarray(seed + 1)},
    }


def _equal_trees(a, b) -> None:
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _equal_trees(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_manager_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, n_hosts=2)
    state = {
        "params": {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
                   "b": np.ones(4, np.float32)},
        "opt": {"m": np.zeros((4, 4), np.float32)},
        "data_state": {"position": np.asarray(1234)},
    }
    assert m.save(1, state)
    step, got = m.restore()
    assert step == 1
    np.testing.assert_array_equal(got["params"]["w"], state["params"]["w"])
    np.testing.assert_array_equal(got["data_state"]["position"], 1234)


def test_manager_elastic_reshard(tmp_path):
    """Save from 4 hosts, restore onto 2 — leaves re-concatenate exactly."""
    m4 = CheckpointManager(tmp_path, n_hosts=4)
    state = {"params": {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}}
    assert m4.save(5, state)
    m2 = CheckpointManager(tmp_path, n_hosts=2)
    step, got = m2.restore()
    assert step == 5
    np.testing.assert_array_equal(got["params"]["w"], state["params"]["w"])


def test_manager_versioned_updates(tmp_path):
    m = CheckpointManager(tmp_path)
    assert m.save(1, {"params": {"w": np.zeros(4, np.float32)}})
    assert m.save(2, {"params": {"w": np.ones(4, np.float32)}})
    step, got = m.restore()
    assert step == 2
    np.testing.assert_array_equal(got["params"]["w"], np.ones(4))


def test_async_manager_overlap(tmp_path):
    m = AsyncCheckpointManager(tmp_path)
    state = {"params": {"w": np.arange(8, dtype=np.float32)}}
    m.save_async(1, state)
    # mutate the live state after snapshot: committed bytes must be the
    # snapshot, proving the copy decouples training from the commit
    state["params"]["w"] += 100
    m.close()
    assert [(s, ok, e) for s, ok, e in m.wait()] == [(1, True, None)]
    step, got = m.restore()
    assert step == 1
    np.testing.assert_array_equal(got["params"]["w"],
                                  np.arange(8, dtype=np.float32))


@pytest.mark.parametrize("n_hosts,restore_hosts", [(1, 1), (2, 2), (4, 2)])
def test_restores_and_persists_equal_reference(tmp_path, n_hosts,
                                               restore_hosts):
    port = CheckpointManager(tmp_path / "port", n_hosts=n_hosts)
    ref = JaxManager(tmp_path / "ref", n_hosts=n_hosts)
    for step, seed in ((1, 0), (2, 1), (3, 2)):
        state = _state(seed)
        p0, r0 = port.pool.persist_count, ref.pool.persist_count
        assert port.save(step, state) and ref.save(step, state)
        assert port.pool.persist_count - p0 == ref.pool.persist_count - r0
        assert port.committer.stats.as_row() == \
            ref.committer.stats.as_row()
    got = CheckpointManager(tmp_path / "port",
                            n_hosts=restore_hosts).restore()
    want = JaxManager(tmp_path / "ref", n_hosts=restore_hosts).restore()
    assert got[0] == want[0] == 3
    _equal_trees(got[1], want[1])
    _equal_trees(got[1], _state(2))


def test_async_restores_equal_reference(tmp_path):
    port = AsyncCheckpointManager(tmp_path / "port")
    ref = JaxAsyncManager(tmp_path / "ref")
    for step in (1, 2):
        port.save_async(step, _state(step))
        ref.save_async(step, _state(step))
    port.close()
    ref.close()
    assert port.pool.persist_count == ref.pool.persist_count
    _equal_trees(port.restore()[1], ref.restore()[1])


def test_crash_at_every_persist_recovers_old_or_new(tmp_path):
    """Sweep the crash point across a whole save: the recovered
    checkpoint is the old one or the new one, every group of it."""
    old, new = _state(0), _state(1)
    total, crash_at, seen = None, 0, set()
    while total is None:
        root = tmp_path / f"run{crash_at}"
        m = CheckpointManager(root, n_hosts=2)
        assert m.save(1, old)
        m.pool.persist_count = 0
        m.pool.crash_after = crash_at
        try:
            assert m.save(2, new)
            total = m.pool.persist_count
        except SimulatedCrash:
            pass
        pool = m.pool.crash()
        step, got = CheckpointManager(root, n_hosts=2, pool=pool).restore()
        assert step in (1, 2), f"crash_at={crash_at}: step {step}"
        _equal_trees(got, old if step == 1 else new)
        seen.add(step)
        crash_at += 1
    assert seen == {1, 2}
    assert crash_at == total + 1 > 8
