"""The port's synthetic token stream against the reference's, bit for bit:
every batch across steps, hosts and a stream restored ``from_state``, and
the iterator state itself (``tests/test_system.py``'s determinism test,
run on both)."""
import dataclasses

import numpy as np
import pytest

from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticStream as JaxStream
from repro_torch.data import DataConfig, SyntheticStream


def _pair(**kw):
    return SyntheticStream(DataConfig(**kw)), JaxStream(JaxDataConfig(**kw))


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(vocab=128, seq_len=16, global_batch=4),
    dict(vocab=512, seq_len=64, global_batch=4, seed=7),
    dict(vocab=1000, seq_len=33, global_batch=6, n_hosts=3, host_id=2,
         seed=3, zipf_alpha=1.3)], ids=["small", "seed7", "host2of3"])
def test_batches_equal_reference_across_steps(kw):
    port, ref = _pair(**kw)
    assert port.local_batch == ref.local_batch
    for _ in range(6):
        assert port.state() == ref.state()
        _same(port.next_batch(), ref.next_batch())


def test_hosts_and_from_state_equal_reference():
    cfg = dict(vocab=128, seq_len=16, global_batch=4)
    port, _ = _pair(**cfg)
    batches = [port.next_batch() for _ in range(5)]
    for state in ({"seed": 0, "step": 3}, {"seed": 5, "step": 2}):
        a = SyntheticStream.from_state(DataConfig(**cfg), state)
        b = JaxStream.from_state(JaxDataConfig(**cfg), state)
        assert a.state() == b.state() == state
        _same(a.next_batch(), b.next_batch())
    again = SyntheticStream.from_state(DataConfig(**cfg),
                                       {"seed": 0, "step": 3})
    np.testing.assert_array_equal(again.next_batch()["tokens"],
                                  batches[3]["tokens"])
    for host in range(2):
        c = dataclasses.replace(DataConfig(**cfg), n_hosts=2, host_id=host)
        jc = dataclasses.replace(JaxDataConfig(**cfg), n_hosts=2,
                                 host_id=host)
        _same(SyntheticStream(c).next_batch(), JaxStream(jc).next_batch())
    sh = SyntheticStream(dataclasses.replace(DataConfig(**cfg), n_hosts=2,
                                             host_id=1))
    assert not np.array_equal(sh.next_batch()["tokens"][:2],
                              batches[0]["tokens"][:2])
