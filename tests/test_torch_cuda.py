"""The port's Hopper kernel on the card, against its plain PyTorch version.

Every test here is marked ``requires_cuda`` and skips where there is no
CUDA card (the kernel has no CPU mode).  The file imports no JAX and
nothing of the reference, so it runs on a machine with a card::

    python -m pytest -m requires_cuda tests/test_torch_cuda.py

Tolerance: bit-identical verdicts and word tables.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.pmwcas_apply import ref
from repro_torch.pmwcas import (pmwcas_apply_cuda, pmwcas_apply_stacked,
                                reserve_slots, sequential_oracle,
                                tensor_to_words, words_to_tensor)
from repro_torch.service import KVService
from repro_torch.structures import WorkloadSpec, client_streams, load_phase

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _t(arr, device="cpu"):
    return words_to_tensor(np.asarray(arr), device)


def _random_case(rng, W, B, K, pad_frac=0.2, val_range=4):
    words = rng.integers(0, val_range, W).astype(np.uint32)
    addr = rng.integers(0, W, (B, K)).astype(np.int32)    # duplicates too
    addr[rng.random((B, K)) < pad_frac] = -1
    exp = rng.integers(0, val_range, (B, K)).astype(np.uint32)
    des = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    return words, addr, exp, des


@pytest.mark.parametrize("S,B,K", [(1, 1, 1), (1, 7, 2), (4, 1024, 2),
                                   (4, 7, 8), (1, 1024, 8), (4, 1024, 1),
                                   (2, 3000, 2)])
def test_kernel_matches_plain(cuda, S, B, K):
    rng = np.random.default_rng(S * 1000 + B + K)
    W = max(64, B * K // 2)
    cases = [_random_case(rng, W, B, K) for _ in range(S)]
    words, addr, exp, des = (np.stack(x) for x in zip(*cases))
    before = pmwcas_apply_cuda.launches
    w_k, w_p = _t(words, cuda), _t(words, cuda)
    args = [_t(x, cuda) for x in (addr, exp, des)]
    _, s_k = pmwcas_apply_stacked(w_k, *args)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    torch.cuda.synchronize()
    assert pmwcas_apply_cuda.launches == before + 1
    assert torch.equal(s_k, s_p)
    assert torch.equal(w_k, w_p)


def test_kernel_claim_scratch_is_clean_after_launch(cuda):
    rng = np.random.default_rng(3)
    words, addr, exp, des = _random_case(rng, 128, 64, 4)
    claim = torch.full((1, 128), (1 << 31) - 1, dtype=torch.int32,
                       device=cuda)
    w = _t(words, cuda)[None]
    pmwcas_apply_stacked(w, _t(addr, cuda)[None], _t(exp, cuda)[None],
                         _t(des, cuda)[None], claim=claim)
    assert bool((claim == (1 << 31) - 1).all())


def test_kernel_sequential_oracle_containment(cuda):
    for seed in range(6):
        rng = np.random.default_rng(seed)
        words, addr, exp, des = _random_case(rng, 64, 40, 4, pad_frac=0.1)
        des = (exp + 1).astype(np.uint32)
        w = _t(words, cuda)[None]
        _, succ = pmwcas_apply_stacked(w, *[_t(x, cuda)[None]
                                            for x in (addr, exp, des)])
        succ = succ[0].cpu().numpy()
        seq_words, seq = sequential_oracle(words, addr, exp, des)
        assert (~succ | seq).all()
        new = tensor_to_words(w[0])
        for i in np.flatnonzero(succ):
            for a in addr[i][addr[i] >= 0]:
                assert new[a] == seq_words[a]


def test_kernel_reserve_slots_corner_cases(cuda):
    reqs = np.asarray([[3, 3, 5, -1], [-1, -1, -1, -1], [0, 1, 2, 3],
                       [3, 4, 5, 6], [4, 5, 11, 12], [7, 7, 7, 7],
                       [6, 13, -1, -1]], np.int32)
    free = np.ones(16, np.uint32)
    free[6] = 0
    m_k, m_p = _t(free, cuda), _t(free)
    _, g_k = reserve_slots(m_k, _t(reqs, cuda))
    _, g_p = reserve_slots(m_p, _t(reqs))
    assert g_k.cpu().tolist() == g_p.tolist() == \
        [True, True, False, False, False, True, False]
    assert torch.equal(m_k.cpu(), m_p)


def test_kernel_out_of_range_address_raises(cuda):
    w = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    addr = torch.full((1, 1, 1), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="out of range"):
        pmwcas_apply_stacked(w, addr, torch.zeros_like(addr),
                             torch.zeros_like(addr))
    assert pmwcas_apply_cuda.launches >= 0 and not w.any()


def test_service_on_card_matches_cpu(cuda):
    spec = WorkloadSpec(n_ops=256, n_keys=96, read=0.5, update=0.5,
                        insert=0.0, delete=0.0, alpha=0.99, seed=21)
    outs = []
    for device in (cuda, "cpu"):
        before = pmwcas_apply_cuda.launches
        svc = KVService(4, n_buckets=64, round_cap=8, device=device)
        futs = svc.submit_many(load_phase(spec, 1.0))
        for c, stream in enumerate(client_streams(spec, 8)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        launches = pmwcas_apply_cuda.launches - before
        if device == cuda:
            assert launches == svc.stats.dispatch.dispatches \
                + svc.stats.dispatch.serial_rounds > 0
        else:
            assert launches == 0        # the CPU never reaches the kernel
        outs.append(([(f.status, f.result.value, f.done_step)
                      for f in futs],
                     [b.values().tolist() for b in svc.backends]))
    assert outs[0] == outs[1]
