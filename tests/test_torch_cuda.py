"""The port's Hopper kernels on the card, against their plain PyTorch
versions.

Every test here is marked ``requires_cuda`` and skips where there is no
CUDA card (the kernels have no CPU mode).  The file imports no JAX and
nothing of the reference, so it runs on a machine with a card::

    python -m pytest -m requires_cuda tests/test_torch_cuda.py

Tolerances: bit-identical verdicts and word tables for the PMwCAS
kernel; 2e-5 (f32) and 2e-2 (bf16, and ``chip_smoke.FA_ROW_TOL`` per
row) for the flash kernels, over the cases of ``chip_smoke.py``'s
``FA_CHECK_CASES``, each on the route the plan gives it; a small serve
on the card matches the CPU's within 1e-3 in f32, and within
``chip_smoke.SERVE_BF16_TOL`` (0.15, absolute) in bf16 at head_dim 128,
where the tensor-core and decode routes run inside the model (the
constants' comments give the reasons; ``tests/test_torch_flash_faults.py``
puts both bf16 limits to planted faults on the CPU).
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_flat)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.pmwcas_apply import kernel as pm_kernel
from repro_torch.kernels.pmwcas_apply import ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import build_model
from repro_torch.pmwcas import (pmwcas_apply_cuda, pmwcas_apply_stacked,
                                reserve_slots, sequential_oracle,
                                tensor_to_words, words_to_tensor)
from repro_torch.service import KVService
from repro_torch.structures import WorkloadSpec, client_streams, load_phase

pytestmark = pytest.mark.requires_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


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


@pytest.mark.parametrize("route", pm_kernel.ROUTES)
@pytest.mark.parametrize("S,B,K", [(1, 1, 1), (1, 7, 2), (4, 1024, 2),
                                   (4, 7, 8), (1, 1024, 8), (4, 1024, 1),
                                   (2, 3000, 2), (1, 128, 9), (2, 8193, 1),
                                   (1, 5000, 2), (2, 512, 8), (1, 256, 16),
                                   (4, 1024, 4), (1, 257, 9)])
def test_kernel_matches_plain(cuda, S, B, K, route):
    """Both routes against the plain version, bit for bit; the smem route
    refuses a round whose hash does not fit its shared memory."""
    rng = np.random.default_rng(S * 1000 + B + K)
    W = max(64, B * K // 2)
    cases = [_random_case(rng, W, B, K) for _ in range(S)]
    words, addr, exp, des = (np.stack(x) for x in zip(*cases))
    w_k, w_p = _t(words, cuda), _t(words, cuda)
    args = [_t(x, cuda) for x in (addr, exp, des)]
    if route == "smem" and pm_kernel.plan(B, K)[0] == "global":
        with pytest.raises(ValueError, match="shared memory"):
            pmwcas_apply_cuda(w_k, *args, route=route)
        return
    pm_kernel.reset_counts()
    s_k = pmwcas_apply_cuda(w_k, *args, route=route)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    torch.cuda.synchronize()
    assert pmwcas_apply_cuda.launches == 1
    assert pmwcas_apply_cuda.route_launches[route] == 1
    assert torch.equal(s_k, s_p)
    assert torch.equal(w_k, w_p)


@pytest.mark.parametrize("B,K", [(1, 1), (1024, 2), (128, 9), (1024, 8),
                                 (512, 8), (256, 16), (1025, 1), (4, 17),
                                 (3000, 4)])
def test_kernel_route_follows_plan(cuda, B, K):
    route, nbytes = pm_kernel.plan(B, K)
    if route == "smem":
        assert pm_kernel.kernel_smem_bytes(B, K) == nbytes
    w = torch.zeros(1, 64, dtype=torch.int32, device=cuda)
    addr = torch.full((1, B, K), -1, dtype=torch.int32, device=cuda)
    pm_kernel.reset_counts()
    _, s = pmwcas_apply_stacked(w, addr, addr, addr)
    assert bool(s.all()) and not w.any()          # pad rows win, write none
    assert pmwcas_apply_cuda.route_launches == {
        r: int(r == route) for r in pm_kernel.ROUTES}


def _colliding(rng, W, B, K, bits):
    """Addresses that the smem route's tag table (and so its hash too)
    sends to bucket 0, shared between rows and duplicated within some,
    and a batch over them."""
    pool = np.flatnonzero(pm_kernel.hash_bucket(np.arange(W), bits) == 0)
    assert len(pool) >= 256
    words = np.zeros(W, np.uint32)
    words[pool] = rng.integers(0, 2, len(pool))
    addr = rng.choice(pool[:B * K // 2], (B, K)).astype(np.int32)
    addr[rng.random((B, K)) < 0.1] = -1
    exp = words[np.maximum(addr, 0)]
    exp[rng.random((B, K)) < 0.05] ^= 1
    des = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    return words, addr, exp, des


@pytest.mark.parametrize("route", pm_kernel.ROUTES)
def test_kernel_collisions_match_plain(cuda, route):
    """Every address in one tag bucket and one home bucket: every passing
    slot is contested, and probes run the length of the hash."""
    rng = np.random.default_rng(17)
    S, B, K, W = 2, 1024, 2, 1 << 25
    bits = pm_kernel.table_bits(B, K)[0]
    cases = [_colliding(rng, W, B, K, bits) for _ in range(S)]
    words, addr, exp, des = (np.stack(x) for x in zip(*cases))
    w_k, w_p = _t(words, cuda), _t(words, cuda)
    args = [_t(x, cuda) for x in (addr, exp, des)]
    s_k = pmwcas_apply_cuda(w_k, *args, route=route)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(w_k, w_p)
    assert bool(s_k.any()) and not bool(s_k.all())


def test_kernel_claim_scratch_is_clean_after_launch(cuda):
    rng = np.random.default_rng(3)
    words, addr, exp, des = _random_case(rng, 128, 64, 4)
    claim = torch.full((1, 128), (1 << 31) - 1, dtype=torch.int32,
                       device=cuda)
    w = _t(words, cuda)[None]
    pmwcas_apply_cuda(w, _t(addr, cuda)[None], _t(exp, cuda)[None],
                      _t(des, cuda)[None], route="global", claim=claim)
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


@pytest.mark.parametrize("route", pm_kernel.ROUTES)
def test_kernel_reserve_slots_corner_cases(cuda, route):
    reqs = np.asarray([[3, 3, 5, -1], [-1, -1, -1, -1], [0, 1, 2, 3],
                       [3, 4, 5, 6], [4, 5, 11, 12], [7, 7, 7, 7],
                       [6, 13, -1, -1]], np.int32)
    free = np.ones(16, np.uint32)
    free[6] = 0
    m_k, m_p = _t(free, cuda), _t(free)
    r = _t(reqs, cuda)
    g_k = pmwcas_apply_cuda(m_k[None], r[None], torch.ones_like(r)[None],
                            torch.zeros_like(r)[None], route=route)[0]
    _, g_p = reserve_slots(m_p, _t(reqs))
    assert g_k.cpu().tolist() == g_p.tolist() == \
        [True, True, False, False, False, True, False]
    assert torch.equal(m_k.cpu(), m_p)
    if route == pm_kernel.plan(*reqs.shape)[0]:      # the op on its route
        m_r = _t(free, cuda)
        _, g_r = reserve_slots(m_r, r)
        assert torch.equal(g_r, g_k) and torch.equal(m_r, m_k)


def test_kernel_out_of_range_address_raises(cuda):
    w = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    addr = torch.full((1, 1, 1), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="out of range"):
        pmwcas_apply_stacked(w, addr, torch.zeros_like(addr),
                             torch.zeros_like(addr))
    assert pmwcas_apply_cuda.launches >= 0 and not w.any()


def test_service_on_card_matches_cpu(cuda):
    """The service on the card against the CPU's: the same verdicts and
    tables; every wave one smem launch on the shards' persistent table."""
    spec = WorkloadSpec(n_ops=256, n_keys=96, read=0.5, update=0.5,
                        insert=0.0, delete=0.0, alpha=0.99, seed=21)
    outs = []
    for device in (cuda, "cpu"):
        pm_kernel.reset_counts()
        svc = KVService(4, n_buckets=64, round_cap=8, device=device)
        futs = svc.submit_many(load_phase(spec, 1.0))
        for c, stream in enumerate(client_streams(spec, 8)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        launches = pmwcas_apply_cuda.launches
        if device == cuda:
            assert launches == svc.stats.dispatch.dispatches \
                + svc.stats.dispatch.serial_rounds > 0
            assert pmwcas_apply_cuda.route_launches == {
                "smem": launches, "global": 0}
            tables = [b.word_table() for b in svc.backends]
            base = tables[0].untyped_storage().data_ptr()
            assert all(t.is_cuda and t.untyped_storage().data_ptr() == base
                       for t in tables)
        else:
            assert launches == 0        # the CPU never reaches the kernel
        outs.append(([(f.status, f.result.value, f.done_step)
                      for f in futs],
                     [b.values().tolist() for b in svc.backends]))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", chip_smoke.FA_CHECK_CASES,
                         ids=[c[0] for c in chip_smoke.FA_CHECK_CASES])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    args, kw = chip_smoke.fa_case_inputs(case, dtype, cuda, seed=7)
    before = flash_attention_cuda.launches
    routes = dict(flash_attention_cuda.route_launches)
    got = chip_smoke.fa_run(fa_ops, fa_kernel, case, args, kw)
    want = fa_ref.flash_attention_flat(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    routes[chip_smoke.fa_route(case, dtype)] += 1
    assert flash_attention_cuda.route_launches == routes
    ok, err = chip_smoke.fa_close(got, want, dtype)
    assert ok, f"max abs err {err}"


def test_flash_model_layout_op(cuda):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda) for s in ((2, 2, 4, 24, 128), (2, 2, 40, 128),
                                   (2, 2, 40, 128)))
    pos_q, pos_k = torch.arange(24, device=cuda), torch.arange(40, device=cuda)
    kw = dict(causal=True, window=0, attn_cap=0.0, scale=128 ** -0.5)
    got = flash_attention(q, k, v, pos_q, pos_k, **kw)
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), pos_q.cpu(),
                           pos_k.cpu(), **kw)
    assert got.shape == (2, 2, 4, 24, 128)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_refuses_inputs(cuda):
    q = torch.zeros(4, 8, 16, device=cuda)
    k = torch.zeros(2, 8, 16, device=cuda)
    pos = torch.arange(8, device=cuda)
    kw = dict(g=2, scale=0.25, causal=True, window=0, attn_cap=0.0)
    before = flash_attention_cuda.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_flat(q.half(), k.half(), k.half(), pos, pos, **kw)
    with pytest.raises(ValueError, match="H == HK"):
        flash_attention_flat(q, k, k, pos, pos, **dict(kw, g=3))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_flat(q.transpose(0, 1).contiguous().transpose(0, 1),
                             k, k, pos, pos, **kw)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_flat(torch.zeros(4 * 8 * 16 + 1, device=cuda)[1:]
                             .view(4, 8, 16), k, k, pos, pos, **kw)
    assert flash_attention_cuda.launches == before


def test_small_serve_on_card_matches_cpu(cuda):
    before = (flash_attention_cuda.launches, pmwcas_apply_cuda.launches)
    chip_smoke.small_serve_matches_cpu(serve_mod, build_model, get_config, 0,
                                       cuda)
    cfg = get_config("llama3-8b", smoke=True)
    # the card run: one admission batch and n_layers x (1 + steps) flash
    # launches; the CPU run launches nothing
    assert (flash_attention_cuda.launches - before[0],
            pmwcas_apply_cuda.launches - before[1]) == (
        cfg.n_layers * (1 + 8), 1)


def test_small_bf16_serve_runs_tc_and_decode_routes(cuda):
    # head_dim 128 in bf16: the prefill (64 rows per kv head) takes the
    # tensor-core route, each decode step (4 rows) the decode route
    routes = chip_smoke.small_serve_bf16(serve_mod, build_model, get_config,
                                         0, cuda)
    n_layers = get_config("llama3-8b", smoke=True).n_layers
    assert routes == dict(tc=n_layers, decode=n_layers * 8, simt=0)


@pytest.mark.parametrize("impl", ["chunked", "ref"])
def test_serve_runs_the_kernel_whatever_attn_impl(cuda, impl):
    # the config's default ("chunked") and the oracle ("ref") both run the
    # flash kernel on the card: n_layers x (1 + steps) launches
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              attn_impl=impl)
    before = flash_attention_cuda.launches
    res = serve_mod.serve(cfg, requests=8, steps=4, prompt_len=16,
                          page_size=16, n_pages=64, device=cuda)
    assert len(res.admitted) > 0 and res.logits_finite
    assert flash_attention_cuda.launches - before == cfg.n_layers * (1 + 4)
