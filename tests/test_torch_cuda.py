"""The port's Hopper kernels on the card, against their plain PyTorch
versions.

Every test here is marked ``requires_cuda`` and skips where there is no
CUDA card (the kernels have no CPU mode).  The file imports no JAX and
nothing of the reference, so it runs on a machine with a card::

    python -m pytest -m requires_cuda tests/test_torch_cuda.py

Tolerances: bit-identical verdicts and word tables for the PMwCAS
kernel, and every state field of the simulator kernel; 2e-5 (f32) and 2e-2 (bf16, and ``chip_smoke.FA_ROW_TOL`` per
row) for the flash kernels, over the cases of ``chip_smoke.py``'s
``FA_CHECK_CASES``, each on the route the plan gives it; a small serve
on the card matches the CPU's within 1e-3 in f32, and within
``chip_smoke.SERVE_BF16_TOL`` (0.15, absolute) in bf16 at head_dim 128,
where the tensor-core and decode routes run inside the model (the
constants' comments give the reasons; ``tests/test_torch_flash_faults.py``
puts both bf16 limits to planted faults on the CPU).

Training: the flash kernel's training launch (``lse=True``) against the
plain version's ``(out, lse)`` (``out`` as above, ``lse`` to
``chip_smoke.FA_LSE_TOL``), its serving launch (a null lse pointer)
equal to it bit for bit; ``FlashAttention``'s gradients on the card
against the CPU's (relative norm 1e-4 in f32, 5e-2 in bf16); a small
training run card against CPU within ``chip_smoke.SMALL_TOL``, which
planted faults exceed; the ``Trainer``'s crash and restart on the card.

MoE: ``moe.route`` card against CPU on the same probabilities (exact),
``apply_moe``/``apply_moe_dense`` within ``chip_smoke.MOE_APPLY_TOL``
(planted faults read above it), the granite-moe smoke config served and
trained card against CPU, and qwen1.5's bf16 serve with no ``simt``
call.

xLSTM and Mamba: the blocks at full width (xlstm-125m's mLSTM and sLSTM,
jamba's Mamba) card against CPU within ``chip_smoke.BLOCK_TOL`` (planted
faults read above it), the xlstm-125m and jamba smoke configs served and
trained card against CPU.

The int8 KV cache: ``_quant`` card against CPU bit for bit (the 127.5
rows of every bf16 magnitude included), ``_sdpa_chunked_quant`` within
``chip_smoke.INT8_ATTN_TOL`` of the CPU on the same int8 cache, and the
llama3-8b and qwen1.5-32b smoke configs served with an int8 cache within
the small serves' limits, with no flash launch; the planted faults (the
cast without its clamp, one int8 value flipped) read above each limit.

Cell programs: ``build_cell``'s prefill and decode steps at llama3-8b's
smoke config on the card against the CPU within the small serves'
limits.  On a mesh: the steps through a one-rank NCCL group equal to
the same program without one, bit for bit, on the same flash routes; on
a host of four cards, ``chip_smoke.mesh_cells`` and
``chip_smoke.jamba_mesh_cells`` at the smoke config (skipped below four
cards).  jamba's four-card cells: each card's flash call (q ``[1024, 1,
128]`` x k/v ``[256, 32768, 128]``, q ``[8, 1, 128]`` x k/v ``[2,
524288, 128]``, q ``[64, 32768, 128]`` x k/v ``[16, 32768, 128]``
causal) against its plain version within 2e-2 and ``FA_ROW_TOL`` a row,
on the route and split count ``chip_smoke.JAMBA_FLASH`` gives.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import chaos
from repro_torch import core as sim_core
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_flat)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.pmwcas_apply import kernel as pm_kernel
from repro_torch.kernels.pmwcas_apply import ref
from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
from repro_torch.launch import serve as serve_mod
from repro_torch.models import build_model
from repro_torch.pmwcas import (KernelBackend, MwCASOp, SimBackend,
                                SimSession, increment_batch,
                                pmwcas_apply_cuda, pmwcas_apply_stacked,
                                reserve_slots, run_differential,
                                sequential_oracle, tensor_to_words,
                                words_to_tensor)
from repro_torch.service import BatchScheduler, KVService, ShardRouter
from repro_torch.structures import (BzTreeIndex, FreeListAllocator,
                                    OutOfRegions, WorkloadSpec,
                                    check_sim_crash_sweep,
                                    client_streams, compile_workload,
                                    load_phase)

pytestmark = pytest.mark.requires_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
# the four-card test's ranks are spawned with chip_smoke.mesh_rank, which
# pickles by module name
sys.modules.setdefault("chip_smoke", chip_smoke)


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


@pytest.mark.parametrize("B,K,route", [(1024, 2, "smem"),
                                       (256, 16, "smem"),
                                       (512, 32, "global")])
def test_run_differential_kernel_against_durable(cuda, tmp_path, B, K,
                                                 route):
    """The Hopper kernel against the durable committer and the simulator
    kernel on one seeded increment batch: equal verdicts and final
    values, on the route the plan gives ``[B, K]``, one simulator
    launch."""
    init, ops = increment_batch(B * K, K, B, seed=K)
    assert len(ops) == B
    pm_kernel.reset_counts()
    sim_kernel.reset_counts()
    report = run_differential(ops, init, durable_root=tmp_path,
                              device=cuda)
    assert report.agree, report.summary()
    v = report.verdicts["kernel"]
    assert v.any() and not v.all()
    assert np.array_equal(report.verdicts["sim"], v)
    assert pmwcas_apply_cuda.route_launches[route] == 1
    assert pmwcas_apply_cuda.launches == 1
    assert sim_kernel.pmwcas_sim_cuda.launches == 1


_US = ("latency_us", "queue_us", "dispatch_us", "persist_us", "retry_waves",
       "mig_pause_us")


def _int_stats(stats):
    out = {f.name: getattr(stats, f.name)
           for f in dataclasses.fields(stats) if f.name not in _US}
    out["shards"] = [dataclasses.asdict(s) for s in stats.shards]
    out["dispatch"] = dataclasses.asdict(stats.dispatch)
    return out


def test_durable_service_on_card_matches_cpu(cuda, tmp_path):
    """Durable shards are host code: ``device="cuda"`` gives the same
    futures, items, integer stats and flush ledger as ``"cpu"``, and
    launches no kernel."""
    spec = WorkloadSpec(n_ops=192, n_keys=96, read=0.3, update=0.4,
                        insert=0.2, delete=0.1, alpha=0.99, seed=21)
    outs = []
    for i, device in enumerate((cuda, "cpu")):
        pm_kernel.reset_counts()
        svc = KVService(4, backend="durable", n_buckets=64, round_cap=8,
                        epoch_rounds=4, checkpoint_every=2,
                        durable_root=tmp_path / f"run{i}", device=device)
        futs = svc.submit_many(load_phase(spec, 1.0))
        for c, stream in enumerate(client_streams(spec, 8)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        assert pmwcas_apply_cuda.launches == 0
        items = svc.check_integrity()
        rec = svc.crash()
        assert rec.check_integrity() == items
        outs.append(([(f.status, f.result.value, f.done_step)
                      for f in futs], items, _int_stats(svc.stats),
                     svc.durability_stats().as_row()))
    assert outs[0] == outs[1]


def test_kernel_shard_service_cannot_crash(cuda):
    svc = KVService(2, n_buckets=16, device=cuda)
    with pytest.raises(TypeError, match="backend kernel cannot crash"):
        svc.crash()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", chip_smoke.FA_CHECK_CASES
                         + [chip_smoke.TRAIN_FA_CASE],
                         ids=[c[0] for c in chip_smoke.FA_CHECK_CASES]
                         + ["train"])
def test_flash_lse_matches_plain(cuda, case, dtype):
    """The training launch writes out and the log-sum-exp on tc or simt;
    a serving launch on the same route gives the same out bit for bit."""
    args, kw = chip_smoke.fa_case_inputs(case, dtype, cuda, seed=9)
    routes = dict(flash_attention_cuda.route_launches)
    got, lse = flash_attention_cuda(*args, **kw, lse=True)
    route = chip_smoke.fa_lse_route(case, dtype)
    routes[route] += 1
    assert flash_attention_cuda.route_launches == routes
    want, want_lse = fa_ref.flash_attention_flat_lse(*args, **kw)
    torch.cuda.synchronize()
    ok, err = chip_smoke.fa_close(got, want, dtype)
    assert ok, f"max abs err {err}"
    assert lse.dtype == torch.float32 and lse.shape == args[0].shape[:2]
    assert float((lse - want_lse).abs().max()) <= chip_smoke.FA_LSE_TOL[dtype]
    if chip_smoke.fa_route(case, dtype) == route:
        assert torch.equal(flash_attention_cuda(*args, **kw), got)


@pytest.mark.parametrize("dtype,hd,tol", [(torch.float32, 16, 1e-4),
                                          (torch.bfloat16, 128, 5e-2)],
                         ids=["f32_simt", "bf16_tc"])
def test_flash_function_gradients_card_vs_cpu(cuda, dtype, hd, tol):
    from repro_torch.models import attention as attn_mod
    rng = np.random.default_rng(10)
    shapes = ((2, 2, 4, 96, hd), (2, 2, 96, hd), (2, 2, 96, hd))
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    do = rng.standard_normal(shapes[0], dtype=np.float32)
    pos = torch.arange(96, dtype=torch.float32)
    results = {}
    for dev in ("cpu", cuda):
        qkv = [torch.from_numpy(a).to(dev, dtype).requires_grad_()
               for a in arrays]
        p = pos.to(dev)
        before = flash_attention_cuda.launches
        out = attn_mod.FlashAttention.apply(*qkv, p, p, True, 0, 0.0,
                                            hd ** -0.5, 32)
        out.backward(torch.from_numpy(do).to(dev, dtype))
        results[str(dev)] = [t.grad.float().cpu() for t in qkv]
        assert flash_attention_cuda.launches - before == (
            1 if dev != "cpu" else 0)
    for got, want in zip(results["cuda"], results["cpu"]):
        assert float((got - want).norm() / want.norm()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_train_step_card_vs_cpu(cuda, dtype):
    import repro_torch.data as data
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    out = chip_smoke.small_train_matches_cpu(
        get_config, TrainModel, adamw, data, attn_mod, fa_kernel, dtype, 0,
        cuda)
    assert out["grad_err"] <= chip_smoke.SMALL_TOL[dtype][1]


def test_trainer_crash_restart_on_card(cuda):
    import repro_torch.data as data
    import repro_torch.runtime as runtime
    from repro_torch.models import convert
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    out = chip_smoke.trainer_crash_restart(
        get_config, TrainModel, adamw, data, runtime, convert, fa_kernel,
        cuda, 0)
    assert out["restored_step"] == 20 and out["async_start"] == 40
    cfg = get_config("llama3-8b", smoke=True)
    # (25 + 20 + 40 + 40) steps, each 2 flash launches a layer (remat)
    assert out["launches"] == 125 * 2 * cfg.n_layers


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


# ---------------------------------------------------------------------------
# the range index: the global route at tree widths, the tree, the free
# list and the raw-op scheduler on the card against the CPU
# ---------------------------------------------------------------------------

def _wide_case(rng, W, widths, stale=0.2, share=0.3):
    """One round of rows of the given widths (a split's wide op, a GC
    zeroing op, 3-word inserts), padded to the widest: live words,
    expected mostly current, some rows sharing words with earlier ones."""
    words = rng.integers(1, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    K = max(widths)
    addr = np.full((len(widths), K), -1, np.int32)
    taken = []
    for i, k in enumerate(widths):
        row = rng.choice(W, k, replace=False)
        if taken and rng.random() < share:
            row[:2] = rng.choice(np.concatenate(taken), 2, replace=False)
            row = np.unique(row)
            k = len(row)
        addr[i, :k] = np.sort(row)
        taken.append(addr[i, :k])
    exp = words[np.maximum(addr, 0)]
    exp[rng.random(addr.shape) < stale / K] += 1
    des = rng.integers(0, 1 << 32, addr.shape,
                       dtype=np.uint64).astype(np.uint32)
    return words, addr, exp, des


@pytest.mark.parametrize("widths", [(260,), (390,), (132, 3, 3, 390, 2),
                                    (390, 390, 135, 1), (132,) * 32,
                                    (3,) * 64 + (260,)])
def test_global_route_at_tree_widths(cuda, widths):
    """``[1, B, K]`` rounds at a tree's wide widths on the global route
    (its plan), bit for bit against the plain version: one thread per
    slot up to 32 rows, one per row above."""
    rng = np.random.default_rng(sum(widths))
    words, addr, exp, des = _wide_case(rng, 6000, widths)
    assert pm_kernel.plan(*addr.shape)[0] == "global"
    w_k, w_p = _t(words, cuda)[None], _t(words, cuda)[None]
    args = [_t(x, cuda)[None] for x in (addr, exp, des)]
    pm_kernel.reset_counts()
    _, s_k = pmwcas_apply_stacked(w_k, *args)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    torch.cuda.synchronize()
    assert pmwcas_apply_cuda.route_launches == {"smem": 0, "global": 1}
    assert torch.equal(s_k, s_p) and torch.equal(w_k, w_p)


def _tree_run(device, shape, kvops, batch=16):
    n = BzTreeIndex.words_needed(**shape)
    tree = BzTreeIndex(KernelBackend(n_words=n, device=device),
                       device=device, **shape)
    results = []
    for i in range(0, len(kvops), batch):
        results += [(r.status, r.value, r.rounds)
                    for r in tree.apply(kvops[i:i + batch])]
    return tree, results


@pytest.mark.parametrize("shape", [
    dict(leaf_cap=8, root_cap=4, n_regions=128),
    dict(leaf_cap=64, root_cap=64, n_regions=16)])
def test_bztree_on_the_card_matches_cpu(cuda, shape):
    """A splitting seeded stream on a card tree and a CPU tree: results,
    word tables, allocator masks and counters equal.  The card's wide
    split ops took the global route: every split at node caps of 64 (a
    132-word op), the leaf splits at leaf_cap 8 (20 words; an inner split
    at root_cap 4 is 12 words and takes smem)."""
    spec = WorkloadSpec(n_ops=256, n_keys=600, read=0.1, update=0.15,
                        insert=0.6, delete=0.1, scan=0.05, seed=3)
    kvops = load_phase(spec, 0.5) + compile_workload(spec)
    pm_kernel.reset_counts()
    card, res_k = _tree_run(cuda, shape, kvops)
    routes = dict(pmwcas_apply_cuda.route_launches)
    cpu, res_p = _tree_run("cpu", shape, kvops)
    assert res_k == res_p
    assert np.array_equal(card.backend.values(), cpu.backend.values())
    assert np.array_equal(card.allocator.mask(), cpu.allocator.mask())
    counters = ("splits", "root_splits", "consolidations", "rounds_run",
                "mwcas_submitted", "mwcas_won")
    assert [getattr(card, c) for c in counters] == \
        [getattr(cpu, c) for c in counters]
    assert card.splits >= 2 and routes["global"] >= 1
    if shape["leaf_cap"] == shape["root_cap"] == 64:
        assert routes["global"] == card.splits
    assert card.gc_regions() == cpu.gc_regions() >= 1
    assert np.array_equal(card.backend.values(), cpu.backend.values())
    assert card.check_integrity() == cpu.check_integrity()


def test_freelist_on_the_card_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    fls = [FreeListAllocator(300, region_base=2, region_words=390,
                             device=d) for d in (cuda, "cpu")]
    assert fls[0]._mask.is_cuda
    owned = []
    for _ in range(24):
        if owned and rng.random() < 0.3:
            slots = owned.pop(int(rng.integers(len(owned))))
            for fl in fls:
                fl.free(slots)
            continue
        counts = rng.integers(0, 40, 3).tolist()
        got = []
        for fl in fls:
            try:
                got.append(fl.alloc(counts))
            except OutOfRegions as e:
                got.append(("full", e.requests, e.grants))
        assert got[0] == got[1]
        grants = got[0] if got[0][0] != "full" else got[0][2]
        owned += [g for g in grants if g]
        assert np.array_equal(fls[0].mask(), fls[1].mask())
    cands = [sorted(rng.choice(300, 3, replace=False).tolist())
             for _ in range(2000)]           # [2000, 3]: the global route
    pm_kernel.reset_counts()
    assert fls[0].reserve(cands) == fls[1].reserve(cands)
    assert pmwcas_apply_cuda.route_launches["global"] == 1
    assert np.array_equal(fls[0].mask(), fls[1].mask())


def test_bztree_service_on_the_card_matches_cpu(cuda):
    """Small BzTree KVService shards on the card and on the CPU: the same
    futures, items and tables."""
    spec = WorkloadSpec(n_ops=512, n_keys=800, read=0.0, update=0.0,
                        insert=0.05, delete=0.0, scan=0.95, alpha=0.99,
                        seed=2)
    outs = []
    for device in (cuda, "cpu"):
        svc = KVService(4, structure="bztree", leaf_cap=8, root_cap=4,
                        n_regions=64, round_cap=64, device=device)
        futs = svc.submit_many(load_phase(spec, 0.5))
        for c, stream in enumerate(client_streams(spec, 8)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        outs.append(([(f.status, f.result.value, f.done_step) for f in futs],
                     [b.values().tolist() for b in svc.backends],
                     svc.check_integrity()))
    assert outs[0] == outs[1]


def test_batch_scheduler_on_the_card_matches_cpu(cuda):
    stream = chip_smoke.raw_stream(4, 4, 64, 600, cross=0.15)
    outs = []
    for device in (cuda, "cpu"):
        backends = [KernelBackend(n_words=64, device=device)
                    for _ in range(4)]
        sched = BatchScheduler(backends, ShardRouter(4, words_per_shard=64),
                               round_cap=16)
        futs = []
        for start in range(0, len(stream), 50):
            futs += [sched.submit(MwCASOp(t), client=i % 8)
                     for i, t in enumerate(stream[start:start + 50])]
            sched.step()
        sched.drain()
        outs.append(([(f.success, f.latency_rounds) for f in futs],
                     [b.values().tolist() for b in backends],
                     sched.stats.steps, sched.stats.cross_rounds,
                     [(sh.rounds, sh.defers) for sh in sched.stats.shards]))
    assert outs[0] == outs[1]
    assert outs[0][3] > 0


# ---------------------------------------------------------------------------
# the cycle-accurate simulator kernel (csrc/pmwcas_sim.cu)
# ---------------------------------------------------------------------------

def _sim_states_equal(got, want):
    assert not chip_smoke.sim_diff(got.state, want.state)
    assert got.drain_rounds == want.drain_rounds


def test_sim_kernel_record_layout(cuda):
    assert sim_kernel.kernel_rec_len() == sim_kernel.REC_LEN


@pytest.mark.parametrize("case", range(len(chip_smoke.SIM_CASES)),
                         ids=lambda i: "{}-{}".format(
                             chip_smoke.SIM_CASES[i][0], i))
def test_sim_kernel_matches_plain(cuda, case):
    """Drained and cut at ``SIM_CUT``: every state field bit for bit."""
    specs = chip_smoke.sim_specs(sim_core, [chip_smoke.SIM_CASES[case]])
    for got, want in zip(sim_core.run_sims(specs, device=cuda),
                         sim_core.run_sims(specs, device="cpu")):
        _sim_states_equal(got, want)


def test_sim_kernel_batched_equals_alone(cuda):
    specs = chip_smoke.sim_specs(sim_core)
    before = sim_kernel.pmwcas_sim_cuda.launches
    batched = sim_core.run_sims(specs, device=cuda)
    assert sim_kernel.pmwcas_sim_cuda.launches == before + 1
    for spec, got in zip(specs, batched):
        _sim_states_equal(got, sim_core.run_sims([spec], device=cuda)[0])


def test_sim_kernel_continues_a_carried_state(cuda):
    """``run_state`` from a state at step n, on the card, equals the run
    to step N."""
    cfg = sim_core.SimConfig(algorithm="original", n_threads=8, n_words=32,
                             k=2, n_steps=3000, max_ops=32, seed=7,
                             alpha=1.0)
    sched = sim_core.generate_schedule(cfg)
    mid = sim_core.run_until(cfg, 1000, device="cpu")
    st = sim_core.state_from_arrays(cfg, mid.state, device=cuda)
    got = sim_core.run_state(cfg, st, sched[1000:], drain=True)
    _sim_states_equal(got, sim_core.run_sim(cfg, device="cpu"))


def test_sim_kernel_out_len_and_smem_bytes(cuda):
    assert sim_kernel.kernel_out_len() == sim_kernel.OUT_LEN
    for T, k in ((56, 3), (1, 1), (1024, 2), (4096, 3), (4, 32)):
        cfg = sim_core.SimConfig(n_threads=T, k=k, n_words=1 << 12)
        assert sim_kernel.kernel_smem_bytes(cfg) == sim_kernel.smem_bytes(cfg)


def _route_run(route, fn):
    """``fn()``, checked to take exactly one launch, on ``route``."""
    before = dict(sim_kernel.pmwcas_sim_cuda.route_launches)
    out = fn()
    after = sim_kernel.pmwcas_sim_cuda.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    return out


@pytest.mark.parametrize("route", sim_kernel.ROUTES)
@pytest.mark.parametrize("case", range(len(chip_smoke.SIM_CASES)),
                         ids=lambda i: "{}-{}".format(
                             chip_smoke.SIM_CASES[i][0], i))
def test_sim_kernel_route_matches_plain(cuda, case, route):
    """Each forced route, drained and cut at ``SIM_CUT``: every state field
    bit for bit, and the kernel's own nanoseconds a simulation."""
    specs = chip_smoke.sim_specs(sim_core, [chip_smoke.SIM_CASES[case]])
    got = _route_run(route, lambda: sim_core.run_sims(specs, device=cuda,
                                                      route=route))
    assert (sim_kernel.pmwcas_sim_cuda.last_out[:, sim_kernel.O_NS] > 0).all()
    for g, want in zip(got, sim_core.run_sims(specs, device="cpu")):
        _sim_states_equal(g, want)


@pytest.mark.parametrize("route", sim_kernel.ROUTES)
def test_sim_kernel_route_continues_a_carried_state(cuda, route):
    """``run_state`` on each route from a state at step n equals the run
    to step N."""
    cfg = sim_core.SimConfig(algorithm="original", n_threads=8, n_words=32,
                             k=2, n_steps=3000, max_ops=32, seed=7,
                             alpha=1.0)
    sched = sim_core.generate_schedule(cfg)
    mid = sim_core.run_until(cfg, 1000, device="cpu")
    st = sim_core.state_from_arrays(cfg, mid.state, device=cuda)
    got = _route_run(route, lambda: sim_core.run_state(
        cfg, st, sched[1000:], drain=True, route=route))
    _sim_states_equal(got, sim_core.run_sim(cfg, device="cpu"))


@pytest.mark.parametrize("route", sim_kernel.ROUTES)
@pytest.mark.parametrize("T,k,cap", chip_smoke.BACKEND_CASES[:4],
                         ids=lambda v: str(v))
def test_sim_backend_mode_route_matches_plain(cuda, T, k, cap, route):
    """``MODE_BACKEND`` on each route: outputs (error, thread, steps) and
    the whole state after, the attempt-cap exits (cap 2: the read phase,
    12: an attempt) included."""
    cpu = chip_smoke.backend_jobs(sim_core, sim_kernel, "cpu", T, k, cap, 0)
    want = sim_core.sim.run_jobs(cpu)
    jobs = chip_smoke.backend_jobs(sim_core, sim_kernel, cuda, T, k, cap, 0)
    got = _route_run(route, lambda: sim_core.sim.run_jobs(jobs, route=route))
    cols = [sim_kernel.O_ROUNDS, sim_kernel.O_ERR, sim_kernel.O_ERR_THREAD,
            sim_kernel.O_STEPS]
    assert np.array_equal(got[:, cols], want[:, cols])
    for a, b in zip(jobs, cpu):
        assert not chip_smoke.sim_diff(sim_core.state_to_arrays(a.state),
                                       sim_core.state_to_arrays(b.state))


@pytest.mark.parametrize("route", sim_kernel.ROUTES)
@pytest.mark.parametrize("alg", ["ours", "ours_df", "original", "pcas"])
def test_sim_backend_route_on_card(cuda, alg, route, monkeypatch):
    """``SimBackend`` with its launches forced onto ``route``: verdicts,
    values and counters equal the CPU's."""
    from repro_torch.pmwcas import backends
    real = backends.run_jobs

    def forced(jobs):
        on_card = jobs[0].state["pc"].is_cuda
        return real(jobs, route=route if on_card else None)

    monkeypatch.setattr(backends, "run_jobs", forced)
    k = 1 if alg == "pcas" else 3
    init, ops = increment_batch(64, k, 24, seed=5)
    outs = []
    for device in (cuda, "cpu"):
        b = SimBackend(64, algorithm=alg, values=init, device=device)
        verdicts = [r.success for r in b.execute(ops)]
        if device is cuda:
            assert sim_kernel.pmwcas_sim_cuda.last_route == route
        outs.append((verdicts, b.values().tolist(), b.counters.tolist()))
    assert outs[0] == outs[1]


def test_sim_kernel_wide_state_goes_global(cuda):
    """States past the shared memory of a block: the plan sends the launch
    to ``global`` (a SimBackend round of 1,024 ops and a scheduled
    simulation of 1,024 threads beside a small one), and forcing ``smem``
    raises before anything launches."""
    T, k, cap = chip_smoke.BACKEND_CASES[4]
    cpu = chip_smoke.backend_jobs(sim_core, sim_kernel, "cpu", T, k, cap, 0)
    want = sim_core.sim.run_jobs(cpu)
    jobs = chip_smoke.backend_jobs(sim_core, sim_kernel, cuda, T, k, cap, 0)
    assert sim_kernel.plan(jobs) == ("global", 0)
    got = _route_run("global", lambda: sim_core.sim.run_jobs(jobs))
    assert np.array_equal(got[:, :sim_kernel.O_NS],
                          want[:, :sim_kernel.O_NS])
    for a, b in zip(jobs, cpu):
        assert not chip_smoke.sim_diff(sim_core.state_to_arrays(a.state),
                                       sim_core.state_to_arrays(b.state))
    wide = sim_core.SimConfig(algorithm="ours", n_threads=1024, k=3,
                              n_words=4096, n_steps=6000, max_ops=4, seed=2)
    small = sim_core.SimConfig(algorithm="original", n_threads=4, k=2,
                               n_words=64, n_steps=800, max_ops=8, seed=2)
    specs = [(wide, None, None, True, None), (small, None, None, False, 500)]
    got = _route_run("global",
                     lambda: sim_core.run_sims(specs, device=cuda))
    for g, w in zip(got, sim_core.run_sims(specs, device="cpu")):
        _sim_states_equal(g, w)
    before = sim_kernel.pmwcas_sim_cuda.launches
    with pytest.raises(ValueError, match="smem route takes at most"):
        sim_core.run_sims(specs, device=cuda, route="smem")
    assert sim_kernel.pmwcas_sim_cuda.launches == before


@pytest.mark.parametrize("alg", ["ours", "ours_df", "original", "pcas"])
def test_sim_backend_stop_mode_on_card(cuda, alg):
    k = 1 if alg == "pcas" else 3
    init, ops = increment_batch(64, k, 24, seed=5)
    outs = []
    for device in (cuda, "cpu"):
        b = SimBackend(64, algorithm=alg, values=init, device=device)
        verdicts = [r.success for r in b.execute(ops)]
        outs.append((verdicts, b.values().tolist(), b.counters.tolist()))
    assert outs[0] == outs[1]
    assert any(outs[0][0])


def test_sim_backend_mixed_widths_and_cap_on_card(cuda):
    ops = [MwCASOp([(1, 0, 5), (4, 0, 2**32 - 1)]), MwCASOp([(2, 0, 9)]),
           MwCASOp([(4, 0, 3), (6, 0, 1), (7, 0, 8)])]
    outs = []
    for device in (cuda, "cpu"):
        b = SimBackend(8, values=[0] * 8, device=device)
        outs.append(([r.success for r in b.execute(ops)],
                     b.values().tolist(), b.counters.tolist()))
        for cap, msg in ((1, "read phase"), (3, "attempt of op 0")):
            capped = SimBackend(8, values=[0] * 8, attempt_cap=cap,
                                device=device)
            with pytest.raises(RuntimeError, match=msg):
                capped.execute(ops)
    assert outs[0] == outs[1]


def test_sim_crash_sweep_and_pinned_case_on_card(cuda):
    pin = sim_core.SimConfig(**chip_smoke.PIN_CFG)
    got = sim_core.run_until(pin, chip_smoke.PIN_STEP, device=cuda)
    _sim_states_equal(got, sim_core.run_until(pin, chip_smoke.PIN_STEP,
                                              device="cpu"))
    with pytest.raises(sim_core.RecoveryError, match=r"words \[15\]"):
        sim_core.check_crash_consistency(pin, got.state)
    batch = [MwCASOp.increment([a, a + 1], [0, 0]) for a in (0, 2, 4)]
    batch.append(MwCASOp.increment([1, 4], [0, 0]))
    steps = list(range(1, 400, 13))
    assert check_sim_crash_sweep(batch, crash_steps=steps, n_steps=400,
                                 device=cuda) == len(steps)


def test_sim_session_runs_and_crashes_on_card(cuda):
    """``SimSession`` on the card: ``run`` and ``run_until`` equal the
    CPU's on every state field, one launch each, and ``crash_at`` on the
    pinned ORIGINAL case raises the reference's RecoveryError."""
    session = SimSession().configure(**chip_smoke.PIN_CFG)
    before = sim_kernel.pmwcas_sim_cuda.launches
    for run in (lambda s: s.run(), lambda s: s.run_until(400)):
        _sim_states_equal(run(session.with_device(cuda)),
                          run(session.with_device("cpu")))
    with pytest.raises(sim_core.RecoveryError,
                       match=r"words \[15\]: recovered=\[1\] "
                             r"expected=\[2\]"):
        session.with_device(cuda).crash_at(chip_smoke.PIN_STEP)
    assert sim_kernel.pmwcas_sim_cuda.launches == before + 3


def test_kv_service_on_sim_shards_on_card(cuda):
    """``KVService(backend="sim")`` with its shards on the card equals the
    same service on the CPU (futures, items, word tables, counters), and
    every round went through the simulator kernel."""
    spec = WorkloadSpec(n_ops=48, n_keys=24, read=0.25, update=0.3,
                        insert=0.35, delete=0.1, alpha=0.9, seed=4)
    outs = []
    for device in (cuda, "cpu"):
        before = sim_kernel.pmwcas_sim_cuda.launches
        svc = KVService(n_shards=2, backend="sim", n_buckets=16,
                        round_cap=8, device=device)
        futs = svc.submit_many(load_phase(spec, 0.5))
        futs += [svc.submit(op, client=i % 4)
                 for i, op in enumerate(compile_workload(spec))]
        svc.drain()
        launched = sim_kernel.pmwcas_sim_cuda.launches - before
        assert all(b.name == "sim" for b in svc.backends)
        outs.append(([(f.status, f.result.value, f.done_step) for f in futs],
                     svc.items(), [b.values().tolist() for b in svc.backends],
                     [np.asarray(b.counters).tolist()
                      for b in svc.backends],
                     svc.stats.steps))
        assert (launched > 0) == (device is cuda)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# chaos on the card (repro_torch.chaos; chip_smoke.py phase 10)
# ---------------------------------------------------------------------------

def test_chaos_sim_native_on_card_matches_cpu(cuda):
    """``sim_native`` with its shards on the card equals the same scenario
    on the CPU (trace, items, every integer, the checker's stats), one
    simulator launch a shard round."""
    sc = chaos.sim_native(seed=0, waves=12)
    before = sim_kernel.pmwcas_sim_cuda.launches
    driver = chaos.ScenarioDriver(sc, device=cuda)
    card = driver.run()
    launched = sim_kernel.pmwcas_sim_cuda.launches - before
    cpu = chaos.ScenarioDriver(sc, device="cpu").run()
    assert card.check.ok and card.check.mutations > 0
    assert chip_smoke.chaos_mismatch(card, cpu) == []
    assert launched == driver.svc.stats.rounds > 0


def test_chaos_kernel_storm_on_card_matches_cpu(cuda):
    """``hot_key_storm`` on kernel shards with its shard storm alone: card
    == CPU, every launch on the ``smem`` route, one a dispatch."""
    sc = chip_smoke.kernel_storm(chaos, 0, 20)
    pm_kernel.reset_counts()
    driver = chaos.ScenarioDriver(sc, device=cuda)
    card = driver.run()
    routes = dict(pmwcas_apply_cuda.route_launches)
    cpu = chaos.ScenarioDriver(sc, device="cpu").run()
    assert card.check.ok and card.faults_fired > 0
    assert chip_smoke.chaos_mismatch(card, cpu) == []
    disp = driver.svc.stats.dispatch
    assert routes["global"] == 0 and routes["smem"] > 0
    assert routes["smem"] == disp.dispatches + disp.serial_rounds


@pytest.mark.parametrize("family", [f for f in chaos.FAMILIES
                                    if f != "sim_native"])
def test_chaos_durable_family_on_card_matches_cpu(cuda, family, tmp_path):
    """A durable family with the service on the card (its shards are host
    code; the device is checked and carried through every crash) equals
    the CPU run."""
    sc = chaos.FAMILIES[family](seed=0, waves=20)
    card = chaos.ScenarioDriver(sc, tmp_path / "card", device=cuda).run()
    cpu = chaos.ScenarioDriver(sc, tmp_path / "cpu", device="cpu").run()
    assert card.check.ok
    assert chip_smoke.chaos_mismatch(card, cpu) == []


def test_chaos_driver_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    """With no card, asking for one raises when the driver is made, for
    every backend kind, and nothing runs on the CPU instead (the CUDA
    probe is patched, so this runs with and without a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for sc in (chaos.sim_native(seed=0, waves=4),
               chaos.hot_key_storm(seed=0, waves=4),
               chip_smoke.kernel_storm(chaos, 0, 4)):
        with pytest.raises(RuntimeError, match="cuda"):
            chaos.ScenarioDriver(sc, tmp_path / sc.backend)
        with pytest.raises(RuntimeError, match="cuda"):
            chaos.run_scenario(sc, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        chaos.chaos_sweep(seed=0, waves=4)
    assert not list(tmp_path.iterdir()), "a refused driver wrote a pool"


# ---------------------------------------------------------------------------
# the MoE sublayer: routing, the layer, the granite smoke config and
# qwen1.5's bf16 serve on the card against the CPU
# ---------------------------------------------------------------------------

def test_moe_route_card_vs_cpu(cuda):
    from repro_torch.models import moe
    out = chip_smoke.moe_routing_vs_cpu(moe, cuda, 0)
    assert out["gate_err"] <= 1e-6
    assert out["dropped"]["drops_cf0.05"] > 0.5 and out["dropped"]["cf8"] == 0


def test_moe_layer_card_vs_cpu_and_planted_faults(cuda):
    from repro_torch.models import attention, moe
    out = chip_smoke.moe_apply_vs_cpu(moe, attention, cuda, 0)
    for key, r in out.items():
        tol = chip_smoke.MOE_APPLY_TOL[key.split("_")[1]]
        assert r["err"] <= tol < min(r["faults"].values()), key


def test_moe_small_serve_and_train_card_vs_cpu(cuda):
    import repro_torch.data as data
    from repro_torch.models import attention
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    out = chip_smoke.moe_small_vs_cpu(serve_mod, build_model, get_config,
                                      TrainModel, adamw, data, attention,
                                      fa_kernel, 0, cuda)
    n = get_config("granite-moe-3b-a800m", smoke=True).n_layers
    assert out["serve_bf16"] == dict(tc=n, decode=n * 8, simt=0)
    assert out["qwen_serve_bf16"]["simt"] == 0
    for dt in ("float32", "bfloat16"):
        assert out[f"train_{dt}"]["grad_err"] <= chip_smoke.SMALL_TOL[dt][1]


# ---------------------------------------------------------------------------
# the xLSTM and Mamba sublayers: the blocks at full width, the xlstm-125m
# and jamba smoke configs on the card against the CPU
# ---------------------------------------------------------------------------

def test_ssm_blocks_card_vs_cpu_and_planted_faults(cuda):
    """``apply_mlstm``/``apply_slstm`` at xlstm-125m's widths and
    ``apply_mamba`` at jamba's, f32 and bf16, within
    ``chip_smoke.BLOCK_TOL``; each block's planted fault reads above it
    (the recurrent products in f32 need TF32 off, as the smoke sets)."""
    from repro_torch.models import attention, ssm, xlstm
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.ssm_blocks_vs_cpu(xlstm, ssm, attention, get_config,
                                       cuda, 0)
    for dtype, res in out.items():
        tol = chip_smoke.BLOCK_TOL[dtype]
        for name, r in res.items():
            assert r["err"] <= tol < min(r["faults"].values()), (dtype, name)


def test_ssm_small_serve_and_train_card_vs_cpu(cuda):
    import repro_torch.data as data
    from repro_torch.models import attention
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.ssm_small_vs_cpu(serve_mod, build_model, get_config,
                                      TrainModel, adamw, data, attention,
                                      fa_kernel, 0, cuda)
    assert out["jamba-v0.1-52b serve_bf16"] == dict(tc=1, decode=8, simt=0)
    assert out["xlstm-125m serve_bf16"] == dict(tc=0, decode=0, simt=0)
    for key, r in out.items():
        if "train_" in key:
            dt = key.split("train_")[1]
            tol = chip_smoke.SMALL_TOL[dt][1]
            if key.startswith("xlstm"):
                tol = max(tol, chip_smoke.MLSTM_F32_GRAD_TOL)
            assert r["grad_err"] <= tol, key


# ---------------------------------------------------------------------------
# encoder-decoder stacks, cross-attention and the frontends: the seamless
# and paligemma smoke configs on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b"])
def test_encdec_small_bf16_serve_card_vs_cpu(cuda, arch):
    """bf16 at head_dim 64 (seamless: the encoder, the decoder's and the
    cross-attention's prefill on tc, both decode forms on decode) and 256
    (paligemma's MQA, g = 4)."""
    small = chip_smoke.ENCDEC_SMALL[arch]
    routes = chip_smoke.small_serve_matches_cpu(
        serve_mod, build_model, get_config, 0, cuda, dtype="bfloat16",
        tol=chip_smoke.SERVE_BF16_TOL, rtol=0.0, arch=arch, **small)
    cfg = chip_smoke.small_serve_config(get_config, "bfloat16",
                                        small["head_dim"], arch,
                                        small["over"])
    prompt, step = chip_smoke.flash_calls(cfg)
    assert routes == dict(tc=prompt, decode=step * 8, simt=0)


def test_encdec_small_train_card_vs_cpu_and_cross_causal_fault(cuda):
    import repro_torch.data as data
    from repro_torch.models import attention
    from repro_torch.models.transformer import TrainModel
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.small_train_matches_cpu(
        get_config, TrainModel, adamw, data, attention, fa_kernel, "float32",
        0, cuda, arch="seamless-m4t-medium",
        faults_of=chip_smoke.ENCDEC_FAULTS)
    tol = chip_smoke.SMALL_TOL["float32"][1]
    assert out["grad_err"] <= tol < out["faults"]["cross_causal"]["grad"]


# ---------------------------------------------------------------------------
# the int8 KV cache (chip_smoke.py phase 15 (a)-(b))
# ---------------------------------------------------------------------------

def test_int8_quant_card_vs_cpu(cuda):
    """Bit for bit on every bf16 magnitude of either sign (the 420 rows
    at 127.5 saturate) and on random keys in bf16 and f32."""
    from repro_torch.models import attention
    out = chip_smoke.int8_quant_vs_cpu(attention, cuda, 0)
    assert all(r["differ"] == 0 for r in out.values())
    assert out["bf16_magnitudes_pos"]["faults"]["wrapped_cast"] == 420


def test_int8_attention_card_vs_cpu_and_planted_faults(cuda):
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.int8_attention_vs_cpu(attention, cuda, 0)
    for name, r in out.items():
        assert r["err"] <= r["tol"], name
        if "bfloat16" in name:
            assert r["faults"]["wrapped_cast"] > r["tol"], name


@pytest.mark.parametrize("arch", chip_smoke.INT8_SMALL_ARCHS)
def test_int8_small_serve_card_vs_cpu(cuda, arch, monkeypatch):
    """f32 within 1e-3 and bf16 within ``SERVE_BF16_TOL`` of the CPU, no
    flash launch; each planted fault above the limit."""
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(chip_smoke, "INT8_SMALL_ARCHS", (arch,))
    out = chip_smoke.int8_small_vs_cpu(serve_mod, build_model, get_config,
                                       attention, fa_kernel, 0, cuda)
    assert len(out) == 2          # each checked within its limit there
    for r in out.values():
        assert r["flash"] == 0
        assert r["faults"] and all(e > r["tol"]
                                   for e in r["faults"].values())


# ---------------------------------------------------------------------------
# cell programs (chip_smoke.py phase 16)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_build_cell_card_vs_cpu(cuda, mode, dtype):
    """``build_cell``'s prefill and decode steps at llama3-8b's smoke
    config on the card against the CPU: f32 within 1e-3, bf16 (head_dim
    128) within ``SERVE_BF16_TOL``; every layer's flash call on the route
    the plan gives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.cell_small_vs_cpu(get_config, fa_kernel, cuda, 0,
                                       mode, dtype)
    assert out["err"] <= out["tol"]
    want = ("decode" if mode == "decode"
            else "tc" if dtype == "bfloat16" else "simt")
    assert out["routes"] == {want: get_config("llama3-8b",
                                              smoke=True).n_layers}


# ---------------------------------------------------------------------------
# a cell across the cards of a mesh (chip_smoke.py phase 17)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_one_rank_group_equals_cell_run(cuda, mode, tmp_path):
    """``build_cell``'s prefill and decode at llama3-8b's smoke config (bf16
    at head_dim 128) through a one-rank NCCL group: the same logits as
    the program run without a group, bit for bit, every layer's flash
    launch on the route the plan gives, no collective."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.parallel.group import (destroy_mesh_group,
                                            init_mesh_group)
    from repro_torch.parallel.sharding import leaves
    cfg = chip_smoke.small_serve_config(get_config, "bfloat16",
                                        chip_smoke.SERVE_BF16_HEAD_DIM)
    S, B = chip_smoke.CELL_SMALL[mode]
    cell = steps.build_cell(cfg, ShapeConfig(f"{mode}_small", S, B, mode),
                            chip_smoke.one_card_mesh())

    def fill(state):
        if mode == "decode":
            gen = torch.Generator(device=cuda).manual_seed(17)
            for _, t in leaves(state.args["cache"]):
                t.normal_(generator=gen)
            state.args["cache"]["index"] = S - 1

    plain = cell.materialize(cuda, 0)
    fill(plain)
    want, _ = cell.run(plain)
    group = init_mesh_group(cell.mesh, 0, tmp_path / "store", cuda)
    try:
        mine = cell.materialize(cuda, 0, group=group)   # the same draws
        fill(mine)
        fa_kernel.reset_counts()
        got, _ = cell.run(mine)
        torch.cuda.synchronize()
        assert mine.model.par.coll.records == []
    finally:
        destroy_mesh_group()
    assert torch.equal(got, want)
    route = "decode" if mode == "decode" else "tc"
    assert flash_attention_cuda.route_launches[route] == cfg.n_layers
    assert flash_attention_cuda.launches == cfg.n_layers


def test_mesh_cells_on_four_cards(cuda):
    """``chip_smoke.mesh_cells`` at the smoke config on four cards (the
    function ``scripts/mesh_cell.py`` runs): each rank's bytes the dry
    run's, its collectives the trace's, its flash launches on the plan's
    route, rank 0 against one card within its limit (the prefill bit for
    bit; the decode's distance from the f32 step within 1.5 times one
    card's, and from one card within twice it) and the planted faults
    above it (the function checks each)."""
    if torch.cuda.device_count() < chip_smoke.MESH_RANKS:
        pytest.skip(f"needs {chip_smoke.MESH_RANKS} cards, this host has "
                    f"{torch.cuda.device_count()}")
    torch.cuda.synchronize()
    out = chip_smoke.mesh_cells(0, small=True)
    for name in chip_smoke.MESH_CELLS:
        assert len(out[name]) == chip_smoke.MESH_RANKS
        head = out[name][0]
        assert head["one_card_err"] <= head["limit"]
        if "f32_err" in head:
            assert head["f32_err"] <= head["f32_limit"]


# ---------------------------------------------------------------------------
# jamba across four cards (chip_smoke.py phase 18)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(chip_smoke.JAMBA_FLASH))
def test_jamba_four_card_flash_call(cuda, name):
    """Each of jamba's four-card cells' flash call on one card (a card's
    8 query and 2 kv heads of every request): the kernel against its
    plain version within 2e-2 and ``FA_ROW_TOL`` a row, the planted
    faults above the row limit (``flash_32k`` checks both), on the route
    and split count of ``chip_smoke.JAMBA_FLASH``."""
    res = chip_smoke.jamba_flash_call(fa_ref, fa_kernel, name, cuda, 0)
    _, _, _, route, splits = chip_smoke.JAMBA_FLASH[name]
    assert (res["route"], res["splits"]) == (route, splits)
    assert res["err"] <= 2e-2 and res["row_err"] <= chip_smoke.FA_ROW_TOL
    assert min(res["faults"].values()) > chip_smoke.FA_ROW_TOL


def test_jamba_mesh_cells_on_four_cards(cuda):
    """``chip_smoke.jamba_mesh_cells`` at the smoke config on four cards:
    each rank's bytes the dry run's, its collectives the trace's, its
    flash launches on the plan's route, and at one unit every rank
    routing alike and rank 0's distance from the f32 step within 1.5
    times one card's (one card on rank 0's experts), which the planted
    faults exceed (the function checks each)."""
    if torch.cuda.device_count() < chip_smoke.MESH_RANKS:
        pytest.skip(f"needs {chip_smoke.MESH_RANKS} cards, this host has "
                    f"{torch.cuda.device_count()}")
    torch.cuda.synchronize()
    out = chip_smoke.jamba_mesh_cells(0, small=True)
    for name in chip_smoke.JAMBA_CELLS:
        assert len(out[name]) == chip_smoke.MESH_RANKS
        unit = out["unit " + name]
        assert unit["f32_err"] <= unit["f32_limit"] < min(
            unit["faults_f32"].values())
