#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card and build — the card's name and power limit, then the four
   Hopper sources built from ``src/repro_torch/csrc/{pmwcas_apply,
   flash_attention_tc, flash_attention_decode, flash_attention}.cu``, one
   nvcc each in parallel (seconds, ptxas registers/spills);
2. kernels vs plain — the PMwCAS kernel's verdicts and tables held bit
   for bit against its plain PyTorch version on both routes (``smem``,
   where its hash fits, and ``global``) over seeded ``[S, B, K]``
   batches (S in {1, 4}, B in {1, 7, 1024}, K in {1, 2, 8}, serve's
   ``[1, 128, 9]`` and a ``global``-sized ``[2, 4500, 2]``; uniform and
   Zipf-hot addresses; all-padded rows, duplicate ids, (a)-passing rows
   that lose and still block) and over batches whose every address the
   smem hash sends to one home bucket; ``reserve_slots``' corner cases
   on both routes and ``sequential_oracle`` containment, and the service
   on the card against the service on the CPU; then the flash op against
   its plain version over ``FA_CHECK_CASES`` in f32 (2e-5) and bf16
   (2e-2, and ``FA_ROW_TOL`` per row), each call on the route the plan
   gives it (``tc``, ``decode`` or ``simt``), and two small serves
   (llama3-8b smoke config: f32 within 1e-3, and bf16 at head_dim 128,
   which runs the ``tc`` and ``decode`` routes, within
   ``SERVE_BF16_TOL``) on the card against the CPU;
3. the KV slice at full size — ``KVService(n_shards=4, round_cap=1024)``
   with 1,048,576 records (4 x 1,048,576-word tables on the card, the
   rows of one persistent ``[4, W]`` tensor), loaded, then driven by
   YCSB core workload A (50% read, 50% update, Zipfian 0.99) from 8
   clients in bounded windows; integrity, the acknowledged writes read
   back, ``conflict_rate == 0``, every wave one launch on the ``smem``
   route, and the tables still rows of that tensor are checked;
4. PMwCAS timings — the device time per wave of a profiled window by op
   name (the dispatch's kernel, upload and verdict copy; the rest), the
   kernel's time per launch on both routes and the plain version's at
   the slice's shape beside the byte bound and the latency floor (an
   empty launch plus three dependent 4-byte loads), the per-wave host
   split of a traced window, ops/s and p50/p99 latency;
5. the LM serve slice at full width — ``repro_torch.launch.serve.serve``
   on llama3-8b (32 layers, bf16 weights drawn on the card from the
   seed, ``attn_impl="pallas"``): 128 proposed requests of 2048 prompt
   tokens and 32 greedy decode steps, KV pages of 256 tokens out of 1024;
   admission equals the plain ``reserve_slots``, logits are finite, and
   the flash op runs exactly 32 x (1 + 32) times on the path: 32 on the
   ``tc`` route (prefill), 1,024 on the ``decode`` route;
6. flash timings — kernel against plain at the slice's prefill and
   decode shapes in f32 (2e-5) and bf16 (2e-2 and ``FA_ROW_TOL`` per
   row), faults planted in the plain version's inputs read above the row
   limit, the route and split count, the stream time per call (CUDA
   events) of the kernel, the plain version and SDPA beside the bound and
   the achieved TFLOP/s or TB/s, at the decode shape also their device
   time from replayed CUDA graphs (kernel and SDPA in turns); then
   one prefill and a window of decode steps profiled: the device idle
   share, the device time by kernel group (flash, matrix products, the
   rest), and the flash time per prefill launch in the model against
   alone.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``{"kernels": [...]}`` record, and the line before that the
decode shape's numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA's H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor cores, same sheet
N_SHARDS, ROUND_CAP, N_CLIENTS = 4, 1024, 8
RECORDS, OPS = 1 << 20, 1 << 16      # YCSB-A recordcount, operationcount


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _batch(rng, S, B, K, W, hot, words_np):
    """One seeded [S, B, K] batch against ``words_np [S, W]``: expected
    values mostly current (so rows pass (a)), some stale (rows fail (a)),
    ~10% padded slots, a few all-padded rows and duplicate ids."""
    if hot:
        ranks = np.arange(1, W + 1, dtype=np.float64) ** -0.99
        addr = rng.choice(W, size=(S, B, K), p=ranks / ranks.sum())
    else:
        addr = rng.integers(0, W, size=(S, B, K))
    addr = addr.astype(np.int32)
    addr[rng.random((S, B, K)) < 0.1] = -1
    addr[:, rng.random(B) < 0.05, :] = -1                 # all-padded rows
    if K > 1:
        dup = rng.random((S, B)) < 0.05
        addr[..., 1][dup] = addr[..., 0][dup]             # duplicate ids
    cur = np.take_along_axis(words_np, np.maximum(addr, 0).reshape(S, -1),
                             1).reshape(S, B, K)
    exp = np.where(rng.random((S, B, K)) < 0.05, cur + 1, cur)
    des = rng.integers(0, 1 << 32, size=(S, B, K), dtype=np.uint64)
    return addr, exp.astype(np.uint32), des.astype(np.uint32)


def _colliding(kernel, rng, S, B, K, W):
    """A batch whose addresses the smem route's tag table (and so its
    hash too) sends to bucket 0, shared between rows and duplicated
    within some, expected values mostly current, against seeded ``[S, W]``
    words: every passing slot is contested and probes the whole cluster."""
    pool = np.flatnonzero(kernel.hash_bucket(
        np.arange(W), kernel.table_bits(B, K)[0]) == 0)
    words_np = np.zeros((S, W), np.uint32)
    words_np[:, pool] = rng.integers(0, 1 << 32, size=(S, len(pool)),
                                     dtype=np.uint64).astype(np.uint32)
    addr = rng.choice(pool[:B * K // 2], size=(S, B, K)).astype(np.int32)
    addr[rng.random((S, B, K)) < 0.1] = -1
    cur = np.take_along_axis(words_np, np.maximum(addr, 0).reshape(S, -1),
                             1).reshape(S, B, K)
    exp = np.where(rng.random((S, B, K)) < 0.05, cur + 1, cur)
    des = rng.integers(0, 1 << 32, size=(S, B, K), dtype=np.uint64)
    return words_np, addr, exp.astype(np.uint32), des.astype(np.uint32)


def _held(pm, ref, kernel, dev, words_np, addr, exp, des, route,
          what) -> int:
    """One launch on ``route`` against the plain version on the same
    inputs; returns the largest difference (must be 0)."""
    args = [pm.words_to_tensor(a, dev) for a in (addr, exp, des)]
    w_k = pm.words_to_tensor(words_np, dev)
    w_p = w_k.clone()
    s_k = kernel.pmwcas_apply_cuda(w_k, *args, route=route)
    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
    _sync(dev)
    diff = max(int((s_k.int() - s_p.int()).abs().max()),
               int((w_k.long() - w_p.long()).abs().max()))
    check(diff == 0, f"kernel != plain on the {route} route at {what}")
    B = addr.shape[1]
    check(bool(s_k.all(dim=1).logical_not().any()) or B < 1024,
          f"no loser on the {route} route at {what}")
    check(bool(s_k.any(dim=1).all()) or B < 1024,
          f"no winner on the {route} route at {what}")
    return diff


def kernel_vs_plain(pm, ref, kernel, seed: int, dev) -> int:
    """Bit-for-bit comparisons on ``dev``, every case on both routes (the
    smem route only where its hash fits); returns the largest absolute
    difference seen (must be 0)."""
    rng = np.random.default_rng(seed)
    worst = 0
    n_cases = dict.fromkeys(kernel.ROUTES, 0)
    shapes = [(S, B, K) for S in (1, 4) for B in (1, 7, 1024)
              for K in (1, 2, 8)] + [(1, 128, 9), (2, 512, 8), (1, 256, 16),
                                     (2, 4500, 2)]
    for S, B, K in shapes:
        for hot in (False, True):
            W = 4096 if hot else 1 << 20
            words_np = rng.integers(0, 1 << 32, size=(S, W),
                                    dtype=np.uint64).astype(np.uint32)
            addr, exp, des = _batch(rng, S, B, K, W, hot, words_np)
            for route in kernel.ROUTES:
                if route == "smem" and kernel.plan(B, K)[0] != "smem":
                    continue
                worst = max(worst, _held(
                    pm, ref, kernel, dev, words_np, addr, exp, des, route,
                    f"S={S} B={B} K={K} hot={hot}"))
                n_cases[route] += 1
    for S, B, K in ((4, 1024, 2), (1, 128, 9), (1, 512, 8)):
        batch = _colliding(kernel, rng, S, B, K, 1 << 25)
        for route in kernel.ROUTES:
            worst = max(worst, _held(pm, ref, kernel, dev, *batch, route,
                                     f"S={S} B={B} K={K}, one home bucket"))
            n_cases[route] += 1
    log(f"phase 2: kernel == plain bit for bit on {json.dumps(n_cases)} "
        "[S, B, K] batches by route (uniform, Zipf-hot, every address in "
        "one home bucket of the smem hash)")

    # (a)-passing rows that lose still block: rows 0,1 pass, 1 loses to 0
    # on word 3, and row 2 (disjoint from 0) loses to row 1
    addr = np.asarray([[[0, 3], [3, 4], [4, 5], [6, 7]]], np.int32)
    exp = np.zeros_like(addr, dtype=np.uint32)
    exp[0, 3, 1] = 9                                      # row 3 fails (a)
    des = np.ones_like(addr, dtype=np.uint32)
    for route in kernel.ROUTES:
        words = pm.words_to_tensor(np.zeros((1, 16), np.uint32), dev)
        s = kernel.pmwcas_apply_cuda(
            words, *[pm.words_to_tensor(a, dev) for a in (addr, exp, des)],
            route=route)
        check(s.cpu().tolist() == [[True, False, False, False]],
              f"blocking semantics broken on {route}: {s.cpu().tolist()}")

    # reserve_slots' corner cases (tests/test_kernels.py), kernel == plain
    # == the expected verdicts
    cases = [
        ([[3, 3, 5, -1]], None, [True]),                  # duplicate ids
        ([[-1, -1, -1], [0, 1, -1]], None, [True, True]),  # all-padded
        ([[0, 1, 2, 3], [3, 4, 5, 6], [7, 8, 9, 10], [4, 5, 11, 12]], None,
         [True, False, True, False]),                    # lower index wins
        ([[1, 2, -1]], 2, [False]),                       # already claimed
    ]
    for (reqs, taken, want), route in itertools.product(cases,
                                                        kernel.ROUTES):
        free = np.ones(16, np.uint32)
        if taken is not None:
            free[taken] = 0
        reqs = np.asarray(reqs, np.int32)
        m_k = pm.words_to_tensor(free, dev)
        m_p = m_k.clone()
        r = pm.words_to_tensor(reqs, dev)
        g_k = kernel.pmwcas_apply_cuda(m_k[None], r[None],
                                       torch.ones_like(r)[None],
                                       torch.zeros_like(r)[None],
                                       route=route)[0]
        _, g_p = ref.pmwcas_apply(m_p, r, torch.ones_like(r),
                                  torch.zeros_like(r))
        check(g_k.cpu().tolist() == g_p.cpu().tolist() == want,
              f"reserve_slots {reqs.tolist()} on {route}: "
              f"{g_k.cpu().tolist()}")
        check(torch.equal(m_k, m_p),
              f"reserve_slots mask {reqs.tolist()} on {route}")
        if route == kernel.plan(*reqs.shape)[0]:    # the op on its route
            m_r = pm.words_to_tensor(free, dev)
            _, g_r = pm.reserve_slots(m_r, r)
            check(torch.equal(g_r, g_k) and torch.equal(m_r, m_k),
                  f"reserve_slots {reqs.tolist()} != its kernel launch")
    log("phase 2: reserve_slots corner cases agree on both routes (kernel "
        "== plain == expected)")

    # sequential_oracle containment at contention
    for seed2 in range(8):
        r2 = np.random.default_rng(seed + 100 + seed2)
        W, B, K = 64, 40, 4
        words_np = r2.integers(0, 4, W).astype(np.uint32)
        addr = np.sort(np.stack([r2.choice(W, K, replace=False)
                                 for _ in range(B)]), 1).astype(np.int32)
        addr[r2.random((B, K)) < 0.1] = -1
        exp = r2.integers(0, 4, (B, K)).astype(np.uint32)
        des = exp + 1
        w = pm.words_to_tensor(words_np, dev)
        _, succ = pm.pmwcas_apply(w, *[pm.words_to_tensor(a, dev)
                                       for a in (addr, exp, des)])
        succ = succ.cpu().numpy()
        seq_words, seq = ref.sequential_oracle(words_np, addr, exp, des)
        check((~succ | seq).all(), "kernel success outside the oracle's")
        new = pm.tensor_to_words(w)
        for i in np.flatnonzero(succ):
            for a in addr[i][addr[i] >= 0]:
                check(new[a] == seq_words[a], "winner write differs from "
                      "the sequential oracle")
    log("phase 2: sequential_oracle containment holds")
    return worst


def small_service_matches_cpu(svc_mod, st, seed: int, dev) -> None:
    """The service on the card against the service on the CPU (the plain
    version) on the same small seeded workload: same verdicts, same
    final tables."""
    spec = st.WorkloadSpec(n_ops=512, n_keys=200, read=0.5, update=0.5,
                           insert=0.0, delete=0.0, alpha=0.99, seed=seed)
    outs = []
    for device in (dev, "cpu"):
        svc = svc_mod.KVService(4, n_buckets=128, round_cap=16,
                                device=device)
        futs = svc.submit_many(st.load_phase(spec, 1.0))
        for c, stream in enumerate(st.client_streams(spec, N_CLIENTS)):
            futs += [svc.submit(op, client=c) for op in stream]
        svc.drain()
        outs.append(([(f.status, f.result.value, f.done_step) for f in futs],
                     [b.values().tolist() for b in svc.backends]))
    check(outs[0] == outs[1], "service on the card != service on the CPU")
    log("phase 2: small KVService on the card == on the CPU")


# ---------------------------------------------------------------------------
# phase 3: the slice at full size
# ---------------------------------------------------------------------------

def _arrivals(streams):
    """Per-client streams interleaved round-robin into one arrival order."""
    return [(c, s[i]) for i in range(max(map(len, streams)))
            for c, s in enumerate(streams) if i < len(s)]


def drive(svc, arrivals, window: int, on_step=None):
    """Bounded-window clients: about ``window`` submissions per wave, then
    drain.  Returns the futures in submission order."""
    futs = []
    for start in range(0, len(arrivals), window):
        futs += [svc.submit(op, client=c)
                 for c, op in arrivals[start:start + window]]
        svc.step()
        if on_step:
            on_step()
    while svc.pending_count:
        svc.step()
        if on_step:
            on_step()
    return futs


def acked_state(st, state, futures):
    """Apply every acknowledged insert/update/delete of one measurement
    window to ``state`` in decision order (deciding wave, then submission
    order); windows are replayed in the order they ran, because
    ``reset_stats`` restarts the wave count."""
    for f in sorted(futures, key=lambda f: (f.done_step, f.seq)):
        if f.status != st.OK:
            continue
        if f.op.kind in (st.INSERT, st.UPDATE):
            state[f.op.key] = f.op.value
        elif f.op.kind == st.DELETE:
            state.pop(f.op.key, None)
    return state


class WaveSplit:
    """Per-wave host time by phase, read from the span tracer after each
    wave (the buffer is cleared every wave, so it never drops)."""
    NAMES = ("wave.snapshot", "wave.compile", "wave.schedule",
             "wave.dispatch", "wave.complete", "service.wave")

    def __init__(self, tracer):
        self.tracer = tracer
        self.total_us = dict.fromkeys(self.NAMES, 0.0)
        self.waves = 0

    def __call__(self):
        for ev in self.tracer.events():
            if ev["ph"] == "X" and ev["name"] in self.total_us:
                self.total_us[ev["name"]] += ev["dur"]
        self.tracer.clear()
        self.waves += 1

    def per_wave_us(self):
        t = {k: v / max(self.waves, 1) for k, v in self.total_us.items()}
        return {"snapshot": t["wave.snapshot"],
                "compile": t["wave.compile"] - t["wave.snapshot"],
                "schedule": t["wave.schedule"],
                "dispatch": t["wave.dispatch"],
                "complete": t["wave.complete"],
                "wave": t["service.wave"]}


def _table_storage(svc) -> int:
    """The address of the one ``[S, W]`` storage whose rows are the
    shards' word tables (checked), as the stacked dispatch binds them."""
    tables = [b.word_table() for b in svc.backends]
    base = tables[0].untyped_storage().data_ptr()
    for i, t in enumerate(tables):
        check(t.untyped_storage().data_ptr() == base
              and t.data_ptr() == base + i * t.numel() * 4,
              f"shard {i}'s table is not row {i} of one [S, W] tensor")
    return base


DISPATCH_OPS = {"kernel": ("pmwcas_apply",),
                "upload": ("Memcpy HtoD",),
                "verdict": ("Memcpy DtoH (Device -> Pinned)",)}


def wave_device_split(by_name: dict, count: dict, waves: int) -> dict:
    """Device µs per wave by op name over a profiled window of ``waves``
    service waves: the dispatch's own ops (the PMwCAS kernel, the packed
    upload, the verdict copy into pinned memory) and everything else
    (the snapshot's table copies to pageable memory among it)."""
    per = {k: 0.0 for k in (*DISPATCH_OPS, "rest")}
    for name, us in by_name.items():
        key = next((k for k, pats in DISPATCH_OPS.items()
                    if any(p in name for p in pats)), "rest")
        per[key] += us / max(waves, 1)
    per["dispatch"] = sum(per[k] for k in DISPATCH_OPS)
    log(f"phase 4: device us per wave over {waves} profiled waves "
        "(profiler, by op name): " + json.dumps(
            {k: round(v, 3) for k, v in per.items()}))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"phase 4:   {us / max(waves, 1):12.3f} us/wave  "
            f"{count[name] / max(waves, 1):6.2f}/wave  {name[:90]}")
    return per


def full_slice(pm, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = RECORDS, ops: int = OPS):
    n_buckets = 2 * records // N_SHARDS
    window = ROUND_CAP * N_SHARDS
    spec = st.WorkloadSpec(n_ops=ops, n_keys=records, read=0.5,
                           update=0.5, insert=0.0, delete=0.0, alpha=0.99,
                           seed=seed)
    svc = svc_mod.KVService(N_SHARDS, structure="hashmap",
                            n_buckets=n_buckets, round_cap=ROUND_CAP,
                            device=dev)
    check(all(b.word_table().device.type == dev.type and b.n_words == 2 * n_buckets
              for b in svc.backends), "word tables are not on the card")
    log(f"phase 3: KVService(n_shards={N_SHARDS}, round_cap={ROUND_CAP}, "
        f"n_buckets={n_buckets}) -> {N_SHARDS} x {2 * n_buckets} words "
        f"({N_SHARDS * 2 * n_buckets * 4 / 2**20:.0f} MiB) on the card")

    t0 = time.perf_counter()
    load = st.load_phase(spec, fraction=1.0)
    load_futs = drive(svc, [(0, op) for op in load], window)
    _sync(dev)
    load_s = time.perf_counter() - t0
    check(all(f.status == st.OK for f in load_futs), "a load insert failed")
    log(f"phase 3: loaded {len(load)} records in {load_s:.3f} s "
        f"({svc.stats.steps} waves)")

    arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
    svc.reset_stats()
    # percentiles over every op of the run, not the default recent window
    svc.stats.latency_us.window = len(arrivals)
    table = _table_storage(svc)
    kernel.reset_counts()                     # count the main path only
    t0 = time.perf_counter()
    run_futs = drive(svc, arrivals, window)
    _sync(dev)
    run_s = time.perf_counter() - t0
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    stats = svc.stats
    dispatch = stats.dispatch
    log(f"phase 3: YCSB-A {len(arrivals)} ops from {N_CLIENTS} clients in "
        f"{run_s:.3f} s: {len(arrivals) / run_s:.1f} ops/s, "
        f"{stats.steps} waves, p50 {stats.p50_latency_us:.1f} us, "
        f"p99 {stats.p99_latency_us:.1f} us")
    log("phase 3: stats " + json.dumps(stats.as_row()))

    check(all(f.done for f in run_futs), "a future is still pending")
    check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "ops exhausted")
    check(stats.conflict_rate == 0.0,
          f"conflict_rate {stats.conflict_rate} != 0")
    items = svc.check_integrity()
    check(items == svc.items(), "check_integrity disagrees with items()")
    check(items == acked_state(st, acked_state(st, {}, load_futs),
                               run_futs),
          "acknowledged writes do not read back")
    check(len(items) == records, f"{len(items)} live keys != {records}")
    check(launches > 0 and launches == dispatch.dispatches
          + dispatch.serial_rounds,
          f"kernel launches {launches} != dispatches {dispatch.dispatches}"
          f" + serial rounds {dispatch.serial_rounds}")
    check(routes == {"smem": launches, "global": 0},
          f"PMwCAS routes {routes}: every wave must take the smem route")
    check(_table_storage(svc) == table,
          "the shard tables moved off their persistent [S, W] tensor")
    log("phase 3: integrity ok, acknowledged writes read back, "
        "conflict_rate 0; every wave one smem launch on the shards' "
        "persistent [S, W] table")
    log("kernels: " + json.dumps({"pmwcas_apply": launches,
                                  "pmwcas_apply routes": routes}))

    # a second, traced window on the loaded map for the per-wave split
    split = WaveSplit(obs.get_tracer())
    obs.enable_tracing()
    try:
        traced = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        t0 = time.perf_counter()
        drive(svc, traced, window, on_step=split)
        traced_s = time.perf_counter() - t0
    finally:
        obs.disable_tracing()
        obs.get_tracer().clear()
    per_wave = split.per_wave_us()
    profiled = _arrivals(st.client_streams(
        dataclasses.replace(spec, n_ops=ops // 8, seed=seed + 2),
        N_CLIENTS))
    waves0 = svc.stats.steps
    by_name, count, wall_us = _profile(lambda: drive(svc, profiled,
                                                     window))
    waves = svc.stats.steps - waves0
    busy_us = sum(by_name.values()) or None
    log("phase 4: device busy " + ("not measured" if busy_us is None else
        f"{busy_us:.1f} us of {wall_us:.1f} us wall over {len(profiled)} "
        f"ops: idle share {1 - busy_us / wall_us:.4f} (profiler)"))
    wave_split = wave_device_split(by_name, count, waves)
    log(f"phase 4: per-wave host split over {split.waves} traced waves "
        f"({len(traced)} ops, {traced_s:.3f} s, tracing on), us/wave: "
        + json.dumps({k: round(v, 1) for k, v in per_wave.items()}))
    check(_table_storage(svc) == table, "the shard tables moved")
    svc.check_integrity()
    return dict(launches=launches, routes=routes,
                ops_per_s=len(arrivals) / run_s, load_s=load_s, run_s=run_s,
                stats=stats, svc=svc, wave_split=wave_split)


# ---------------------------------------------------------------------------
# phase 4: kernel timings at the slice's shape
# ---------------------------------------------------------------------------

def _event_ms(fn, iters: int) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn):
    """One call of ``fn`` under the profiler, from the CUDA activity
    trace: (device µs of every kernel, copy and fill it enqueued, by name;
    how many of each the trace shows; host wall µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            count[e.name] = count.get(e.name, 0) + 1
    return by_name, count, wall_us


def _device_us(fn, iters: int = 1):
    """Device time (µs) of ``iters`` calls of ``fn`` and their host wall
    time (µs); the device time is None when the trace shows none."""
    by_name, _, wall_us = _profile(lambda: [fn() for _ in range(iters)])
    busy = sum(by_name.values())
    return (busy if busy > 0 else None), wall_us


def _per_launch_us(fn, iters: int, match: str):
    """Device µs per launch of the kernels whose name holds ``match``,
    over ``iters`` calls of ``fn`` under the profiler (the mean over the
    launches the trace shows), and how many it shows; None if none."""
    by_name, count, _ = _profile(lambda: [fn() for _ in range(iters)])
    us = sum(v for k, v in by_name.items() if match in k)
    n = sum(v for k, v in count.items() if match in k)
    return (us / n if n else None), n


def kernel_timings(pm, ref, kernel, svc, seed: int, dev):
    """Kernel (both routes) and plain version per launch on an update
    wave of the slice's shape: 4 shards x 1024 rows x 2 slots against the
    loaded 4 x 1,048,576-word tables (each row a live bucket's key guard
    + value word, expected == current, desired == expected so every
    launch does the same full work); and the latency floor, an empty
    launch plus three dependent 4-byte loads."""
    rng = np.random.default_rng(seed + 7)
    words = torch.stack([b.word_table() for b in svc.backends]).clone()
    S, W = words.shape
    host = pm.tensor_to_words(words)
    addr = np.empty((S, ROUND_CAP, 2), np.int32)
    for s in range(S):
        live = np.flatnonzero(host[s, 0::2] != 0)
        buckets = rng.choice(live, ROUND_CAP, replace=False)
        addr[s, :, 0] = 2 * buckets
        addr[s, :, 1] = 2 * buckets + 1
    exp = np.take_along_axis(host, addr.reshape(S, -1), 1).reshape(addr.shape)
    a, e = (pm.words_to_tensor(x, dev) for x in (addr, exp))
    d = e.clone()
    claim = kernel.claim_scratch(words)
    success = torch.empty((S, ROUND_CAP), dtype=torch.bool, device=dev)
    w_k, w_p = words.clone(), words.clone()
    check(kernel.plan(ROUND_CAP, 2)[0] == "smem", "the wave's plan")
    _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
    for route in kernel.ROUTES:
        s_k = kernel.pmwcas_apply_cuda(w_k, a, e, d, route=route,
                                       claim=claim)
        torch.cuda.synchronize()
        check(bool(s_k.all()) and torch.equal(s_k, s_p)
              and torch.equal(w_k, w_p),
              f"timing inputs: kernel != plain on the {route} route")

    def run(route):
        return lambda: kernel.launch(w_k, a, e, d, success, route=route,
                                     claim=claim)

    def run_plain():
        ref.pmwcas_apply_stacked(w_p, a, e, d)

    # stream time of back-to-back calls (CUDA events), in turns
    plain_ms, smem_ms, global_ms, smem_ms2, global_ms2, plain_ms2 = (
        _event_ms(run_plain, 20), _event_ms(run("smem"), 500),
        _event_ms(run("global"), 500), _event_ms(run("smem"), 500),
        _event_ms(run("global"), 500), _event_ms(run_plain, 20))
    wrapper_ms = _event_ms(lambda: pm.pmwcas_apply_stacked(w_k, a, e, d),
                           200)
    # device time per launch (profiler): what the card itself spends; the
    # host's ctypes call would dominate the kernel's event time
    turns = [(r, _per_launch_us(run(r), 200, "pmwcas_apply")[0])
             for r in ("smem", "global", "global", "smem")]
    p_dev, _ = _device_us(run_plain, 20)
    # the latency floor: one thread, an empty launch, then three
    # dependent 4-byte loads through a random chain in a table's size
    chain = torch.randint(0, W, (W,), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev
                                                    ).manual_seed(seed))
    out = torch.empty(1, dtype=torch.int32, device=dev)
    probe = {t: _per_launch_us(
        lambda t=t: kernel.latency_probe(chain, out, t), 200, "latency")[0]
        for t in (0, 3)}
    smem_us = [u for r, u in turns if r == "smem" and u]
    global_us = [u for r, u in turns if r == "global" and u]
    ms = min(smem_us) / 1e3 if smem_us else min(smem_ms, smem_ms2)
    g_ms = min(global_us) / 1e3 if global_us else min(global_ms, global_ms2)
    plain = p_dev / 20 / 1e3 if p_dev else min(plain_ms, plain_ms2)
    src = "profiler device time" if smem_us and global_us and p_dev \
        else "CUDA events"
    floor_ms = probe[3] / 1e3 if probe[3] else None
    valid = int((addr >= 0).sum())
    winners = int((np.asarray(s_k.cpu())[..., None] & (addr >= 0)).sum())
    n_bytes = 3 * addr.size * 4 + valid * 4 + winners * 4 + S * ROUND_CAP
    bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
    log(f"phase 4: [S, B, K] = [{S}, {ROUND_CAP}, 2], W = {W}: smem route "
        f"{ms * 1e3:.3f} us/launch, global route {g_ms * 1e3:.3f} "
        f"us/launch, plain {plain * 1e3:.3f} us/call ({src}; per launch "
        f"in two profiled runs of 200, taken in turns: smem "
        f"{[round(x, 3) for x in smem_us]}, global "
        f"{[round(x, 3) for x in global_us]}); stream time back to back "
        f"(CUDA events): smem {smem_ms * 1e3:.2f} / {smem_ms2 * 1e3:.2f} "
        f"us, global {global_ms * 1e3:.2f} / {global_ms2 * 1e3:.2f} us, "
        f"checked wrapper {wrapper_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} / {plain_ms2 * 1e3:.2f} us; bound "
        f"{bound_ms * 1e3:.4f} us ({n_bytes} bytes at "
        f"{H100_BYTES_PER_S:.3g} B/s); latency floor (profiler, one "
        f"thread): empty launch "
        + ("not measured" if probe[0] is None else f"{probe[0]:.3f} us")
        + ", plus three dependent 4-byte loads "
        + ("not measured" if probe[3] is None else f"{probe[3]:.3f} us"))
    return dict(ms=ms, global_ms=g_ms, plain_ms=plain, bound_ms=bound_ms,
                floor_ms=floor_ms,
                empty_ms=probe[0] / 1e3 if probe[0] else None)


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain
# ---------------------------------------------------------------------------

class FACase(NamedTuple):
    """One flash check: the flat shapes ``q [B*KV*G, Sq, hd]``, ``k/v
    [B*KV, Sk, hd]``, the mask options, and the bf16 route :func:`plan`
    must take (f32 takes ``decode`` at ``G * Sq <= 16``, else ``simt``).
    ``empty`` moves row 0 before every key; ``q_at`` puts the first q row
    at that position; ``splits`` forces the decode route's split count."""
    name: str
    B: int
    KV: int
    G: int
    Sq: int
    Sk: int
    hd: int
    causal: bool
    window: int
    cap: float
    route: str
    empty: bool = False
    q_at: Optional[float] = None
    splits: Optional[int] = None


FA_CHECK_CASES = [
    # the FA_CASES of tests/test_kernels.py:28-38, then the slice's shapes
    FACase("fa_case0", 1, 1, 1, 16, 16, 8, True, 0, 0.0, "decode"),
    FACase("fa_case1", 2, 2, 2, 32, 32, 16, True, 0, 0.0, "simt"),
    FACase("fa_gqa_ragged", 1, 2, 4, 24, 40, 8, True, 0, 0.0, "simt"),
    FACase("fa_cross", 1, 1, 1, 16, 48, 8, False, 0, 0.0, "decode"),
    FACase("fa_window", 2, 1, 2, 32, 32, 8, True, 9, 0.0, "simt"),
    FACase("fa_softcap", 1, 2, 1, 32, 32, 8, True, 0, 30.0, "simt"),
    FACase("fa_bf16", 1, 1, 2, 16, 16, 8, True, 0, 0.0, "simt"),
    FACase("fa_decode", 1, 1, 1, 1, 40, 8, True, 0, 0.0, "decode"),
    FACase("llama3", 1, 8, 4, 128, 200, 128, True, 0, 0.0, "tc"),
    FACase("gemma2", 1, 2, 2, 96, 96, 256, True, 32, 50.0, "tc"),
    FACase("decode_long", 2, 8, 4, 1, 2080, 128, True, 0, 0.0, "decode"),
    FACase("ragged", 1, 2, 2, 70, 135, 64, True, 0, 0.0, "tc"),
    FACase("no_visible", 1, 2, 2, 8, 24, 8, True, 0, 0.0, "decode", True),
    # the tensor-core route's edges: a 128-row tile mixing the heads of a
    # group (4 x 70 rows), hd 256 with window and softcap, Sk not a
    # multiple of the key tile, a row with no visible key
    FACase("tc_mixed_heads", 1, 2, 4, 70, 150, 128, True, 0, 0.0, "tc"),
    FACase("tc_hd256_window_cap", 1, 2, 2, 100, 100, 256, True, 32, 50.0,
           "tc"),
    FACase("tc_hd64_ragged_sk", 2, 1, 2, 80, 200, 64, True, 0, 0.0, "tc"),
    FACase("tc_no_visible", 1, 2, 4, 40, 72, 128, True, 0, 0.0, "tc", True),
    # the decode route's: the row mid-cache (the tail splits see nothing),
    # and forced split counts
    FACase("decode_mid_cache", 2, 8, 4, 1, 2080, 128, True, 0, 0.0,
           "decode", q_at=1500.0),
    *(FACase(f"decode_splits{n}", 1, 2, 4, 1, 2080, 128, True, 0, 0.0,
             "decode", q_at=1500.0, splits=n) for n in (1, 2, 9, 33)),
    # a row that sees no key, split and whole; hd 256 with window and cap
    FACase("decode_no_visible", 1, 2, 4, 1, 300, 128, True, 0, 0.0,
           "decode", True),
    FACase("decode_no_visible_1split", 1, 2, 4, 1, 300, 128, True, 0, 0.0,
           "decode", True, splits=1),
    FACase("decode_hd256_window_cap", 1, 2, 2, 1, 500, 256, True, 32, 50.0,
           "decode"),
    # rings that wrap: 1000 keys through the tc K/V ring (3 x 128 keys at
    # hd 64 and 128, 2 x 64 at hd 256), late rows seeing them all or no
    # mask at all; 2080 keys through the decode mma ring (3 x 64 keys at
    # hd 64, 2 x 64 at hd 256) at one split, two and the plan's count
    FACase("tc_hd64_wrap", 1, 2, 2, 64, 1000, 64, True, 0, 0.0, "tc",
           q_at=936.0),
    FACase("tc_hd128_wrap", 1, 2, 4, 40, 1000, 128, False, 0, 0.0, "tc"),
    FACase("tc_hd256_wrap", 1, 2, 2, 64, 1000, 256, True, 0, 0.0, "tc",
           q_at=936.0),
    *(FACase(f"decode_hd{hd}_wrap" + (f"_splits{n}" if n else ""), 1, 2,
             4, 1, 2080, hd, True, 0, 0.0, "decode", splits=n)
      for hd in (64, 256) for n in (1, 2, None)),
]
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 is also held per row: the largest ||got_r - want_r|| / ||want_r||
# over the output rows.  Where outputs are ~0.04 (a row that sees ~2,000
# keys), the element-wise 2e-2 passes a kernel that skips a 64-key tile
# (~5e-3 a value); per row that fault reads >= 0.1, a sound kernel
# ~3e-3 to 6e-3 (bf16 output rounding, p rounded to bf16 for P.V).
# Readings: PERF.md section 6; flash_timings plants the faults at the
# serve cell's shapes on every run and checks they exceed the limit.
FA_ROW_TOL = 2e-2


def fa_route(case: FACase, dtype) -> str:
    """The route the plan must give ``case`` in ``dtype``."""
    if dtype == torch.bfloat16 or case.G * case.Sq <= 16:
        return case.route
    return "simt"


def fa_case_inputs(case: FACase, dtype, dev, seed: int = 0):
    """Seeded flat inputs of one case: ``(q, k, v, q_pos, k_pos)`` and the
    keywords.  Positions as in tests/test_kernels.py (a decode row sits at
    the last key unless ``q_at`` moves it); ``empty`` moves row 0 before
    every key."""
    rng = np.random.default_rng(seed)
    B, KV, G, Sq, Sk, hd = (case.B, case.KV, case.G, case.Sq, case.Sk,
                            case.hd)
    q = rng.standard_normal((B * KV * G, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B * KV, Sk, hd), dtype=np.float32)
    v = rng.standard_normal((B * KV, Sk, hd), dtype=np.float32)
    qp = np.arange(Sq, dtype=np.float32) + (
        Sk - Sq if case.causal and Sq == 1 else 0)
    if case.q_at is not None:
        qp = np.arange(Sq, dtype=np.float32) + case.q_at
    if case.empty:
        qp[0] = -1.0
    kp = np.arange(Sk, dtype=np.float32)

    def t(a):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    args = (t(q), t(k), t(v), torch.from_numpy(qp).to(dev),
            torch.from_numpy(kp).to(dev))
    return args, dict(g=G, scale=1.0 / np.sqrt(hd), causal=case.causal,
                      window=case.window, attn_cap=case.cap)


def fa_run(fa_ops, fa_kernel, case: FACase, args, kw):
    """The flash op on ``args``; a case that forces the decode split
    count calls the kernel's wrapper with it (CUDA tensors only)."""
    if case.splits is not None and args[0].is_cuda:
        return fa_kernel.flash_attention_cuda(*args, **kw,
                                              splits=case.splits)
    return fa_ops.flash_attention_flat(*args, **kw)


def fa_row_err(got, want) -> float:
    """The largest ``||got_r - want_r|| / ||want_r||`` over the rows (the
    last axis) of two outputs."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def fa_close(got, want, dtype):
    """``|got - want| <= tol + tol * |want|`` (numpy's allclose with rtol =
    atol = tol), every value finite, and in bf16 also ``fa_row_err <=
    FA_ROW_TOL``; returns the max abs difference."""
    tol = FA_TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol + tol * w.abs()).all())
    if dtype == torch.bfloat16:
        ok = ok and fa_row_err(g, w) <= FA_ROW_TOL
    return ok, float(diff.max())


def fa_kernel_vs_plain(fa_ops, fa_ref, fa_kernel, seed: int, dev) -> float:
    """The flash op (the kernel on ``dev``) against its plain version on
    the same inputs, every case in f32 and bf16; on the card each call
    must take the case's route.  Returns the largest absolute
    difference."""
    worst = worst_row = 0.0
    for case in FA_CHECK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = fa_case_inputs(case, dtype, dev, seed)
            before = dict(fa_kernel.flash_attention_cuda.route_launches)
            got = fa_run(fa_ops, fa_kernel, case, args, kw)
            want = fa_ref.flash_attention_flat(*args, **kw)
            _sync(dev)
            if dev.type == "cuda":
                after = fa_kernel.flash_attention_cuda.route_launches
                took = [r for r in after if after[r] != before[r]]
                check(took == [fa_route(case, dtype)],
                      f"flash {case.name} {dtype} took {took}, not "
                      f"{fa_route(case, dtype)}")
            ok, err = fa_close(got, want, dtype)
            check(got.dtype == dtype and got.shape == args[0].shape,
                  f"flash {case.name} {dtype}: dtype/shape")
            row = fa_row_err(got, want)
            check(ok, f"flash kernel != plain at {case.name} {dtype}: max "
                  f"abs err {err}, row err {row}")
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                worst_row = max(worst_row, row)
    log(f"phase 2: flash kernel == plain on {len(FA_CHECK_CASES)} cases x "
        f"{{f32, bf16}} (tol 2e-5 / 2e-2, bf16 rows {FA_ROW_TOL}), each on "
        f"its route, max abs err {worst:.3e}, bf16 max row err "
        f"{worst_row:.3e}")
    return worst


def serve_logits_agree(card, cpu, tol: float, rtol: float) -> tuple:
    """Two serves' kept logits, step by step: within ``atol = tol`` and
    ``rtol`` at every step, and the same tokens up to the first step
    whose top-2 gap is within ``tol`` (a near-tie may pick either token;
    the runs part there).  Raises :class:`SmokeFailure` where they differ;
    returns ``(max abs diff, steps compared)``."""
    worst = 0.0
    for step, (lk, lc) in enumerate(zip(card.logits, cpu.logits)):
        lk, lc = lk.float().numpy(), lc.float().numpy()
        worst = max(worst, float(np.abs(lk - lc).max()))
        check(np.allclose(lk, lc, rtol=rtol, atol=tol),
              f"step {step}: card logits differ from the CPU's by "
              f"{np.abs(lk - lc).max():.3e}")
        if step == len(card.logits) - 1:
            break
        same = card.generated[:, step] == cpu.generated[:, step]
        top2 = np.sort(lc, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        check(same[clear].all(), f"step {step}: a token differs where the "
              f"top-2 gap exceeds {tol}")
        if not same.all():
            log(f"phase 2: near-tie at step {step}; compared up to there")
            break
    return worst, step + 1


def small_serve_config(get_config, dtype: str, head_dim: int = 0):
    """The llama3-8b smoke config in ``dtype`` with attn_impl "pallas",
    its head_dim set to ``head_dim`` when given."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              dtype=dtype, attn_impl="pallas")
    return dataclasses.replace(cfg, head_dim=head_dim) if head_dim else cfg


def small_serve_kwargs(seed: int) -> dict:
    """The small serve's traffic: 16 requests of 16 prompt tokens, 8
    decode steps, 64 pages of 16 tokens, logits kept."""
    return dict(requests=16, steps=8, prompt_len=16, page_size=16,
                n_pages=64, seed=seed, keep_logits=True)


def small_serve_matches_cpu(serve_mod, build_model, get_config, seed: int,
                            dev, dtype: str = "float32", head_dim: int = 0,
                            tol: float = 1e-3, rtol: Optional[float] = None):
    """A small serve (:func:`small_serve_config`, the same weights on both
    devices) on the card against the CPU: the same admitted set, and
    logits and tokens as :func:`serve_logits_agree` checks them (``rtol``
    defaults to ``tol``).  In f32 the tolerance 1e-3 covers sums taken in
    another order and the bf16 KV cache, which turns a last-bit
    difference into one bf16 ulp.  Returns the flash calls the card run
    made, by route."""
    import copy
    cfg = small_serve_config(get_config, dtype, head_dim)
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(dev)
    kw = small_serve_kwargs(seed)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    before = dict(fa_kernel.flash_attention_cuda.route_launches)
    card = serve_mod.serve(cfg, device=dev, model=card_model, **kw)
    routes = {r: n - before[r] for r, n in
              fa_kernel.flash_attention_cuda.route_launches.items()}
    cpu = serve_mod.serve(cfg, device="cpu", model=cpu_model, **kw)
    check(np.array_equal(card.admitted, cpu.admitted),
          "card and CPU admitted different requests")
    check(card.logits_finite and cpu.logits_finite, "non-finite logits")
    rtol = tol if rtol is None else rtol
    worst, steps = serve_logits_agree(card, cpu, tol, rtol)
    log(f"phase 2: small serve (llama3-8b smoke, {dtype}, head_dim "
        f"{cfg.resolved_head_dim}) on the card == on the CPU: "
        f"{len(card.admitted)} admitted, logits within atol {tol} rtol "
        f"{rtol} over {steps} steps (max abs diff {worst:.3e}), flash "
        f"calls by route {json.dumps(routes)}")
    return routes


# bf16 small serve, card against CPU: bf16 keeps 8 significant bits and the
# two runs round at other places (the tensor-core routes round p to bf16,
# the CPU's plain version keeps it in f32; the products accumulate in
# another order), so logits of magnitude <= 4.6 differ by a few bf16 ulps.
# The limit is absolute (rtol 0), between the readings in PERF.md section
# 6: a sound card run, and faults planted in the CPU's flash op
# (tests/test_torch_flash_faults.py, which checks each one fails it).
SERVE_BF16_TOL = 0.15
SERVE_BF16_HEAD_DIM = 128


def small_serve_bf16(serve_mod, build_model, get_config, seed: int, dev):
    """The bf16 small serve at head_dim 128, card against CPU: on the card
    the prefill takes the tensor-core route and every decode step the
    decode route (prompt 16 x 4 heads = 64 rows per kv head; 8 steps)."""
    routes = small_serve_matches_cpu(
        serve_mod, build_model, get_config, seed, dev, dtype="bfloat16",
        head_dim=SERVE_BF16_HEAD_DIM, tol=SERVE_BF16_TOL, rtol=0.0)
    n_layers = get_config("llama3-8b", smoke=True).n_layers
    if dev.type == "cuda":
        check(routes == dict(tc=n_layers, decode=n_layers * 8, simt=0),
              f"bf16 small serve flash routes {routes}")
    return routes


# ---------------------------------------------------------------------------
# phase 5: the LM serve slice at full width
# ---------------------------------------------------------------------------

LM_REQUESTS, LM_STEPS, LM_PROMPT = 128, 32, 2048
LM_PAGE, LM_PAGES = 256, 1024


def lm_slice(serve_mod, build_model, get_config, pm_ref, fa_kernel,
             pm_kernel, seed: int, dev):
    """llama3-8b at full width and depth, random bf16 weights from a seeded
    generator on the card, served through ``serve``: admission by the
    PMwCAS kernel, attention by the flash kernel."""
    cfg = dataclasses.replace(get_config("llama3-8b"), attn_impl="pallas")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    _sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params - norms == cfg.n_params, f"{n_params} parameters")
    log(f"phase 5: llama3-8b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}): {cfg.n_params} weights + {norms} norm weights, "
        f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.3f} s")

    # the plain reserve_slots on the same proposals
    pages_per_req = -(-(LM_PROMPT + LM_STEPS) // LM_PAGE)
    proposals = serve_mod.propose_pages(LM_REQUESTS, pages_per_req, LM_PAGES,
                                        np.random.default_rng(seed))
    r = torch.as_tensor(proposals, device=dev)
    _, want = pm_ref.pmwcas_apply(torch.ones(LM_PAGES, dtype=torch.int32,
                                             device=dev), r,
                                  torch.ones_like(r), torch.zeros_like(r))

    fa_kernel.reset_counts()                        # count this path only
    pm_kernel.reset_counts()
    res = serve_mod.serve(cfg, requests=LM_REQUESTS, steps=LM_STEPS,
                          prompt_len=LM_PROMPT, page_size=LM_PAGE,
                          n_pages=LM_PAGES, device=dev, seed=seed,
                          model=model)
    fa_launches = fa_kernel.flash_attention_cuda.launches
    fa_routes = dict(fa_kernel.flash_attention_cuda.route_launches)
    pm_launches = pm_kernel.pmwcas_apply_cuda.launches
    pm_routes = dict(pm_kernel.pmwcas_apply_cuda.route_launches)
    B = len(res.admitted)
    log(f"phase 5: admitted {B}/{LM_REQUESTS} requests ({pages_per_req} "
        f"pages each of {LM_PAGE} tokens, {LM_PAGES} pages)")
    check(np.array_equal(res.granted, want.cpu().numpy()),
          "admission != the plain reserve_slots on the same proposals")
    check(B >= 8, f"only {B} requests admitted")
    check(res.logits_finite, "non-finite logits")
    check(res.generated.shape == (B, LM_STEPS)
          and (res.generated >= 0).all()
          and (res.generated < cfg.vocab).all(), "generated tokens")
    want_fa = cfg.n_layers * (1 + LM_STEPS)
    check(fa_launches == want_fa,
          f"flash launches {fa_launches} != {cfg.n_layers} x (1 + "
          f"{LM_STEPS}) = {want_fa}")
    want_routes = dict(tc=cfg.n_layers, decode=cfg.n_layers * LM_STEPS,
                       simt=0)
    check(fa_routes == want_routes, f"flash routes {fa_routes} != "
          f"{want_routes} (tc at every prefill, decode at every step)")
    check(pm_launches == 1 and pm_routes == {"smem": 1, "global": 0},
          f"page-grant launches {pm_launches} by route {pm_routes} != 1 "
          "on the smem route")
    kv_bytes = 2 * cfg.n_layers * B * cfg.n_kv_heads * (
        LM_PROMPT + LM_STEPS) * cfg.resolved_head_dim * 2
    t = res.timings
    log(f"phase 5: KV cache bf16 {kv_bytes / 1e9:.2f} GB; prefill of "
        f"{B} x {LM_PROMPT} tokens {t['prefill_s']:.3f} s; decode "
        f"{t['decode_ms_per_step']:.3f} ms/step over {LM_STEPS} steps "
        f"({t['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{t['tokens_per_s']:.1f} generated tokens/s with the prefill); "
        f"launches on this path: flash {fa_launches} (by route "
        f"{json.dumps(fa_routes)}), pmwcas {pm_launches} (by route "
        f"{json.dumps(pm_routes)})")
    return dict(model=model, cfg=cfg, B=B, fa_launches=fa_launches,
                fa_routes=fa_routes, pm_launches=pm_launches,
                pm_routes=pm_routes, timings=t)


def _visible_pairs(qp, kp) -> int:
    """(q row, key) pairs the causal mask leaves visible, for one head."""
    return int(((kp < 2.0 ** 29)[None, :] & (qp[:, None] >= kp[None, :]))
               .sum())


def _clocks() -> str:
    """The card's SM clock, power draw and temperature right now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _sdpa_library(q, k, v, qp, kp, scale: float, B: int):
    """One PyTorch call computing the same function: SDPA with GQA and an
    explicit boolean mask from the positions (timed here, never called by
    the port)."""
    import torch.nn.functional as F
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    ok = (kp < 2.0 ** 29)[None, :] & (qp[:, None] >= kp[None, :])
    q4 = q.view(B, H // B, Sq, hd)
    k4, v4 = k.view(B, HK // B, Sk, hd), v.view(B, HK // B, Sk, hd)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=ok[None, None], scale=scale, enable_gqa=True)


def _captured(fn, n: int):
    """A CUDA graph of ``n`` back-to-back calls of ``fn`` and a function
    that replays it once and returns the device time per call (ms, CUDA
    events around the replay), so the host's launch speed drops out.
    ``fn`` is warmed up first on the capture's side stream, so one-time
    work (``cudaFuncSetAttribute``, the allocator's first blocks) happens
    outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    replay.graph = graph               # keeps the graph alive with replay
    return replay


def _graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: the mean over ``replays`` replays
    of :func:`_captured`'s graph of ``n`` calls."""
    replay = _captured(fn, n)
    return sum(replay() for _ in range(replays)) / replays


def _interleaved_ms(fns: dict, n: int, rounds: int) -> dict:
    """Device time per call of each of ``fns`` (name -> function) from
    :func:`_captured` graphs of ``n`` calls, replayed in turns for
    ``rounds`` rounds, so that drift of the card's clocks between calls
    falls on all alike.  Returns name -> the per-round times (ms)."""
    replays = {name: _captured(fn, n) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, replay in replays.items():
            times[name].append(replay())
    return times


def route_tile(route: str, hd: int) -> tuple:
    """``(keys a tile, K/V ring depth)`` of a bf16 call's kernel on
    ``route`` at head_dim ``hd``: ``flash_attention_tc.cu`` (tc) or the
    mma kernel of ``flash_attention_decode.cu`` (decode)."""
    if route == "tc":
        return (128, 3) if hd <= 128 else (64, 2)
    return 64, (3 if hd <= 128 else 2)


def fa_fault_errs(fa_ref, args, kw, want, tile: int, stages: int) -> dict:
    """:func:`fa_row_err` of outputs that a kernel with a planted fault
    would give, against the plain version's ``want``: the plain version
    on inputs changed the way each fault changes what the kernel reads.
    ``tile`` is the route's keys a tile, ``stages`` its K/V ring depth;
    the keys must span more than ``stages`` tiles.  ``drop``: a middle
    key tile (at least the ring's second lap) skipped; ``stale``: that
    tile's K and V served from its ring slot's previous tile (``stages``
    tiles back); ``last``: the tile holding the last row's own key
    skipped."""
    q, k, v, qp, kp = args
    j = max(stages, k.shape[1] // tile // 2)
    mid = slice(j * tile, (j + 1) * tile)
    old = slice((j - stages) * tile, (j - stages + 1) * tile)
    last = int(qp.max()) // tile * tile

    def masked(keys):
        kpf = kp.clone()
        kpf[keys] = 2.0 ** 30
        return kpf

    ks, vs = k.clone(), v.clone()
    ks[:, mid], vs[:, mid] = k[:, old], v[:, old]
    runs = {"drop": (k, v, masked(mid)), "stale": (ks, vs, kp),
            "last": (k, v, masked(slice(last, last + tile)))}
    return {name: fa_row_err(fa_ref.flash_attention_flat(q, kf, vf, qp, kpf,
                                                         **kw), want)
            for name, (kf, vf, kpf) in runs.items()}


def flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev, seed: int):
    """The flash op at the slice's prefill and decode shapes (one layer,
    random q/k/v from a seed).  Kernel against plain in f32 (2e-5,
    prefill at B = 1; on the ``simt`` route and the decode route's SIMT
    split kernel) and in bf16, the call the serve makes (2e-2, and per
    row ``FA_ROW_TOL``; on the ``tc`` route and the decode route's mma
    kernel).  Faults planted in the plain version's inputs (a key tile
    skipped, a stale ring slot, the last row's own tile skipped; one
    request's heads) must read above ``FA_ROW_TOL`` per row, so the bf16
    check would catch them.  Then the route and split count the plan
    gives the bf16 call, and the time per call of the kernel, the plain
    version and SDPA in bf16 beside the bound: stream time of
    back-to-back calls (CUDA events) at both shapes, and at the decode
    shape also device time from replayed CUDA graphs, the kernel's and
    SDPA's taken in turns over several rounds."""
    cfg, B = lm["cfg"], lm["B"]
    hd = cfg.resolved_head_dim
    Sk = LM_PROMPT + LM_STEPS
    G = cfg.n_heads // cfg.n_kv_heads
    free, _ = torch.cuda.mem_get_info()
    # the plain version holds about four f32 [H, Sq, Sk] score tensors
    per_req = 4 * cfg.n_heads * LM_PROMPT * Sk * 4
    B_cmp = max(1, min(B, int(0.8 * free) // per_req))
    out = {}
    for shape, Sq, Bc in (("prefill", LM_PROMPT, B_cmp), ("decode", 1, B)):
        rng = np.random.default_rng(seed + 11)
        mk = (lambda *s: torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(device=dev))
        q32 = mk(Bc * cfg.n_heads, Sq, hd)
        k32, v32 = (mk(Bc * cfg.n_kv_heads, Sk, hd) for _ in range(2))
        # prefill rows at 0..Sq-1; the decode row at the last cached key
        qp = torch.arange(Sq, device=dev, dtype=torch.float32) + (
            Sk - 1 if Sq == 1 else 0)
        kp = torch.arange(Sk, device=dev, dtype=torch.float32)
        kw = dict(g=G, scale=1.0 / np.sqrt(hd), causal=True, window=0,
                  attn_cap=0.0)
        B32 = 1 if shape == "prefill" else Bc
        f32_args = (q32[:B32 * cfg.n_heads], k32[:B32 * cfg.n_kv_heads],
                    v32[:B32 * cfg.n_kv_heads], qp, kp)
        got = fa_ops.flash_attention_flat(*f32_args, **kw)
        want = fa_ref.flash_attention_flat(*f32_args, **kw)
        torch.cuda.synchronize()
        ok, err32 = fa_close(got, want, torch.float32)
        check(ok, f"flash kernel != plain in f32 at the {shape} shape: "
              f"{err32}")
        rms = float(want.pow(2).mean().sqrt())
        del got, want
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        del q32, k32, v32
        got = fa_ops.flash_attention_flat(q, k, v, qp, kp, **kw)
        want = fa_ref.flash_attention_flat(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        ok, err = fa_close(got, want, torch.bfloat16)
        row = fa_row_err(got, want)
        check(ok, f"flash kernel != plain in bf16 at the {shape} shape: "
              f"max abs err {err}, row err {row}")
        o = torch.empty_like(q)
        HK = k.shape[0]
        route, splits = fa_kernel.plan(q.dtype, hd, G * Sq, Sk, HK,
                                       fa_kernel.n_sms(dev.index or 0))
        tile, stages = route_tile(route, hd)
        nq, nk = cfg.n_heads, cfg.n_kv_heads       # one request's heads
        faults = fa_fault_errs(fa_ref, (q[:nq], k[:nk], v[:nk], qp, kp), kw,
                               want[:nq], tile, stages)
        check(min(faults.values()) > FA_ROW_TOL,
              f"a planted fault at the {shape} shape reads "
              f"{json.dumps(faults)}, within the row limit {FA_ROW_TOL}")
        del want
        ws = (torch.empty(fa_kernel.workspace_floats(HK, splits, G * Sq, hd),
                          dtype=torch.float32, device=dev)
              if route == "decode" and fa_kernel.needs_workspace(
                  q.dtype, hd, splits) else None)

        def run_kernel():
            fa_kernel.launch(q, k, v, qp, kp, o, **kw, workspace=ws)

        def run_plain():
            fa_ref.flash_attention_flat(q, k, v, qp, kp, **kw)

        run_lib = _sdpa_library(q, k, v, qp, kp, kw["scale"], Bc)
        lib_err = float((run_lib().reshape(q.shape).float()
                         - got.float()).abs().max())
        n_k = 20 if shape == "decode" else 5
        n_p = 5 if shape == "decode" else 2
        ms, plain, lib = (_event_ms(run_kernel, n_k),
                          _event_ms(run_plain, n_p), _event_ms(run_lib, n_k))
        pairs = _visible_pairs(qp, kp) * q.shape[0]
        flops = 4 * hd * pairs
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound_ops = flops / H100_BF16_FLOPS * 1e3
        bound_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        by = "operations" if bound_ops >= bound_bytes else "bytes"
        res = dict(B=Bc, route=route, splits=splits, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bound, bound_by=by,
                   err=max(err, err32), row_err=row, faults=faults)
        graphs = ""
        if shape == "decode":
            rounds = _interleaved_ms({"kernel": run_kernel, "sdpa": run_lib},
                                     50, 9)
            kr, lr = rounds["kernel"], rounds["sdpa"]
            res.update(graph_ms=float(np.median(kr)),
                       graph_plain_ms=_graph_ms(run_plain, 20),
                       graph_library_ms=float(np.median(lr)),
                       graph_rounds_ms=kr, graph_library_rounds_ms=lr)
            wins = sum(a < b for a, b in zip(kr, lr))
            graphs = (f"; device time per call (CUDA graphs of 50 back-to-"
                      f"back calls, kernel and SDPA replayed in turns, "
                      f"{len(kr)} rounds: median [min, max]) kernel "
                      f"{res['graph_ms'] * 1e3:.3f} [{min(kr) * 1e3:.3f}, "
                      f"{max(kr) * 1e3:.3f}] us, SDPA "
                      f"{res['graph_library_ms'] * 1e3:.3f} "
                      f"[{min(lr) * 1e3:.3f}, {max(lr) * 1e3:.3f}] us, "
                      f"kernel faster in {wins} of {len(kr)} rounds; plain "
                      f"{res['graph_plain_ms'] * 1e3:.3f} us")
        best = res.get("graph_ms", ms)
        rate = (f"{flops / best / 1e9:.1f} TFLOP/s" if by == "operations"
                else f"{n_bytes / best / 1e9:.4f} TB/s")
        log(f"phase 6: flash at the {shape} shape q [{q.shape[0]}, {Sq}, "
            f"{hd}] x k/v [{HK}, {Sk}, {hd}] bf16 (B = {Bc} of {B}; f32 "
            f"check at B = {B32}): route {route}, splits {splits}; stream "
            f"time per call (CUDA events, back to back) kernel "
            f"{ms * 1e3:.3f} us, plain {plain * 1e3:.3f} us, SDPA "
            f"{lib * 1e3:.3f} us{graphs}; kernel achieves {rate}; clocks, "
            f"power, temperature after the timed runs {_clocks()}; bound "
            f"{bound * 1e3:.3f} us by {by} ({flops} flops over {pairs} "
            f"visible pairs at {H100_BF16_FLOPS:.3g} FLOP/s, {n_bytes} bytes "
            f"at {H100_BYTES_PER_S:.3g} B/s); kernel vs plain: f32 max abs "
            f"err {err32:.3e} (output RMS {rms:.3e}), bf16 max abs err "
            f"{err:.3e}, bf16 max row err {row:.3e} (limit {FA_ROW_TOL}; "
            f"planted faults {tile}-key tile, ring of {stages}: "
            f"{json.dumps({n: round(e, 6) for n, e in faults.items()})}), "
            f"vs SDPA {lib_err:.3e}")
        out[shape] = res
        del q, k, v, o, got, ws
        torch.cuda.empty_cache()
    return out


# kernels the flash op launches, by the names the profiler shows: one of
# the first four per op call (SIMT, tensor-core prefill, the two decode
# split kernels); the combine follows a decode call of more than one split
FLASH_KERNELS = ("flash_attention_kernel", "flash_attention_tc_kernel",
                 "flash_attention_decode_kernel",
                 "flash_attention_decode_mma_kernel")
FLASH_GROUP = FLASH_KERNELS + ("flash_attention_combine_kernel",)


def _device_split(fn):
    """Device time of one call of ``fn`` by kernel (profiler): (busy µs,
    wall µs, {group: µs}, [(kernel name, µs), ...] largest first, flash
    op calls in the trace).  Groups: the flash kernels (every route, the
    decode combine included), matrix products (cuBLAS's gemm/nvjet
    kernels), and everything else (norms, RoPE, casts, copies, argmax)."""
    by_name, count, wall_us = _profile(fn)
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        key = ("flash" if any(f in name for f in FLASH_GROUP) else "matmul"
               if any(w in low for w in ("gemm", "cutlass", "xmma", "cublas",
                                         "nvjet"))
               else "other")
        groups[key] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    flash = sum(n for k, n in count.items()
                if any(f in k for f in FLASH_KERNELS))
    return sum(by_name.values()), wall_us, groups, top, flash


def _log_split(what, flash_made, busy, wall, groups, top, flash_seen):
    if not busy:
        log(f"phase 6: {what}: device time not measured (the profiler saw "
            "no device time)")
        return
    shares = ", ".join(f"{k} {v:.1f} us ({v / busy:.3f})"
                       for k, v in groups.items())
    log(f"phase 6: {what}: device busy {busy:.1f} us of {wall:.1f} us "
        f"wall, idle share {1 - busy / wall:.4f} (profiler); by group: "
        f"{shares}; flash launches in the trace: {flash_seen} of "
        f"{flash_made}")
    for name, us in top[:5]:
        log(f"phase 6:   {us:12.1f} us  {name[:100]}")


def where_time_goes(lm, ft, dev, seed: int, steps: int = 8):
    """One prefill and a window of decode steps at the slice's batch and
    cache length, profiled: device busy share and time by kernel group,
    and the flash kernel's device time per prefill launch inside the
    model beside its time alone (``ft``, from :func:`flash_timings`).
    The prompt is drawn from the seed; the decode tokens are arbitrary
    (the work depends only on the shapes and positions)."""
    model, cfg, B = lm["model"], lm["cfg"], lm["B"]
    rng = np.random.default_rng(seed + 13)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, LM_PROMPT)),
                             device=dev)
    tok = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        cache = model.init_cache(B, LM_PROMPT + LM_STEPS)
        split = _device_split(lambda: model.prefill(prompt, cache))
        _log_split(f"one prefill of {B} x {LM_PROMPT} tokens", cfg.n_layers,
                   *split)
        log(f"phase 6: clocks, power, temperature after it: {_clocks()}")
        if split[0] and split[4] == cfg.n_layers:
            alone = ft["prefill"]
            log(f"phase 6: flash per prefill launch inside the model "
                f"{split[2]['flash'] / cfg.n_layers:.1f} us (profiler) "
                f"at B = {lm['B']} against {alone['ms'] * 1e3:.1f} us alone "
                f"(CUDA events, B = {alone['B']})")

        def window():
            for _ in range(steps):
                model.decode_step(tok, cache)

        window()                                   # warm
        cache["index"] = LM_PROMPT
        _log_split(f"decode window of {steps} steps", cfg.n_layers * steps,
                   *_device_split(window))


# ---------------------------------------------------------------------------

def build_kernels(builders) -> None:
    """Build every kernel's source at once (``builders``: one zero-argument
    build function per source, one nvcc each, in parallel); report the
    seconds and the compiler's register/spill/shared-memory lines."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(builders)) as pool:
        built = list(pool.map(timed, builders))
    for lib, secs in built:
        log(f"phase 1: built {lib.name} in {secs:.3f} s")
        report = lib.with_name(lib.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    log("phase 1: ptxas " + line.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every workload, batch and weight draw "
                         "(default 0)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.obs as obs
        import repro_torch.pmwcas as pm
        import repro_torch.service as svc_mod
        import repro_torch.structures as st
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.pmwcas_apply import kernel
        from repro_torch.kernels.pmwcas_apply import ref
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models import build_model
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}:"
              f" {e}", file=sys.stderr)
        return 3
    # float32 references run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()
    build_kernels([kernel.build] + [functools.partial(fa_kernel.build, r)
                                    for r in fa_kernel.ROUTES])

    dev = torch.device("cuda")
    worst = kernel_vs_plain(pm, ref, kernel, args.seed, dev)
    small_service_matches_cpu(svc_mod, st, args.seed, dev)
    fa_worst = fa_kernel_vs_plain(fa_ops, fa_ref, fa_kernel, args.seed, dev)
    small_serve_matches_cpu(serve_mod, build_model, get_config, args.seed,
                            dev)
    small_serve_bf16(serve_mod, build_model, get_config, args.seed, dev)
    run = full_slice(pm, svc_mod, st, obs, kernel, dev, args.seed)
    t = kernel_timings(pm, ref, kernel, run["svc"], args.seed, dev)
    del run["svc"]
    log(f"phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    lm = lm_slice(serve_mod, build_model, get_config, ref, fa_kernel, kernel,
                  args.seed, dev)
    ft = flash_timings(fa_ops, fa_ref, fa_kernel, lm, dev, args.seed)
    where_time_goes(lm, ft, dev, args.seed)
    log(f"the whole smoke took {time.perf_counter() - t_start:.1f} s")

    pre, dec = ft["prefill"], ft["decode"]
    log("flash decode (bf16, the serve cell's shape): " + json.dumps({
        "route": dec["route"], "splits": dec["splits"],
        "graph_ms": dec["graph_ms"], "graph_plain_ms": dec["graph_plain_ms"],
        "graph_library_ms": dec["graph_library_ms"],
        "graph_rounds_ms": dec["graph_rounds_ms"],
        "graph_library_rounds_ms": dec["graph_library_rounds_ms"],
        "row_err": dec["row_err"], "faults": dec["faults"],
        "event_ms": dec["ms"],
        "event_plain_ms": dec["plain_ms"],
        "event_library_ms": dec["library_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"]}))
    log(card)
    print(json.dumps({"kernels": [{
        "name": "pmwcas_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/pmwcas_apply.cu",
        "route_launches": run["routes"],
        "replaces": "src/repro/kernels/pmwcas_apply/kernel.py:62",
        "launches": run["launches"], "max_abs_err": worst,
        "ms": t["ms"], "global_route_ms": t["global_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "latency_floor_ms": t["floor_ms"],
        "wave_dispatch_device_us": run["wave_split"]["dispatch"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "sources": [f"src/repro_torch/csrc/{p.name}"
                    for p in fa_kernel.SOURCES.values()],
        "route_launches": lm["fa_routes"],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
        "launches": lm["fa_launches"],
        "max_abs_err": max(fa_worst, pre["err"], dec["err"]),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
