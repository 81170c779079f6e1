#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card and build — the card's name and power limit, then the five
   Hopper sources built from ``src/repro_torch/csrc/{pmwcas_apply,
   flash_attention_tc, flash_attention_decode, flash_attention,
   pmwcas_sim}.cu``, one nvcc each in parallel (seconds, ptxas
   registers/spills);
2. kernels vs plain — the PMwCAS kernel's verdicts and tables held bit
   for bit against its plain PyTorch version on both routes (``smem``,
   where its hash fits, and ``global``) over seeded ``[S, B, K]``
   batches (S in {1, 4}, B in {1, 7, 1024}, K in {1, 2, 8}, serve's
   ``[1, 128, 9]`` and a ``global``-sized ``[2, 4500, 2]``; uniform and
   Zipf-hot addresses; all-padded rows, duplicate ids, (a)-passing rows
   that lose and still block), over batches whose every address the
   smem hash sends to one home bucket, and over ``global`` rounds at the
   range index's widths (``WIDE_CASES``: split and GC ops of 132-390
   words among narrow ones, up to 65 rows, rows sharing words, repeated
   ids within a row, random desired values); ``reserve_slots``' corner cases
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
   alone;
7. the durable slice (the paper's persistence; host code over a
   ``PMemPool`` per shard in the temporary directory, on the machine's
   disk; its filesystem is printed) — ``run_differential`` holds the
   simulator kernel, the PMwCAS kernel and the durable committer against
   each other on seeded increment batches ``[B, K]`` of ``DIFF_SHAPES``
   (both routes, one simulator launch a batch; counts zeroed before,
   read after);
   YCSB-A (50% read, 50% update, Zipfian 0.99) from 8 clients over 4
   durable hash-map shards of 1,024 records with group commit, epochs of
   4 rounds, a checkpoint every 4 epochs and a WAL prune every 16 waves:
   integrity, the acknowledged writes read back, no held ack left,
   ``redundant_fences == 0`` and the WAL under its cap, then again after
   ``crash()``, and once more after a crash with an epoch open; ops/s,
   p50/p99, the persist share, flushes and fences per commit, recovery
   ms, the per-wave host split and the filesystem; last, the reference
   bench's window for the per-op protocol, group commit and the marker
   baseline (flushes per commit, fences);
8. the range index — ``KVService(n_shards=4, structure="bztree",
   leaf_cap=64, root_cap=64, round_cap=1024)`` on kernel shards
   (``TREE_RECORDS`` records, ``n_regions`` a sixteenth of a shard's),
   loaded and then driven by YCSB core workload E (95% scan, 5% insert,
   Zipfian 0.99) from 8 closed-loop clients with 4,096 ops outstanding;
   integrity, the acknowledged inserts read back, scans equal to a
   sorted count of the acknowledged keys, ``conflict_rate == 0``, height
   3 on every shard, launches by route equal to what the code issues
   (every wave ``smem``; every split one ``global`` wide op and three
   ``smem`` launches), then ``gc_regions`` (one ``global`` and one
   ``smem`` launch a freed region) and integrity again; ops/s, p50/p99,
   splits, the per-wave host split and the device idle share of the load
   and the run; the ``global`` route at the tree's widths (132, 390)
   against the plain version with its time; ``run_struct_differential``
   (bztree) on the card against durable shards, its rounds replayed on a
   CPU ``KernelBackend`` and on the simulator kernel (one launch a
   checked round, counted here), and its table equal to a CPU tree's; and the
   raw-op ``BatchScheduler`` on 4 card shards against 4 CPU shards;
9. the cycle-accurate simulator (``csrc/pmwcas_sim.cu``, many
   simulations a launch) — (a) the kernel against its plain version bit
   for bit on the whole state, the four algorithms over ``SIM_CASES``
   (drained and cut) in one mixed launch, and alone == batched; (b)
   every crash point 1-399 of ``test_crash_exhaustive_prefix``'s
   schedule for the four algorithms in one launch, each recovering
   consistently and held to the plain version, and the pinned ORIGINAL
   crash (seed 8016, step 365) raising the reference's RecoveryError
   through ``SimSession.crash_at`` on the card;
   (c) ``run_struct_differential(hashmap, algorithm="ours")`` with every
   round replayed on the simulator kernel; (d) the Figs. 9-10 grid
   (``benchmarks/bench_threads.py``: 84 drained cells at 1,000,000 words,
   60,000 steps, ``max_ops`` 512, seed 11) in ONE launch: modeled Mops
   at 2 GHz, CAS / flush / invalidations per op and p99 per cell, the
   zero-conflict CAS counts at one thread, the ours/original ratio at
   t = 56, alpha = 1, four full-size cells held to the plain version
   (its time per step extrapolated to the grid), and one cell alone for
   the time per step beside the latency floor.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``{"kernels": [...]}`` record, and the line before that the
decode shape's numbers.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import itertools
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
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


# [1, B, K] rounds of the range index's widths, padded to the widest: a
# leaf split's materialization (132-135 words at node caps of 64) and a
# GC op over a full region (390) among 1-3-word ops; up to 32 rows take
# the global route's one-thread-a-slot kernel, 65 rows its per-row one
WIDE_CASES = ((132, 3, 3, 390, 2), (390, 390, 135, 1), (132,) * 32,
              (3,) * 64 + (260,))


def _wide_batch(rng, W, widths, stale=0.2, share=0.3, dup=0.3):
    """One seeded ``[1, B, K]`` round of rows of ``widths`` against
    ``[1, W]`` words: live words, expected mostly current (a ``stale``
    share of rows fails (a)), desired random, a ``share`` of rows taking
    two words of earlier rows (so (a)-passing rows contend), and a
    ``dup`` share of rows repeating one id within the row (its
    expected value the same, its desired value its own)."""
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
        row = np.sort(row)
        if k > 1 and rng.random() < dup:
            row[-1] = row[0]
        addr[i, :k] = row
        taken.append(addr[i, :k])
    exp = words[np.maximum(addr, 0)]
    stale_rows = rng.random(len(widths)) < stale
    exp[stale_rows, 0] += 1
    des = rng.integers(0, 1 << 32, addr.shape,
                       dtype=np.uint64).astype(np.uint32)
    return words[None], addr[None], exp[None], des[None]


def _b_losers(pm, ref, dev, words_np, addr, exp, des) -> int:
    """Rows of one ``[1, B, K]`` round that pass (a) (every live slot's
    expected value current) and still lose, by the plain version."""
    live = addr[0] >= 0
    cur = words_np[0][np.maximum(addr[0], 0)]
    passes = ((cur == exp[0]) | ~live).all(1) & live.any(1)
    w = pm.words_to_tensor(words_np, dev)
    _, s = ref.pmwcas_apply_stacked(
        w, *[pm.words_to_tensor(a, dev) for a in (addr, exp, des)])
    return int((passes & ~s[0].cpu().numpy()).sum())


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
    b_losers = 0
    for widths in WIDE_CASES:
        words_np, addr, exp, des = _wide_batch(rng, 1 << 16, widths)
        check(kernel.plan(*addr.shape[1:])[0] == "global",
              f"{len(widths)} rows of up to {max(widths)} words: plan")
        worst = max(worst, _held(pm, ref, kernel, dev, words_np, addr, exp,
                                 des, "global",
                                 f"{len(widths)} rows of up to "
                                 f"{max(widths)} words"))
        n_cases["global"] += 1
        b_losers += _b_losers(pm, ref, dev, words_np, addr, exp, des)
    check(b_losers > 0, "no (a)-passing row lost a claim in the wide cases")
    log(f"phase 2: kernel == plain bit for bit on {json.dumps(n_cases)} "
        "[S, B, K] batches by route (uniform, Zipf-hot, every address in "
        "one home bucket of the smem hash, the range index's wide rounds: "
        f"{b_losers} (a)-passing rows lost a claim there)")

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
    NAMES = ("wave.snapshot", "wave.grow", "wave.compile", "wave.schedule",
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
                "grow": t["wave.grow"],
                "compile": t["wave.compile"] - t["wave.snapshot"]
                - t["wave.grow"],
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
# phase 7: the durable slice (the paper's persistence, host code)
# ---------------------------------------------------------------------------

# kernel against durable: [B, K] increment batches and the route each takes
DIFF_SHAPES = ((1024, 2, "smem"), (256, 16, "smem"), (512, 32, "global"))
# durable YCSB-A: 4 hash-map shards; the record count is cut from the ycsb
# cell's 1,048,576 because a durable snapshot reads every slot file of a
# shard on every wave (see PERF.md §4)
DUR_SHARDS, DUR_ROUND_CAP, DUR_RECORDS, DUR_OPS = 4, 64, 1024, 2048
DUR_KW = dict(group_commit=True, epoch_rounds=4, checkpoint_every=4,
              wal_prune_every=16)
# the reference bench's workload (benchmarks/bench_durable.py): 96 ops
# over 48 keys, 2 shards, round_cap 8, 8 clients
LEDGER_SPEC = dict(n_ops=96, n_keys=48, read=0.1, update=0.55, insert=0.25,
                   delete=0.1, alpha=0.9, seed=23)


def durable_differential(pm, kernel, dev, seed: int) -> dict:
    """``run_differential`` on the card: the simulator kernel, the PMwCAS
    kernel and the durable committer on seeded increment batches, one per
    shape of ``DIFF_SHAPES``; verdicts and final values must be equal,
    each batch must take its route and run one simulator launch.  Counts
    are zeroed just before and read just after."""
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    out = {}
    kernel.reset_counts()
    sim_kernel.reset_counts()
    for B, K, route in DIFF_SHAPES:
        init, ops = pm.increment_batch(B * K, K, B, seed=seed + K)
        check(len(ops) == B, f"increment_batch gave {len(ops)} ops, not {B}")
        before = dict(kernel.pmwcas_apply_cuda.route_launches)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_diff_") as root:
            t0 = time.perf_counter()
            report = pm.run_differential(ops, init, durable_root=root,
                                         device=dev)
            secs = time.perf_counter() - t0
        check(report.agree and set(report.verdicts) ==
              {"sim", "kernel", "durable"},
              f"sim / kernel / durable disagree at [{B}, {K}]:\n"
              + report.summary())
        routes = kernel.pmwcas_apply_cuda.route_launches
        check(routes[route] == before[route] + 1,
              f"[{B}, {K}] did not launch on the {route} route: {routes}")
        won = int(report.verdicts["kernel"].sum())
        out[f"{B}x{K}"] = dict(route=route, ops=B, won=won, s=secs)
        log(f"phase 7: run_differential [{B}, {K}] on the {route} route: "
            f"sim == kernel == durable ({won}/{B} won, {B * K} words, "
            f"{secs:.3f} s with the committer's seeding)")
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    sim_launches = sim_kernel.pmwcas_sim_cuda.launches
    check(launches == len(DIFF_SHAPES) and all(routes.values())
          and sim_launches == len(DIFF_SHAPES),
          f"differential launches {launches}, routes {routes}, simulator "
          f"{sim_launches}: both routes and one simulation a batch must run")
    log("kernels: " + json.dumps({"pmwcas_apply differential": launches,
                                  "routes": routes,
                                  "pmwcas_sim differential": sim_launches}))
    return dict(launches=launches, routes=routes, shapes=out,
                sim_launches=sim_launches)


def fs_type(path) -> str:
    """The filesystem under ``path``, from ``/proc/mounts`` (the longest
    mount point that holds it)."""
    path = str(pathlib.Path(path).resolve())
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                dev, mnt, typ = line.split()[:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, kind = mnt, f"{typ} on {mnt} ({dev})"
    except OSError:
        pass
    return kind


def last_op_reads_back(st, items, futures) -> None:
    """Every key whose LAST submitted op was acknowledged holds that op's
    effect (nothing later can have changed it)."""
    last = {f.op.key: f for f in futures}
    for key, f in last.items():
        if not (f.done and f.status == st.OK):
            continue
        if f.op.kind in (st.INSERT, st.UPDATE):
            check(items.get(key) == f.op.value,
                  f"acknowledged write of key {key} lost: {items.get(key)}"
                  f" != {f.op.value}")
        elif f.op.kind == st.DELETE:
            check(key not in items, f"acknowledged delete of {key} lost")


def durable_slice(svc_mod, st, obs, dev, seed: int,
                  records: int = DUR_RECORDS, ops: int = DUR_OPS,
                  parent=None) -> dict:
    """YCSB-A over ``DUR_SHARDS`` durable hash-map shards (group commit,
    epochs of 4 rounds, a checkpoint every 4 epochs, WAL prune every 16
    waves): load, run, drain, crash and recover, crash again with an
    epoch open; integrity and the acknowledged writes are checked after
    each."""
    n_buckets = 2 * records // DUR_SHARDS
    window = DUR_ROUND_CAP * DUR_SHARDS
    spec = st.WorkloadSpec(n_ops=ops, n_keys=records, read=0.5,
                           update=0.5, insert=0.0, delete=0.0, alpha=0.99,
                           seed=seed)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_durable_",
                                         dir=parent))
    try:
        svc = svc_mod.KVService(DUR_SHARDS, backend="durable",
                                n_buckets=n_buckets,
                                round_cap=DUR_ROUND_CAP, durable_root=root,
                                device=dev, **DUR_KW)
        log(f"phase 7: durable KVService(n_shards={DUR_SHARDS}, round_cap="
            f"{DUR_ROUND_CAP}, n_buckets={n_buckets}, "
            + ", ".join(f"{k}={v}" for k, v in DUR_KW.items())
            + f") over {fs_type(root)}")
        t0 = time.perf_counter()
        load_futs = drive(svc, [(0, op) for op in st.load_phase(spec, 1.0)],
                          window)
        load_s = time.perf_counter() - t0
        check(all(f.status == st.OK for f in load_futs),
              "a durable load insert failed")
        log(f"phase 7: loaded {records} records in {load_s:.3f} s "
            f"({svc.stats.steps} waves)")

        arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
        svc.reset_stats()
        svc.stats.latency_us.window = len(arrivals)
        d0 = svc.durability_stats()
        persists0 = sum(b.pool.persist_count for b in svc.backends)
        split = WaveSplit(obs.get_tracer())
        obs.enable_tracing()
        try:
            t0 = time.perf_counter()
            run_futs = drive(svc, arrivals, window, on_step=split)
            run_s = time.perf_counter() - t0
        finally:
            obs.disable_tracing()
            obs.get_tracer().clear()
        stats = svc.stats
        d1 = svc.durability_stats()
        reg = obs.get_registry()
        delta = {k: d1.as_row()[k] - d0.as_row()[k] for k in d1.as_row()}
        committed = max(1, delta["ops_committed"])
        redundant = {dict(s.labels).get("reason"): int(s.value)
                     for s in reg.series("redundant_fences") if s.value}
        wal = sum(len(b.pool.listdir("wal")) for b in svc.backends)
        wal_cap = 2 * svc.wal_prune_every * DUR_SHARDS
        row = dict(
            ops=len(arrivals), s=run_s, ops_per_s=len(arrivals) / run_s,
            waves=stats.steps, p50_us=stats.p50_latency_us,
            p99_us=stats.p99_latency_us,
            persist_us_mean=stats.persist_us.mean_us,
            latency_us_mean=stats.latency_us.mean_us,
            flushes_per_commit=delta["flushes_issued"] / committed,
            fences_per_commit=delta["fences"] / committed,
            persists=sum(b.pool.persist_count for b in svc.backends)
            - persists0, durability=delta, acks_held=stats.acks_held,
            epoch_syncs=stats.epoch_syncs, wal_pruned=stats.wal_pruned,
            wal_records=wal, wal_cap=wal_cap, redundant_fences=redundant,
            wave_split_us=split.per_wave_us())
        log(f"phase 7: durable YCSB-A {len(arrivals)} ops from {N_CLIENTS} "
            f"clients in {run_s:.3f} s: {row['ops_per_s']:.1f} ops/s, "
            f"{stats.steps} waves, p50 {row['p50_us']:.1f} us, p99 "
            f"{row['p99_us']:.1f} us, persist share {row['persist_us_mean']:.1f}"
            f" us of a mean {row['latency_us_mean']:.1f} us latency")
        log(f"phase 7: flushes per commit {row['flushes_per_commit']:.4f}, "
            f"fences per commit {row['fences_per_commit']:.4f}, persists "
            f"{row['persists']}, WAL {wal} records (cap {wal_cap}), "
            f"acks held {stats.acks_held}, epoch syncs {stats.epoch_syncs}, "
            f"WAL pruned {stats.wal_pruned}, redundant fences {redundant}")
        log("phase 7: durability " + json.dumps(delta))
        log(f"phase 7: per-wave host split over {split.waves} traced waves "
            "(tracing on), us/wave: " + json.dumps(
                {k: round(v, 1) for k, v in row["wave_split_us"].items()}))

        check(all(f.done for f in run_futs), "a durable future is pending")
        check(svc.pending_count == 0 and not svc._held,
              "held acks left after the drain")
        check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "ops exhausted")
        items = svc.check_integrity()
        acked = acked_state(st, acked_state(st, {}, load_futs), run_futs)
        check(items == acked, "acknowledged durable writes do not read back")
        check(sum(redundant.values()) == 0,
              f"redundant fences on the durable path: {redundant}")
        check(wal <= wal_cap, f"WAL holds {wal} records, cap {wal_cap}")

        t0 = time.perf_counter()
        svc = svc.crash()
        row["recover_ms"] = (time.perf_counter() - t0) * 1e3
        check(svc.check_integrity() == acked,
              "acknowledged writes lost across crash()/recover")
        log(f"phase 7: crash() + recover in {row['recover_ms']:.1f} ms: "
            "integrity ok, every acknowledged write reads back")

        # crash again with an epoch open: acks are held until it closes,
        # so no acknowledged op may be lost
        more = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        futs = [svc.submit(op, client=c) for c, op in more]
        open_epochs = held = 0
        while svc.pending_count and not (open_epochs and held):
            svc.step()
            open_epochs = sum(b.epoch_pending for b in svc.backends)
            held = len(svc._held)
        check(open_epochs > 0 and held > 0,
              f"no epoch open ({open_epochs} rounds) or no ack held "
              f"({held}) at the second crash")
        svc = svc.crash()
        items = svc.check_integrity()
        last_op_reads_back(st, items, load_futs + run_futs + futs)
        row.update(open_epoch_rounds=open_epochs, held_at_crash=held)
        log(f"phase 7: crash with {open_epochs} rounds in open epochs and "
            f"{held} acks held: integrity ok, no acknowledged op lost")
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def durable_ledger(svc_mod, st, pm, obs, svc_kw: dict, root) -> dict:
    """The reference bench's window (``LEDGER_SPEC``) on 2 durable shards
    for the per-op protocol, group commit and the dirty-flag baseline:
    flushes per commit, fences and redundant fences, from the registry.
    Takes the package's modules, so the CPU tests run it on both."""
    root = pathlib.Path(root)
    spec = st.WorkloadSpec(**LEDGER_SPEC)
    load = st.load_phase(spec, fraction=1.0)
    streams = st.client_streams(spec, 8)
    out = {}
    for mode in ("per_op", "group", "marker"):
        common = dict(structure="hashmap", n_buckets=2 * spec.n_keys,
                      round_cap=8, **svc_kw)
        if mode == "marker":
            svc = svc_mod.KVService(2, backend=[
                pm.DurableBackend(root / mode / f"shard{s}",
                                  committer="marker") for s in range(2)],
                **common)
        else:
            svc = svc_mod.KVService(2, backend="durable",
                                    durable_root=root / mode,
                                    group_commit=mode == "group", **common)
        svc.apply(load)
        svc.reset_stats()
        for i in range(max(len(s) for s in streams)):
            for client, stream in enumerate(streams):
                if i < len(stream):
                    svc.submit(stream[i], client=client)
        svc.drain()
        svc.check_integrity()
        reg = obs.get_registry()
        committed = int(reg.value("ops_committed", component="committer"))
        issued = int(reg.value("flushes_issued", component="committer"))
        out[mode] = dict(
            flushes_issued=issued, ops_committed=committed,
            flushes_per_commit=issued / max(1, committed),
            fences=int(reg.value("fences", component="committer")),
            flush_fences=int(reg.total("flush_fences")),
            redundant_fences=int(reg.total("redundant_fences")))
    return out


def durable_phase(pm, svc_mod, st, obs, kernel, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    diff = durable_differential(pm, kernel, dev, seed)
    ycsb = durable_slice(svc_mod, st, obs, dev, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ledger_") as root:
        ledger = durable_ledger(svc_mod, st, pm, obs, dict(device=dev), root)
    for mode, row in ledger.items():
        log(f"phase 7: ledger {mode}: flushes per commit "
            f"{row['flushes_per_commit']:.4f} ({row['flushes_issued']} / "
            f"{row['ops_committed']}), fences {row['fences']}, flush fences "
            f"{row['flush_fences']}, redundant {row['redundant_fences']}")
    check(ledger["group"]["redundant_fences"] == 0,
          "group commit paid redundant fences")
    check(ledger["per_op"]["redundant_fences"] > 0,
          "the per-op read barrier flagged no redundant fence")
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    return dict(differential=diff, ycsb=ycsb, ledger=ledger)


# ---------------------------------------------------------------------------
# phase 8: the range index — BzTree shards under YCSB-E
# ---------------------------------------------------------------------------

# leaf_cap = root_cap = 64: a leaf of 129 words, an inner node of 130, a
# region of 390 (a root split's two halves and new root); a split's wide
# MwCAS is 132-135 words and a GC zeroing op up to 390, so both take the
# kernel's global route, while the waves' 3-word inserts take smem
TREE_CAP = 64
# YCSB-E at the ycsb cell's operation count; the record count is cut from
# its 1,048,576 as PERF.md §4 "Reduced" sets out
TREE_RECORDS, TREE_OPS = 1 << 18, 1 << 16
TREE_SAMPLE = 16                     # every 16th load wave is traced
TREE_WIDTHS = (132, 390)             # a leaf split's wide op; a full GC op


class BoundedClients:
    """Closed-loop clients: before each wave, ops are submitted in
    arrival order until ``window`` are outstanding (a client issues its
    next op once one of its own completes; ``window`` in flight in all),
    then the wave runs."""

    def __init__(self, svc, arrivals, window: int):
        self.svc, self.arrivals, self.window = svc, arrivals, window
        self.next = 0
        self.futures = []
        self.waves = 0

    @property
    def done(self) -> bool:
        return self.next >= len(self.arrivals) and not self.svc.pending_count

    def wave(self) -> None:
        room = self.window - self.svc.pending_count
        if room > 0 and self.next < len(self.arrivals):
            self.futures += [self.svc.submit(op, client=c) for c, op in
                             self.arrivals[self.next:self.next + room]]
            self.next += room
        self.svc.step()
        self.waves += 1

    def run(self, waves: Optional[int] = None, on_step=None) -> int:
        n = 0
        while not self.done and (waves is None or n < waves):
            self.wave()
            n += 1
            if on_step:
                on_step()
        return n


def tree_spec(st, records: int, ops: int, seed: int):
    """YCSB core workload E (95% scan, 5% insert, Zipfian 0.99) over a
    key universe of twice ``records``; the load inserts half of it, so an
    insert of a key not loaded is a real insert, as E's inserts of new
    records are."""
    spec = dataclasses.replace(st.YCSB_E, n_ops=ops, n_keys=2 * records,
                               alpha=0.99, seed=seed)
    check((spec.scan, spec.insert) == (0.95, 0.05), f"YCSB-E mix {spec}")
    return spec


def tree_expected_launches(svc, dispatches: int) -> dict:
    """The launches by route the tree path issues, worked out from the
    code: a stacked wave is one smem launch; every split (leaf, inner or
    root; ``splits`` counts them at their install) is a freeze, a region
    reserve and an install or swing (3 smem launches) plus ONE wide
    materialization of at least 132 words (global); a consolidation is a
    reserve, a freeze, a compacted image of at most 5 words and a swing
    (4 smem)."""
    splits = sum(t.splits for t in svc.structs)
    cons = sum(t.consolidations for t in svc.structs)
    return {"smem": dispatches + 3 * splits + 4 * cons, "global": splits}


def tree_slice(pm, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = TREE_RECORDS, ops: int = TREE_OPS) -> dict:
    n_regions = records // N_SHARDS // 16
    window = ROUND_CAP * N_SHARDS
    spec = tree_spec(st, records, ops, seed)
    svc = svc_mod.KVService(N_SHARDS, structure="bztree", leaf_cap=TREE_CAP,
                            root_cap=TREE_CAP, n_regions=n_regions,
                            round_cap=ROUND_CAP, device=dev)
    W = svc.words_per_shard
    region = svc.structs[0].region_words
    check(all(b.word_table().device.type == dev.type and b.n_words == W
              for b in svc.backends) and all(
                  t.allocator.device.type == dev.type for t in svc.structs),
          "tree tables or free lists are not on the card")
    log(f"phase 8: KVService(n_shards={N_SHARDS}, structure='bztree', "
        f"leaf_cap={TREE_CAP}, root_cap={TREE_CAP}, n_regions={n_regions}, "
        f"round_cap={ROUND_CAP}) -> {N_SHARDS} x {W} words "
        f"({N_SHARDS * W * 4 / 2**20:.1f} MiB) on the card, regions of "
        f"{region} words")

    tracer = obs.get_tracer()
    load_split = WaveSplit(tracer)
    kernel.reset_counts()                     # count the main path only
    loader = BoundedClients(svc, [(0, op) for op in st.load_phase(spec, 0.5)],
                            window)
    load_prof = None
    t0 = time.perf_counter()
    while not loader.done:
        if loader.waves == 64 and load_prof is None and dev.type == "cuda":
            w0 = loader.waves
            by_name, count, wall_us = _profile(lambda: loader.run(8))
            load_prof = (by_name, count, wall_us, loader.waves - w0)
            continue
        traced = loader.waves % TREE_SAMPLE == TREE_SAMPLE - 1
        if traced:
            obs.enable_tracing()
        loader.wave()
        if traced:
            obs.disable_tracing()
            load_split()
    _sync(dev)
    load_s = time.perf_counter() - t0
    tracer.clear()
    load_futs = loader.futures
    check(all(f.status == st.OK for f in load_futs), "a tree load insert "
          "failed: " + json.dumps(collections.Counter(
              f.status for f in load_futs)))
    load_waves = svc.stats.steps
    dispatches = svc.executor.stats.dispatches + \
        svc.executor.stats.serial_rounds
    log(f"phase 8: loaded {len(load_futs)} records in {load_s:.3f} s "
        f"({load_waves} waves, {load_split.waves} traced, 8 profiled); "
        f"splits {[t.splits for t in svc.structs]}, root splits "
        f"{[t.root_splits for t in svc.structs]}, heights "
        f"{[t.height() for t in svc.structs]}")

    arrivals = _arrivals(st.client_streams(spec, N_CLIENTS))
    svc.reset_stats()
    svc.stats.latency_us.window = len(arrivals)
    runner = BoundedClients(svc, arrivals, window)
    t0 = time.perf_counter()
    runner.run()
    _sync(dev)
    run_s = time.perf_counter() - t0
    dispatches += svc.executor.stats.dispatches + \
        svc.executor.stats.serial_rounds
    launches = kernel.pmwcas_apply_cuda.launches
    routes = dict(kernel.pmwcas_apply_cuda.route_launches)
    stats = svc.stats
    run_futs = runner.futures
    # the YCSB-E window's numbers, taken before the GC, traced and
    # profiled windows below run on the same service
    run_waves, run_p50_us, run_p99_us = (
        stats.steps, stats.p50_latency_us, stats.p99_latency_us)
    run_splits = [t.splits for t in svc.structs]
    run_root_splits = [t.root_splits for t in svc.structs]
    kinds = collections.Counter(f"{f.op.kind} {f.status}" for f in run_futs)
    log(f"phase 8: YCSB-E {len(arrivals)} ops from {N_CLIENTS} clients in "
        f"{run_s:.3f} s: {len(arrivals) / run_s:.1f} ops/s, {run_waves} "
        f"waves, p50 {run_p50_us:.1f} us, p99 {run_p99_us:.1f} us; splits "
        f"{run_splits}, root splits {run_root_splits}; "
        f"{json.dumps(kinds)}")
    log("phase 8: stats " + json.dumps(stats.as_row()))

    check(all(f.done for f in run_futs), "a tree future is still pending")
    check(stats.by_status.get(st.EXHAUSTED, 0) == 0, "tree ops exhausted")
    check(stats.conflict_rate == 0.0,
          f"tree conflict_rate {stats.conflict_rate} != 0")
    check(all(sh.out_of_regions == 0 for sh in stats.shards),
          "a tree shard ran out of regions")
    items = svc.check_integrity()
    acked = acked_state(st, acked_state(st, {}, load_futs), run_futs)
    check(items == acked, "acknowledged tree inserts do not read back")
    heights = [t.height() for t in svc.structs]
    check(min(heights) >= 3 and all(t.root_splits >= 2 for t in svc.structs),
          f"tree heights {heights}: every shard must reach 3 (root splits)")
    keys = np.sort(np.fromiter(acked, np.int64, len(acked)))
    rng = np.random.default_rng(seed + 8)
    probes = [int(k) for k in rng.integers(1, 2 * records, 6)] + [1]
    got = [r.value for r in svc.apply([st.KVOp(st.SCAN, k) for k in probes])]
    want = [len(keys) - int(np.searchsorted(keys, k)) for k in probes]
    check(got == want, f"scans {got} != the sorted count {want}")
    expected = tree_expected_launches(svc, dispatches)
    splits = sum(t.splits for t in svc.structs)
    check(routes == expected and launches == sum(expected.values()),
          f"tree launches by route {routes} != worked out {expected} "
          f"({dispatches} waves, {splits} splits)")
    log(f"phase 8: integrity ok, every acknowledged insert reads back, "
        f"scans {got} == the sorted count, conflict_rate 0, heights "
        f"{heights}; launches by route {routes} == worked out from "
        f"{dispatches} waves and {splits} splits")

    # GC: every frozen split original is a full node, so each freed
    # region is one global zeroing op and one smem free
    before = dict(kernel.pmwcas_apply_cuda.route_launches)
    t0 = time.perf_counter()
    freed = svc.gc_regions()
    gc_ms = (time.perf_counter() - t0) * 1e3
    gc_routes = {r: kernel.pmwcas_apply_cuda.route_launches[r] - before[r]
                 for r in before}
    check(freed > 0 and gc_routes == {"smem": freed, "global": freed},
          f"GC freed {freed} regions with launches {gc_routes}")
    check(svc.check_integrity() == items, "GC changed the tree's items")
    log(f"phase 8: gc_regions freed {freed} regions in {gc_ms:.1f} ms "
        f"(launches {gc_routes}); integrity holds after it")

    # a traced window (host split) and a profiled one (device idle share)
    run_split = WaveSplit(tracer)
    obs.enable_tracing()
    try:
        traced = _arrivals(st.client_streams(
            dataclasses.replace(spec, n_ops=ops // 4, seed=seed + 1),
            N_CLIENTS))
        BoundedClients(svc, traced, window).run(on_step=run_split)
    finally:
        obs.disable_tracing()
        tracer.clear()
    profiled = _arrivals(st.client_streams(
        dataclasses.replace(spec, n_ops=ops // 8, seed=seed + 2), N_CLIENTS))
    prof_driver = BoundedClients(svc, profiled, window)
    run_prof = (_profile(lambda: prof_driver.run()) + (prof_driver.waves,)
                if dev.type == "cuda" else None)
    svc.check_integrity()
    idle = {}
    for what, prof in (("load", load_prof), ("run", run_prof)):
        if prof is None:
            idle[what] = None
            log(f"phase 8: {what} device busy not measured (no profiled "
                "window)")
            continue
        by_name, count, wall_us, waves = prof
        busy = sum(by_name.values()) or None
        idle[what] = None if busy is None else 1 - busy / wall_us
        log(f"phase 8: {what} device busy " + (
            "not measured" if busy is None else
            f"{busy:.1f} us of {wall_us:.1f} us wall over {waves} waves: "
            f"idle share {idle[what]:.4f} (profiler)"))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"phase 8:   {us / max(waves, 1):12.3f} us/wave  "
                f"{count[name] / max(waves, 1):6.2f}/wave  {name[:80]}")
    host = {"load": load_split.per_wave_us(), "run": run_split.per_wave_us()}
    for what, per in host.items():
        log(f"phase 8: {what} per-wave host split over "
            f"{(load_split if what == 'load' else run_split).waves} traced "
            "waves (tracing on), us/wave: "
            + json.dumps({k: round(v, 1) for k, v in per.items()}))
    return dict(records=records, ops=len(arrivals), n_regions=n_regions,
                words_per_shard=W, load_s=load_s, load_waves=load_waves,
                run_s=run_s, ops_per_s=len(arrivals) / run_s,
                waves=run_waves, p50_us=run_p50_us, p99_us=run_p99_us,
                launches=launches, routes=routes, splits=run_splits,
                root_splits=run_root_splits,
                heights=heights, freed=freed, gc_ms=gc_ms,
                gc_routes=gc_routes, idle=idle, host_split_us=host,
                svc=svc)


def tree_kernel_timings(pm, ref, kernel, svc, seed: int, dev) -> dict:
    """The global route at the tree's wide widths (``TREE_WIDTHS``: a
    leaf split's materialization, a GC op over a full region) on a copy
    of shard 0's table: one ``[1, 1, K]`` row of live words.  Kernel ==
    plain bit for bit first, twice: expected == current with random
    desired values and one id repeated (the row wins and stores), and
    with one expected value stale (the row loses and stores nothing).
    Then, with desired == expected so that every launch does the same
    full work, device µs per launch (profiler), the plain version's, and
    the bound."""
    rng = np.random.default_rng(seed + 9)
    words = svc.backends[0].word_table()[None].clone()
    host = pm.tensor_to_words(words)[0]
    live = np.flatnonzero(host)
    out = {}
    for K in TREE_WIDTHS:
        check(kernel.plan(1, K)[0] == "global", f"[1, 1, {K}] plan")
        addr = np.sort(rng.choice(live, K, replace=False)).astype(
            np.int32)[None, None]
        exp = host[addr]
        claim = kernel.claim_scratch(words)
        dup = addr.copy()
        dup[..., -1] = dup[..., 0]                 # one id twice in the row
        stale = exp.copy()
        stale[..., K // 2] += 1
        des = rng.integers(0, 1 << 32, addr.shape,
                           dtype=np.uint64).astype(np.uint32)
        for ad, ex, win in ((dup, host[dup], True), (addr, stale, False)):
            a, e, d = (pm.words_to_tensor(x, dev) for x in (ad, ex, des))
            w_k, w_p = words.clone(), words.clone()
            s_k = kernel.pmwcas_apply_cuda(w_k, a, e, d, claim=claim)
            _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
            torch.cuda.synchronize()
            check(bool(s_k.all()) == win and torch.equal(s_k, s_p)
                  and torch.equal(w_k, w_p) and
                  torch.equal(w_k, words) != win,
                  f"[1, 1, {K}] (the row {'wins' if win else 'loses'}): "
                  "kernel != plain")
        a, e = (pm.words_to_tensor(x, dev) for x in (addr, exp))
        d = e.clone()
        success = torch.empty((1, 1), dtype=torch.bool, device=dev)
        w_k, w_p = words.clone(), words.clone()
        run = (lambda: kernel.launch(w_k, a, e, d, success, route="global",
                                     claim=claim))
        us, n = _per_launch_us(run, 200, "pmwcas_apply")
        plain_dev, _ = _device_us(lambda: ref.pmwcas_apply_stacked(
            w_p, a, e, d), 20)
        ev_ms = _event_ms(run, 200)
        ms = us / 1e3 if us else ev_ms
        plain_ms = plain_dev / 20 / 1e3 if plain_dev else \
            _event_ms(lambda: ref.pmwcas_apply_stacked(w_p, a, e, d), 20)
        n_bytes = 3 * K * 4 + K * 4 + K * 4 + 1
        bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
        out[K] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      event_ms=ev_ms)
        log(f"phase 8: global route at [1, 1, {K}] on a {words.shape[1]}-"
            f"word table: kernel == plain (random desired values and a "
            f"repeated id: the row wins; a stale value: it loses); "
            f"{ms * 1e3:.3f} us/launch "
            f"({'profiler' if us else 'CUDA events'}, {n} launches seen), "
            f"stream time {ev_ms * 1e3:.3f} us back to back (CUDA events), "
            f"plain {plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.5f} us "
            f"({n_bytes} bytes)")
    return out


def tree_differential(st, pm, dev, seed: int) -> dict:
    """``run_struct_differential(structure="bztree")``: the tree on the
    card's kernel shard against the tree on durable shards, on a seeded
    workload that splits (leaf_cap 8, so a split's wide op takes the
    global route); then the card tree's rounds replayed on a CPU
    ``KernelBackend`` (verdicts and post-round words), and the same
    stream on a CPU tree: its word table must equal the card's bit for
    bit."""
    spec = st.WorkloadSpec(n_ops=96, n_keys=96, read=0.2, update=0.2,
                           insert=0.45, delete=0.1, scan=0.05, alpha=0.5,
                           seed=seed + 4, batch=8)
    kvops = st.load_phase(spec, 0.5) + st.compile_workload(spec)
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    from repro_torch.structures.differential import _replay_rounds_on_sim
    shape = dict(leaf_cap=8, root_cap=4, n_regions=40)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tree_diff_") as root:
        sim_kernel.reset_counts()
        t0 = time.perf_counter()
        rep = st.run_struct_differential(kvops, structure="bztree",
                                         durable_root=root, device=dev,
                                         **shape)
        secs = time.perf_counter() - t0
        sim_launches = sim_kernel.pmwcas_sim_cuda.launches
    check(rep.agree, "tree kernel != durable:\n" + rep.summary())
    check(sim_launches == rep.sim_rounds_checked > 0,
          f"the tree differential made {sim_launches} simulator launches "
          f"for {rep.sim_rounds_checked} rounds checked")
    # the simulator's share of the differential's time: its replay again,
    # alone (these launches come after the count was read)
    t0 = time.perf_counter()
    _replay_rounds_on_sim(rep.structs["kernel"].last_history, "ours", dev)
    sim_secs = time.perf_counter() - t0
    card = rep.structs["kernel"]
    check(card.splits >= 3 and card.root_splits >= 1,
          f"the differential's tree split {card.splits} times")
    replayed, ok = st.replay_rounds(card.last_history, device="cpu")
    check(ok, "the card tree's rounds replayed on the CPU disagree")
    cpu = st.BzTreeIndex(pm.KernelBackend(n_words=card.backend.n_words,
                                          device="cpu"), device="cpu",
                         **shape)
    cpu_res = cpu.apply(kvops)
    check([r.status for r in cpu_res] == rep.statuses["kernel"]
          and np.array_equal(cpu.backend.values(), card.backend.values())
          and np.array_equal(cpu.allocator.mask(), card.allocator.mask()),
          "the tree on the card != the same stream on the CPU")
    log(f"phase 8: run_struct_differential(bztree) kernel on the card == "
        f"durable ({len(kvops)} ops, {rep.rounds['kernel']} rounds, "
        f"{card.splits} splits, {card.root_splits} root splits, {secs:.2f} "
        f"s); {rep.sim_rounds_checked} rounds replayed on the simulator "
        f"kernel in {sim_launches} launches ({rep.sim_rounds_skipped} "
        f"skipped; the replay alone {sim_secs:.3f} s); {replayed} rounds "
        f"replayed on the CPU match; word table == the CPU tree's bit for "
        f"bit")
    return dict(ops=len(kvops), rounds=rep.rounds["kernel"],
                splits=card.splits, s=secs, sim_launches=sim_launches,
                sim_skipped=rep.sim_rounds_skipped, sim_s=sim_secs)


def raw_stream(seed: int, n_shards: int, words: int, n_ops: int,
               cross: float = 0.1):
    """Seeded raw increment-style ops over ``n_shards`` x ``words``: a
    few hot words a shard (shared targets, so rounds defer), expected
    values from a running model (80% current, so some fail (a)), and a
    ``cross`` share spanning two shards."""
    rng = np.random.default_rng(seed)
    model = np.zeros(n_shards * words, np.int64)
    out = []
    for _ in range(n_ops):
        k = int(rng.integers(1, 4))
        if rng.random() < cross:
            shards = rng.choice(n_shards, 2, replace=False)
            addrs = sorted({int(s) * words + int(rng.integers(words))
                            for s in shards})
        else:
            s = int(rng.integers(n_shards))
            addrs = sorted({s * words + int(rng.integers(words // 8))
                            for _ in range(k)})
        targets = []
        for a in addrs:
            exp = int(model[a]) + (0 if rng.random() < 0.8 else 1)
            targets.append((a, exp, exp + 1))
        for a, _e, d in targets:
            model[a] = d
        out.append(targets)
    return out


def scheduler_matches_cpu(pm, svc_mod, dev, seed: int) -> dict:
    """``BatchScheduler`` over 4 kernel shards on the card against the
    same over 4 CPU shards: one seeded raw stream (cross-shard ops among
    it) from 8 clients in windows; verdicts, latencies in rounds, the
    round/defer/cross counts and the tables must be equal."""
    stream = raw_stream(seed + 5, N_SHARDS, 1024, 8192)
    outs = []
    for device in (dev, torch.device("cpu")):
        backends = [pm.KernelBackend(n_words=1024, device=device)
                    for _ in range(N_SHARDS)]
        sched = svc_mod.BatchScheduler(
            backends, svc_mod.ShardRouter(N_SHARDS, words_per_shard=1024),
            round_cap=ROUND_CAP)
        futs = []
        t0 = time.perf_counter()
        for start in range(0, len(stream), 2048):
            futs += [sched.submit(pm.MwCASOp(t), client=i % N_CLIENTS)
                     for i, t in enumerate(stream[start:start + 2048])]
            sched.step()
        sched.drain()
        secs = time.perf_counter() - t0
        st_ = sched.stats
        outs.append(dict(
            verdicts=[(f.success, f.latency_rounds) for f in futs],
            tables=[b.values().tolist() for b in backends],
            counts=dict(steps=st_.steps, cross_rounds=st_.cross_rounds,
                        cross_ops=st_.cross_ops,
                        rounds=[s.rounds for s in st_.shards],
                        defers=[s.defers for s in st_.shards]),
            s=secs))
    card, cpu = outs
    check(card["verdicts"] == cpu["verdicts"] and card["tables"] ==
          cpu["tables"] and card["counts"] == cpu["counts"],
          "BatchScheduler on the card != on the CPU")
    won = sum(v for v, _r in card["verdicts"])
    check(card["counts"]["cross_ops"] > 0 and 0 < won < len(stream)
          and sum(card["counts"]["defers"]) > 0,
          f"the raw stream exercised too little: {card['counts']}")
    log(f"phase 8: BatchScheduler card == CPU on {len(stream)} raw ops "
        f"({won} won, {card['counts']['cross_ops']} cross-shard in "
        f"{card['counts']['cross_rounds']} global rounds, "
        f"{sum(card['counts']['defers'])} defers, {card['counts']['steps']}"
        f" waves; {card['s']:.2f} s on the card, {cpu['s']:.2f} s on the "
        "CPU)")
    return card["counts"]


def tree_phase(pm, ref, svc_mod, st, obs, kernel, dev, seed: int,
               records: int = TREE_RECORDS) -> dict:
    t0 = time.perf_counter()
    run = tree_slice(pm, svc_mod, st, obs, kernel, dev, seed, records)
    timings = tree_kernel_timings(pm, ref, kernel, run.pop("svc"), seed, dev)
    diff = tree_differential(st, pm, dev, seed)
    sched = scheduler_matches_cpu(pm, svc_mod, dev, seed)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return dict(run=run, timings=timings, differential=diff,
                scheduler=sched)


# ---------------------------------------------------------------------------
# phase 9: the cycle-accurate simulator
# ---------------------------------------------------------------------------

# the CPU parity tests' configs (tests/test_torch_sim_core.py): a dense
# alpha = 1 schedule for each algorithm, ORIGINAL helping, 8-byte blocks
# (false sharing), the pinned ORIGINAL crash, a long alpha = 0 one
SIM_CASES = (
    ("ours", dict(n_threads=4, n_words=64, k=3, n_steps=1200, max_ops=32,
                  seed=3, alpha=1.0)),
    ("ours_df", dict(n_threads=4, n_words=64, k=3, n_steps=1200,
                     max_ops=32, seed=3, alpha=1.0)),
    ("original", dict(n_threads=8, n_words=32, k=2, n_steps=3000,
                      max_ops=32, seed=7, alpha=1.0)),
    ("pcas", dict(n_threads=4, n_words=64, k=1, n_steps=1200, max_ops=32,
                  seed=3, alpha=1.0)),
    ("ours", dict(n_threads=8, n_words=512, k=1, n_steps=3000, max_ops=128,
                  seed=7, alpha=1.0, block_bytes=8)),
    ("original", dict(n_threads=6, n_words=32, k=2, n_steps=600,
                      max_ops=16, seed=8016, alpha=1.0)),
    ("ours_df", dict(n_threads=4, n_words=256, k=3, n_steps=4000,
                     max_ops=64, seed=7)),
)
SIM_CUT = 365                        # run_until's cut in the checks
# tests/test_recovery.py::test_crash_exhaustive_prefix: every crash point
# of a 400-step hot schedule over 16 words, per algorithm
CRASH_ALGS = (("ours", 3), ("ours_df", 3), ("original", 2), ("pcas", 1))
CRASH_KW = dict(n_threads=4, n_words=16, n_steps=400, max_ops=32, seed=3,
                alpha=1.0)
# the reference's pinned ORIGINAL fault (ROADMAP Queue 3): the same answer
# from both packages
PIN_CFG = dict(algorithm="original", n_threads=6, n_words=32, k=2,
               n_steps=600, max_ops=16, seed=8016, alpha=1.0)
PIN_STEP, PIN_MSG = 365, "words [15]: recovered=[1] expected=[2]"
# Figs. 9-10 (benchmarks/bench_threads.py:11-32) at the paper's 1e6 words
FIG_THREADS = (1, 4, 8, 16, 32, 56)
FIG_WORDS, FIG_STEPS, FIG_MAX_OPS, FIG_SEED = 1_000_000, 60_000, 512, 11
CLOCK_GHZ = 2.0                      # benchmarks/common.py:17
# dependent 4-byte loads on a step's critical path: the schedule entry,
# the thread's PC, its target index / op index, the target's address, the
# word (its line owner loads beside it)
STEP_DEP_LOADS = 5


def sim_diff(a: dict, b: dict) -> list:
    """The state fields where two host states differ (counters as int64)."""
    bad = []
    for name, x in a.items():
        x, y = np.asarray(x), np.asarray(b[name])
        if name == "counters":
            x, y = x.astype(np.int64), y.astype(np.int64)
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(name)
    return bad


def sim_err(a: dict, b: dict) -> int:
    """The largest absolute difference over every field of two host
    states of one shape (uint32 words compared as integers)."""
    return max(int(np.abs(np.asarray(x).astype(np.int64)
                          - np.asarray(b[name]).astype(np.int64)).max(
                              initial=0))
               for name, x in a.items())


def sim_specs(core, cases=SIM_CASES, cut=SIM_CUT) -> list:
    """Each case drained, and cut at ``cut`` without draining."""
    out = []
    for alg, kw in cases:
        cfg = core.SimConfig(algorithm=alg, **kw)
        out += [(cfg, None, None, True, None), (cfg, None, None, False, cut)]
    return out


def sim_held(core, specs, card_results, what: str) -> int:
    """Run ``specs`` through the plain version and hold every card result
    to it on the whole state and the drain rounds; returns the largest
    absolute difference seen (0: bit for bit)."""
    worst = 0
    for spec, got, want in zip(specs, card_results,
                               core.run_sims(specs, device="cpu")):
        bad = sim_diff(got.state, want.state)
        check(not bad and got.drain_rounds == want.drain_rounds,
              f"{what}: the simulator kernel != plain for "
              f"{spec[0].algorithm} {spec[0]} (cut {spec[4]}) in {bad}, "
              f"drain rounds {got.drain_rounds} / {want.drain_rounds}")
        worst = max(worst, sim_err(got.state, want.state))
    return worst


def sim_kernel_vs_plain(core, sim_kernel, dev) -> int:
    """(a) The kernel against its plain version, bit for bit on the whole
    state: every case of ``SIM_CASES`` drained and cut, all four
    algorithms, in ONE mixed launch; then two of them alone."""
    specs = sim_specs(core)
    before = sim_kernel.pmwcas_sim_cuda.launches
    card = core.run_sims(specs, device=dev)
    check(sim_kernel.pmwcas_sim_cuda.launches == before + 1,
          "the mixed simulations took more than one launch")
    err = sim_held(core, specs, card, "mixed launch")
    for i in (1, 4):
        alone = core.run_sims([specs[i]], device=dev)[0]
        check(not sim_diff(alone.state, card[i].state),
              "a simulation alone != the same in a mixed launch")
    log(f"phase 9: simulator kernel == plain bit for bit on the whole state "
        f"(max abs err {err}) for {len(specs)} simulations "
        f"({len(SIM_CASES)} configs x drained / cut at {SIM_CUT}, four "
        f"algorithms) in one mixed launch; alone == batched")
    return err


def sim_crash_sweep(core, pm, sim_kernel, dev) -> dict:
    """(b) Every crash point 1-399 of ``test_crash_exhaustive_prefix``'s
    schedule for the four algorithms, as simulations of one launch; each
    recovers consistently and equals the plain version; then the pinned
    ORIGINAL example, which must raise the reference's RecoveryError."""
    specs = []
    for alg, k in CRASH_ALGS:
        cfg = core.SimConfig(algorithm=alg, k=k, **CRASH_KW)
        specs += [(cfg, None, None, False, s) for s in range(1, 400)]
    t0 = time.perf_counter()
    card = core.run_sims(specs, device=dev)
    secs = time.perf_counter() - t0
    kernel_ms = sim_kernel.pmwcas_sim_cuda.last_ms
    for spec, r in zip(specs, card):
        core.check_crash_consistency(spec[0], r.state)
    err = sim_held(core, specs, card, "crash sweep")
    pin = core.SimConfig(**PIN_CFG)
    got = core.run_until(pin, PIN_STEP, device=dev)
    want = core.run_until(pin, PIN_STEP, device="cpu")
    check(not sim_diff(got.state, want.state), "pinned case: kernel != plain")
    before = sim_kernel.pmwcas_sim_cuda.launches
    try:
        pm.SimSession().configure(**PIN_CFG).with_device(dev).crash_at(
            PIN_STEP)
        raised = None
    except core.RecoveryError as e:
        raised = str(e)
    check(sim_kernel.pmwcas_sim_cuda.launches == before + 1,
          "SimSession.crash_at did not launch the simulator kernel")
    check(raised is not None and PIN_MSG in raised,
          f"the pinned ORIGINAL crash gave {raised!r}")
    log(f"phase 9: crash sweep, {len(specs)} crash points (1-399 x four "
        f"algorithms) in one launch of {kernel_ms:.3f} ms ({secs:.3f} s "
        f"with set-up and copies): all "
        f"recover consistently, all == plain (max abs err {err}); pinned "
        f"ORIGINAL "
        f"crash@{PIN_STEP}: RecoveryError({raised!r}) as in the reference")
    return dict(points=len(specs), s=secs, pinned=raised,
                kernel_ms=kernel_ms, err=err)


def sim_struct_differential(st, dev, seed: int) -> dict:
    """(c) ``run_struct_differential(hashmap, algorithm="ours")`` on the
    card: kernel == durable, and every round replayed on the simulator
    kernel (one launch a round).  The ops are
    ``test_struct_differential_native_sim_no_shadow_skips``'s (inserts,
    an update, deletes and a re-insert of one key group: three rounds)
    over four key groups."""
    kvops = []
    for base in range(0, 96, 24):
        kvops += [st.KVOp(st.INSERT, base + k, ((base + k) << 8) | 1)
                  for k in (2, 6, 10, 14)]
        kvops += [st.KVOp(st.UPDATE, base + 2, 123456 + base + seed),
                  st.KVOp(st.DELETE, base + 6),
                  st.KVOp(st.INSERT, base + 18, 7),
                  st.KVOp(st.DELETE, base + 10),
                  st.KVOp(st.INSERT, base + 6, 999 + base)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sim_diff_") as root:
        rep = st.run_struct_differential(kvops, 64, algorithm="ours",
                                         durable_root=root, device=dev)
    check(rep.agree and rep.sim_rounds_checked > 0,
          "hash-map differential with the simulator:\n" + rep.summary())
    log(f"phase 9: run_struct_differential(hashmap, algorithm=ours) on the "
        f"card over {len(kvops)} ops: agree, {rep.sim_rounds_checked} "
        f"rounds checked on the simulator kernel, {rep.sim_rounds_skipped} "
        f"skipped")
    return dict(checked=rep.sim_rounds_checked,
                skipped=rep.sim_rounds_skipped)


def fig_specs(core, pm) -> list:
    """Figs. 9-10: threads x alpha; k = 3 x {ours, ours_df, original}, k =
    1 x {ours, ours_df, original, pcas}; drained runs, as ``run_cell``."""
    specs = []
    for fig, k, algs in ((9, 3, (pm.OURS, pm.OURS_DF, pm.ORIGINAL)),
                         (10, 1, (pm.OURS, pm.OURS_DF, pm.ORIGINAL,
                                  pm.PCAS))):
        for alpha in (0.0, 1.0):
            for t in FIG_THREADS:
                for alg in algs:
                    cfg = core.SimConfig(
                        algorithm=alg.name, n_threads=t, k=k,
                        n_words=FIG_WORDS, alpha=alpha, n_steps=FIG_STEPS,
                        max_ops=FIG_MAX_OPS, seed=FIG_SEED)
                    specs.append((f"fig{fig}_{alg.name}_t{t}_a{alpha:g}",
                                  (cfg, None, None, True, None)))
    return specs


def sim_bytes(cfg, state) -> int:
    """Bytes one drained simulation must move at least: every word its
    threads' ops touched (cache and pmem, read and written), the owner of
    every distinct line touched (read and written: the touched words'
    lines and, but for PCAS, which keeps no descriptor, the descriptor
    line of each thread that ran), the schedule, those ops' address and
    desired rows, and the per-thread registers, descriptors and counters
    read and written once."""
    ops, op_idx = np.asarray(state["ops"]), np.asarray(state["op_idx"])
    counters = np.asarray(state["counters"])
    rows = [ops[t, :min(int(op_idx[t]) + 1, cfg.max_ops)].reshape(-1)
            for t in range(cfg.n_threads)]
    words = np.unique(np.concatenate(rows).astype(np.int64))
    ran = sum(1 for t in range(cfg.n_threads)
              if int(op_idx[t]) > 0 or counters[t].any())
    lines = np.unique(words // cfg.words_per_line).size + (
        0 if cfg.algorithm == "pcas" else ran)
    n_rows = sum(r.size for r in rows)
    per_thread = sum(np.asarray(v).nbytes for name, v in state.items()
                     if name not in ("cache", "pmem", "line_owner", "ops",
                                     "ops_des"))
    return (words.size * 16 + lines * 8 + 4 * cfg.n_steps + 8 * n_rows
            + 2 * per_thread)


def sim_grid(core, pm, sim_kernel, pm_kernel, dev, seed: int) -> dict:
    """(d) The Figs. 9-10 grid at 1,000,000 words in ONE launch: modeled
    Mops at 2 GHz, CAS / flush / invalidations per op and p99 per cell;
    the zero-conflict counts at one thread; four full-size cells (t = 56,
    alpha = 1, one per algorithm) held to the plain version, whose time
    per step is extrapolated to the grid; one simulation alone for the
    time per step beside the latency floor."""
    named = fig_specs(core, pm)
    specs = [s for _, s in named]
    t0 = time.perf_counter()
    results = core.run_sims(specs, device=dev)
    wall = time.perf_counter() - t0
    grid_ms = sim_kernel.pmwcas_sim_cuda.last_ms
    grid_steps = sim_kernel.pmwcas_sim_cuda.last_steps
    cells = {}
    for (name, spec), r in zip(named, results):
        secs = r.wall_cycles / (CLOCK_GHZ * 1e9)
        cells[name] = dict(
            mops=r.ops_completed / secs / 1e6 if secs > 0 else 0.0,
            cas=r.per_op(pm.CNT_CAS), flush=r.per_op(pm.CNT_FLUSH),
            inval=r.per_op(pm.CNT_INVAL),
            p99=r.percentile_latency_cycles(99), ops=r.ops_completed)
        check(r.ops_completed > 0, f"{name} completed no op")
        log(f"phase 9: {name}: {cells[name]['mops']:.3f} Mops "
            f"(modeled at {CLOCK_GHZ:g} GHz), {cells[name]['ops']} ops, "
            f"cas/op {cells[name]['cas']:.4f}, flush/op "
            f"{cells[name]['flush']:.4f}, inval/op {cells[name]['inval']:.4f},"
            f" p99 {cells[name]['p99']:.1f} cycles/op")
    # zero-conflict counts (tests/test_pmwcas_core.py): one thread
    for alg in pm.STRATEGIES:
        for k in (3, 1):
            name = f"fig{9 if k == 3 else 10}_{alg.name}_t1_a0"
            if name not in cells:
                continue
            want = alg.cas_per_op(k) + (1 if alg is pm.ORIGINAL else 0)
            check(abs(cells[name]["cas"] - want) <= 0.01,
                  f"{name}: {cells[name]['cas']} CAS per op, not {want}")
    ratio = (cells["fig9_ours_t56_a1"]["mops"]
             / cells["fig9_original_t56_a1"]["mops"])
    # four full-size cells on the plain version
    held = {}
    plain_s = plain_steps = worst = 0
    for name in ("fig9_ours_t56_a1", "fig9_ours_df_t56_a1",
                 "fig9_original_t56_a1", "fig10_pcas_t56_a1"):
        i = [n for n, _ in named].index(name)
        cfg = specs[i][0]
        job = core_job(core, cfg)
        t1 = time.perf_counter()
        out = core.sim.run_jobs([job])[0]
        plain_s += time.perf_counter() - t1
        plain_steps += int(out[sim_kernel.O_STEPS])
        plain = core.state_to_arrays(job.state)
        bad = sim_diff(results[i].state, plain)
        worst = max(worst, sim_err(results[i].state, plain))
        check(not bad and results[i].drain_rounds ==
              int(out[sim_kernel.O_ROUNDS]),
              f"{name}: the grid's kernel result != plain in {bad}")
        held[name] = int(out[sim_kernel.O_STEPS])
    plain_us_step = plain_s / plain_steps * 1e6
    plain_grid_ms = plain_us_step * grid_steps / 1e3
    # one simulation alone: its time per step beside the latency floor
    alone = core.run_sims([specs[[n for n, _ in named].index(
        "fig9_ours_t56_a1")]], device=dev)[0]
    alone_ms = sim_kernel.pmwcas_sim_cuda.last_ms
    alone_steps = sim_kernel.pmwcas_sim_cuda.last_steps
    check(not sim_diff(alone.state, results[[n for n, _ in named].index(
        "fig9_ours_t56_a1")].state),
        "the t56 ours cell alone != in the grid's launch")
    step_us = alone_ms * 1e3 / alone_steps
    # the latency of one dependent load (the PMwCAS kernel's probe): the
    # simulator's own kind (L1 cached) through a 16 KiB chain, and L2's
    # (__ldcg) through a 4 MiB one; each the slope over `trips` loads of
    # the device time per launch (profiler: stream time between launches
    # issued from Python holds the host's launch gaps, which can hide a
    # short probe), else of the stream time
    gen = torch.Generator(device=dev).manual_seed(seed)
    out1 = torch.empty(1, dtype=torch.int32, device=dev)
    trips, lat = 1024, {}
    for what, n in (("l1", 1 << 12), ("l2", 1 << 20)):
        chain = torch.randint(0, n, (n,), dtype=torch.int32, device=dev,
                              generator=gen)
        probes = {m: (lambda m=m: pm_kernel.latency_probe(
            chain, out1, m, l1=what == "l1")) for m in (0, trips)}
        us = {m: _per_launch_us(fn, 20, "latency")[0]
              for m, fn in probes.items()}
        if None in us.values():
            us = {m: _event_ms(fn, 20) * 1e3 for m, fn in probes.items()}
        lat[what] = (us[trips] - us[0]) / trips
    load_us = lat["l1"]
    floor_us = STEP_DEP_LOADS * load_us
    n_bytes = sum(sim_bytes(s[0], r.state) for s, r in zip(specs, results))
    bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
    log(f"phase 9: Figs. 9-10 grid, {len(specs)} simulations at "
        f"{FIG_WORDS} words, {FIG_STEPS} steps, max_ops {FIG_MAX_OPS}, seed "
        f"{FIG_SEED}, drained: ONE launch, {grid_ms:.3f} ms of stream time "
        f"(CUDA events) for {grid_steps} steps ({wall:.3f} s wall with "
        f"state set-up and copies); plain version {plain_us_step:.3f} us a "
        f"step over four full-size cells ({plain_steps} steps, "
        f"{plain_s:.3f} s; each == the grid's kernel result bit for bit), "
        f"so the grid extrapolates to {plain_grid_ms:.1f} ms on the plain "
        f"version; ours/original at t = 56, alpha = 1: {ratio:.4f}x Mops")
    log(f"phase 9: one simulation alone (fig9_ours_t56_a1): "
        f"{alone_ms:.3f} ms for {alone_steps} steps = {step_us:.4f} us a "
        f"step; latency floor {STEP_DEP_LOADS} dependent loads x "
        f"{load_us:.4f} us (an L1 hit: the probe's slope of device time "
        f"over {trips} dependent 4-byte loads through a 16 KiB chain) = "
        f"{floor_us:.4f} "
        f"us ({STEP_DEP_LOADS * lat['l2']:.4f} us with every load from L2, "
        f"{lat['l2']:.4f} us each); the grid's bytes bound "
        f"{bound_ms * 1e3:.3f} us ({n_bytes} bytes at "
        f"{H100_BYTES_PER_S:.3g} B/s)")
    return dict(cells=len(specs), grid_ms=grid_ms, grid_steps=grid_steps,
                wall_s=wall, plain_us_step=plain_us_step,
                plain_grid_ms=plain_grid_ms, held=held, ratio=ratio,
                step_us=step_us, alone_steps=alone_steps, err=worst,
                load_us=load_us, l2_load_us=lat["l2"], floor_us=floor_us,
                bound_ms=bound_ms,
                n_bytes=n_bytes,
                t56_a1={n: cells[n] for n in cells if n.endswith("t56_a1")})


def core_job(core, cfg):
    """A drained job of ``cfg`` on CPU tensors, for the plain driver."""
    from repro_torch.kernels.pmwcas_sim.kernel import SimJob
    return SimJob(cfg, core.init_state(cfg, device="cpu"),
                  core.generate_schedule(cfg), drain=True)


def sim_phase(core, pm, st, sim_kernel, pm_kernel, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    sim_kernel.reset_counts()
    err = sim_kernel_vs_plain(core, sim_kernel, dev)
    crash = sim_crash_sweep(core, pm, sim_kernel, dev)
    diff = sim_struct_differential(st, dev, seed)
    before = sim_kernel.pmwcas_sim_cuda.launches
    grid = sim_grid(core, pm, sim_kernel, pm_kernel, dev, seed)
    launches = sim_kernel.pmwcas_sim_cuda.launches
    check(launches - before == 2, "the grid and the cell alone took "
          f"{launches - before} launches, not 2")
    log("kernels: " + json.dumps({"pmwcas_sim phase 9": launches}))
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return dict(err=max(err, crash["err"], grid["err"]), crash=crash,
                differential=diff, grid=grid, launches=launches)


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
        from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
        import repro_torch.core as core
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
    build_kernels([kernel.build, sim_kernel.build]
                  + [functools.partial(fa_kernel.build, r)
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
    durable = durable_phase(pm, svc_mod, st, obs, kernel, dev, args.seed)
    log("durable: " + json.dumps({
        "differential": durable["differential"],
        "ycsb": durable["ycsb"],
        "ledger": durable["ledger"]}))
    tree = tree_phase(pm, ref, svc_mod, st, obs, kernel, dev, args.seed)
    log("tree: " + json.dumps(tree, default=str))
    sim = sim_phase(core, pm, st, sim_kernel, kernel, dev, args.seed)
    grid = sim["grid"]
    log("sim: " + json.dumps(sim, default=str))
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
        "launches": run["launches"],
        "differential_launches": durable["differential"]["launches"],
        "differential_route_launches": durable["differential"]["routes"],
        "max_abs_err": worst,
        "ms": t["ms"], "global_route_ms": t["global_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "latency_floor_ms": t["floor_ms"],
        "wave_dispatch_device_us": run["wave_split"]["dispatch"],
        "tree_launches": tree["run"]["launches"],
        "tree_route_launches": tree["run"]["routes"],
        "tree_gc_route_launches": tree["run"]["gc_routes"],
        "tree_global_ms": {str(K): t["ms"]
                           for K, t in tree["timings"].items()},
        "tree_global_plain_ms": {str(K): t["plain_ms"]
                                 for K, t in tree["timings"].items()},
        "tree_global_bound_ms": {str(K): t["bound_ms"]
                                 for K, t in tree["timings"].items()},
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
        "library_ms": pre["library_ms"]}, {
        "name": "pmwcas_sim", "route": "cuda",
        "source": "src/repro_torch/csrc/pmwcas_sim.cu",
        "replaces": "src/repro/core/sim.py:175",
        "launches": sim["launches"], "grid_launches": 1,
        "differential_launches": durable["differential"]["sim_launches"],
        "tree_sim_launches": tree["differential"]["sim_launches"],
        "max_abs_err": sim["err"],
        "ms": grid["grid_ms"], "grid_cells": grid["cells"],
        "grid_steps": grid["grid_steps"],
        "plain_ms": grid["plain_grid_ms"],
        "plain_ms_is": "extrapolated from four full-size cells",
        "plain_us_step": grid["plain_us_step"],
        "bound_ms": grid["bound_ms"], "bound_by": "bytes",
        "step_us": grid["step_us"], "step_floor_us": grid["floor_us"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
