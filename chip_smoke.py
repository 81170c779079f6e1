#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. card and build — the card's name and power limit, then the Hopper
   kernel built from ``src/repro_torch/csrc/pmwcas_apply.cu`` (seconds);
2. kernel vs plain — the kernel's verdicts and tables held bit for bit
   against its plain PyTorch version on the card, over seeded
   ``[S, B, K]`` batches (S in {1, 4}, B in {1, 7, 1024}, K in
   {1, 2, 8}; uniform and Zipf-hot addresses; all-padded rows,
   duplicate ids, (a)-passing rows that lose and still block),
   ``reserve_slots``' corner cases and ``sequential_oracle``
   containment; then the service on the card against the service on the
   CPU at a small size;
3. the slice at full size — ``KVService(n_shards=4, round_cap=1024)``
   with 1,048,576 records (4 x 1,048,576-word tables on the card),
   loaded, then driven by YCSB core workload A (50% read, 50% update,
   Zipfian 0.99) from 8 clients in bounded windows; integrity, the
   acknowledged writes read back, and ``conflict_rate == 0`` are checked;
4. timings — the kernel's and the plain version's time per launch at
   the slice's shape, the per-wave split of a traced window, ops/s and
   p50/p99 latency.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA's H100 SXM data sheet
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


def kernel_vs_plain(pm, ref, seed: int, dev) -> int:
    """Bit-for-bit comparisons on ``dev``; returns the largest absolute
    difference seen (must be 0)."""
    rng = np.random.default_rng(seed)
    worst = 0
    n_cases = 0
    for S in (1, 4):
        for B in (1, 7, 1024):
            for K in (1, 2, 8):
                for hot in (False, True):
                    W = 4096 if hot else 1 << 20
                    words_np = rng.integers(0, 1 << 32, size=(S, W),
                                            dtype=np.uint64).astype(np.uint32)
                    addr, exp, des = _batch(rng, S, B, K, W, hot, words_np)
                    args = [pm.words_to_tensor(a, dev)
                            for a in (addr, exp, des)]
                    w_k = pm.words_to_tensor(words_np, dev)
                    w_p = w_k.clone()
                    _, s_k = pm.pmwcas_apply_stacked(w_k, *args)
                    _, s_p = ref.pmwcas_apply_stacked(w_p, *args)
                    _sync(dev)
                    diff = max(int((s_k.int() - s_p.int()).abs().max()),
                               int((w_k.long() - w_p.long()).abs().max()))
                    worst = max(worst, diff)
                    check(diff == 0, f"kernel != plain at S={S} B={B} K={K} "
                          f"hot={hot}")
                    check(bool(s_k.all(dim=1).logical_not().any())
                          or B < 1024,
                          f"no loser at S={S} B={B} K={K} hot={hot}")
                    check(bool(s_k.any(dim=1).all()) or B < 1024,
                          f"no winner at S={S} B={B} K={K} hot={hot}")
                    n_cases += 1
    log(f"phase 2: kernel == plain bit for bit on {n_cases} [S, B, K] "
        "batches (uniform + Zipf-hot)")

    # (a)-passing rows that lose still block: rows 0,1 pass, 1 loses to 0
    # on word 3, and row 2 (disjoint from 0) loses to row 1
    words = pm.words_to_tensor(np.zeros((1, 16), np.uint32), dev)
    addr = np.asarray([[[0, 3], [3, 4], [4, 5], [6, 7]]], np.int32)
    exp = np.zeros_like(addr, dtype=np.uint32)
    exp[0, 3, 1] = 9                                      # row 3 fails (a)
    des = np.ones_like(addr, dtype=np.uint32)
    _, s = pm.pmwcas_apply_stacked(words, *[pm.words_to_tensor(a, dev)
                                            for a in (addr, exp, des)])
    check(s.cpu().tolist() == [[True, False, False, False]],
          f"blocking semantics broken: {s.cpu().tolist()}")

    # reserve_slots' corner cases (tests/test_kernels.py), kernel == plain
    # == the expected verdicts
    cases = [
        ([[3, 3, 5, -1]], None, [True]),                  # duplicate ids
        ([[-1, -1, -1], [0, 1, -1]], None, [True, True]),  # all-padded
        ([[0, 1, 2, 3], [3, 4, 5, 6], [7, 8, 9, 10], [4, 5, 11, 12]], None,
         [True, False, True, False]),                    # lower index wins
        ([[1, 2, -1]], 2, [False]),                       # already claimed
    ]
    for reqs, taken, want in cases:
        free = np.ones(16, np.uint32)
        if taken is not None:
            free[taken] = 0
        reqs = np.asarray(reqs, np.int32)
        m_k = pm.words_to_tensor(free, dev)
        m_p = m_k.clone()
        r = pm.words_to_tensor(reqs, dev)
        _, g_k = pm.reserve_slots(m_k, r)
        _, g_p = ref.pmwcas_apply(m_p, r, torch.ones_like(r),
                                  torch.zeros_like(r))
        check(g_k.cpu().tolist() == g_p.cpu().tolist() == want,
              f"reserve_slots {reqs.tolist()}: {g_k.cpu().tolist()}")
        check(torch.equal(m_k, m_p), f"reserve_slots mask {reqs.tolist()}")
    log("phase 2: reserve_slots corner cases agree (kernel == plain == "
        "expected)")

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
    kernel.pmwcas_apply_cuda.launches = 0     # count the main path only
    t0 = time.perf_counter()
    run_futs = drive(svc, arrivals, window)
    _sync(dev)
    run_s = time.perf_counter() - t0
    launches = kernel.pmwcas_apply_cuda.launches
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
    log("phase 3: integrity ok, acknowledged writes read back, "
        "conflict_rate 0")
    log("kernels: " + json.dumps({"pmwcas_apply": launches}))

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
    busy_us, wall_us = _device_us(lambda: drive(svc, profiled, window))
    log("phase 4: device busy " + ("not measured" if busy_us is None else
        f"{busy_us:.1f} us of {wall_us:.1f} us wall over {len(profiled)} "
        f"ops: idle share {1 - busy_us / wall_us:.4f} (profiler)"))
    log(f"phase 4: per-wave host split over {split.waves} traced waves "
        f"({len(traced)} ops, {traced_s:.3f} s, tracing on), us/wave: "
        + json.dumps({k: round(v, 1) for k, v in per_wave.items()}))
    svc.check_integrity()
    return dict(launches=launches, ops_per_s=len(arrivals) / run_s,
                load_s=load_s, run_s=run_s, stats=stats, svc=svc)


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


def _device_us(fn, iters: int = 1):
    """Device time (µs) of every kernel, copy and fill ``fn`` enqueues,
    summed over ``iters`` calls, and the host wall time (µs) of those
    calls, from the profiler's CUDA activity trace.  Device time is None
    when the trace shows none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return (busy if busy > 0 else None), wall_us


def kernel_timings(pm, ref, kernel, svc, seed: int, dev):
    """Kernel and plain version per launch on an update wave of the
    slice's shape: 4 shards x 1024 rows x 2 slots against the loaded
    4 x 1,048,576-word tables (each row a live bucket's key guard + value
    word, expected == current, desired == expected so every launch does
    the same full work)."""
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
    claim = pm.claim_scratch(words)
    success = torch.empty((S, ROUND_CAP), dtype=torch.bool, device=dev)
    w_k, w_p = words.clone(), words.clone()
    _, s_k = pm.pmwcas_apply_stacked(w_k, a, e, d, claim=claim)
    _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
    torch.cuda.synchronize()
    check(bool(s_k.all()) and torch.equal(s_k, s_p)
          and torch.equal(w_k, w_p), "timing inputs: kernel != plain")

    def run_kernel():
        kernel.launch(w_k, a, e, d, claim, success)

    def run_plain():
        ref.pmwcas_apply_stacked(w_p, a, e, d)

    # stream time of back-to-back calls (CUDA events), in turns
    plain_ms, kernel_ms, kernel_ms2, plain_ms2 = (
        _event_ms(run_plain, 20), _event_ms(run_kernel, 500),
        _event_ms(run_kernel, 500), _event_ms(run_plain, 20))
    wrapper_ms = _event_ms(
        lambda: pm.pmwcas_apply_stacked(w_k, a, e, d, claim=claim), 200)
    # device time per call (profiler): what the card itself spends
    k_dev, _ = _device_us(run_kernel, 200)
    p_dev, _ = _device_us(run_plain, 20)
    ms = k_dev / 200 / 1e3 if k_dev else min(kernel_ms, kernel_ms2)
    plain = p_dev / 20 / 1e3 if p_dev else min(plain_ms, plain_ms2)
    valid = int((addr >= 0).sum())
    winners = int((np.asarray(s_k.cpu())[..., None] & (addr >= 0)).sum())
    n_bytes = 3 * addr.size * 4 + valid * 4 + winners * 4 + S * ROUND_CAP
    bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
    src = "profiler device time" if k_dev and p_dev else "CUDA events"
    log(f"phase 4: [S, B, K] = [{S}, {ROUND_CAP}, 2], W = {W}: kernel "
        f"{ms * 1e3:.3f} us/launch, plain {plain * 1e3:.3f} us/call "
        f"({src}); stream time back to back (CUDA events): kernel "
        f"{kernel_ms * 1e3:.2f} / {kernel_ms2 * 1e3:.2f} us, checked "
        f"wrapper {wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} / "
        f"{plain_ms2 * 1e3:.2f} us; bound {bound_ms * 1e3:.4f} us "
        f"({n_bytes} bytes at {H100_BYTES_PER_S:.3g} B/s)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound_ms)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every workload and batch (default 0)")
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
        from repro_torch.kernels.pmwcas_apply import kernel
        from repro_torch.kernels.pmwcas_apply import ref
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}:"
              f" {e}", file=sys.stderr)
        return 3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = kernel.build()
    log(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.3f} s")
    report = lib.with_name(lib.name + ".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("phase 1: ptxas " + line.strip())

    dev = torch.device("cuda")
    worst = kernel_vs_plain(pm, ref, args.seed, dev)
    small_service_matches_cpu(svc_mod, st, args.seed, dev)
    run = full_slice(pm, svc_mod, st, obs, kernel, dev, args.seed)
    t = kernel_timings(pm, ref, kernel, run["svc"], args.seed, dev)

    log(card)
    print(json.dumps({"kernels": [{
        "name": "pmwcas_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/pmwcas_apply.cu",
        "replaces": "src/repro/kernels/pmwcas_apply/kernel.py:62",
        "launches": run["launches"], "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
