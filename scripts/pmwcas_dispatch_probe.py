#!/usr/bin/env python3
"""Device and host time of the KV service's stacked dispatch, per wave.

Drives ``repro_torch.service.KVService`` at the ycsb cell's shape (4
shards of 1,048,576 words, ``round_cap`` 1024, windows of 4,096
submissions of YCSB-A: 50% read, 50% update, Zipfian 0.99) on one CUDA
card, and reports over a profiled window of waves:

- device µs per wave by op name (``torch.profiler``), grouped as the
  dispatch's own ops (the PMwCAS kernel, host-to-device copies, the
  verdict's copy to the host when it goes to pinned memory) and the
  rest (the hash map snapshot's table copies among it);
- host µs per wave of the ``executor.stacked_dispatch`` span (span
  tracer, over a second window with tracing on).

``--src`` names the ``src`` directory of the tree to probe, so two trees
can be compared in one run on one card (parent, change, change, parent)::

    python3 scripts/pmwcas_dispatch_probe.py --src src
    python3 scripts/pmwcas_dispatch_probe.py --src /path/to/parent/src

The last line of standard output is one JSON object with the numbers.
Fewer records than the cell's 1,048,576 are loaded (``--records``), into
tables of the cell's width: a wave's dispatch moves the same bytes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time


def _profile_waves(svc, arrivals, window):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    steps0 = svc.stats.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _drive(svc, arrivals, window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            count[e.name] = count.get(e.name, 0) + 1
    return by_name, count, svc.stats.steps - steps0, wall


def _drive(svc, arrivals, window):
    for start in range(0, len(arrivals), window):
        for c, op in arrivals[start:start + window]:
            svc.submit(op, client=c)
        svc.step()
    while svc.pending_count:
        svc.step()


def _arrivals(streams):
    return [(c, s[i]) for i in range(max(map(len, streams)))
            for c, s in enumerate(streams) if i < len(s)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src",
                    help="the src directory of the tree to probe")
    ap.add_argument("--records", type=int, default=1 << 16)
    ap.add_argument("--ops", type=int, default=1 << 14,
                    help="YCSB-A ops in each measured window")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("pmwcas_dispatch_probe: needs a CUDA card", file=sys.stderr)
        return 2
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch.obs as obs
    import repro_torch.service as svc_mod
    import repro_torch.structures as st

    shards, round_cap, n_buckets = 4, 1024, 1 << 19   # 2 x 2^19 words
    window = shards * round_cap
    spec = st.WorkloadSpec(n_ops=args.ops, n_keys=args.records, read=0.5,
                           update=0.5, insert=0.0, delete=0.0, alpha=0.99,
                           seed=args.seed)
    svc = svc_mod.KVService(shards, structure="hashmap",
                            n_buckets=n_buckets, round_cap=round_cap,
                            device="cuda")
    _drive(svc, [(0, op) for op in st.load_phase(spec, 1.0)], window)
    _drive(svc, _arrivals(st.client_streams(spec, 8)), window)    # warm
    svc.reset_stats()

    runs = {}
    for seed in (1, 2):
        streams = st.client_streams(
            dataclasses.replace(spec, seed=args.seed + seed), 8)
        runs[seed] = _profile_waves(svc, _arrivals(streams), window)
    by_name, count, waves, wall = runs[1]
    by_name2, _, waves2, _ = runs[2]

    groups = {"kernel": ("pmwcas_apply",), "upload": ("Memcpy HtoD",),
              "verdict": ("Memcpy DtoH (Device -> Pinned)",),
              "stack": ("CatArrayBatchedCopy", "cat_", "stack")}
    per = {k: 0.0 for k in (*groups, "rest")}
    for name, us in by_name.items():
        key = next((k for k, pats in groups.items()
                    if any(p in name for p in pats)), "rest")
        per[key] += us / waves
    per["dispatch"] = sum(per[k] for k in groups)
    busy2 = sum(by_name2.values()) / waves2

    tracer = obs.get_tracer()
    tracer.clear()
    obs.enable_tracing()
    try:
        streams = st.client_streams(
            dataclasses.replace(spec, seed=args.seed + 3), 8)
        steps0 = svc.stats.steps
        _drive(svc, _arrivals(streams), window)
        traced_waves = svc.stats.steps - steps0
        spans = {}
        for ev in tracer.events():
            if ev["ph"] == "X":
                spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    finally:
        obs.disable_tracing()
        tracer.clear()
    svc.check_integrity()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(f"src {src}: {waves} profiled waves, {wall:.3f} s wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / waves:12.3f} us/wave  {count[name] / waves:6.2f}"
              f"/wave  {name[:90]}")
    out = {"src": str(src), "card": smi, "waves": waves,
           "device_us_per_wave": {k: round(v, 3) for k, v in per.items()},
           "busy_us_per_wave": round(sum(by_name.values()) / waves, 3),
           "busy_us_per_wave_second_window": round(busy2, 3),
           "host_us_per_wave": {
               k: round(spans.get(k, 0.0) / traced_waves, 1)
               for k in ("executor.stacked_dispatch", "wave.dispatch",
                         "service.wave")}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
