#!/usr/bin/env python3
"""Device time of the PMwCAS kernel's ``global`` route at wide rows.

The BzTree path sends a split's materialization (132-135 words at node
caps of 64) and a region GC's zeroing op (up to 390 words) to the
``global`` route as ``[1, 1, K]`` launches, which take one thread per
slot in rounds of at most 32 rows.  This times the route at those
widths, at 8, 32 and 33 rows of 132 slots (either side of that choice),
at the durable differential's ``[1, 512, 32]`` (one thread per row) and
at ``[4, 1024, 2]`` (a control: a path the change leaves alone), on
tables of the tree cell's width (1,597,442 words a shard): live
words, expected == current and desired == expected, so every launch
does the same full work.  Each shape is checked once against the plain
version (bit for bit), then timed per launch with the profiler (CUDA
events where the profiler shows no device time).

Each source tree runs in a fresh process that imports its own
``src/repro_torch`` and builds its kernel into its own ``build/``, so
two versions compare on one card in turns::

    python3 scripts/pmwcas_wide_probe.py baseline/parent . . baseline/parent

Every run prints one ``WIDE {...}`` line: µs per launch by shape.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

SHAPES = ((1, 1, 132), (1, 1, 390), (1, 8, 132), (1, 32, 132), (1, 33, 132),
          (1, 512, 32), (4, 1024, 2))
WORDS = 1_597_442                    # a shard of the tree cell (PERF.md §4)


def _per_launch_us(fn, iters: int):
    """Device µs per launch of the PMwCAS kernels ``iters`` calls of
    ``fn`` enqueue (profiler), or None when the trace shows none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and "pmwcas_apply" in e.name]
    return sum(us) / len(us) if us else None


def _event_us(fn, iters: int) -> float:
    import torch
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def run_one(tree: pathlib.Path, seed: int) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.pmwcas_apply import kernel, ref
    from repro_torch.pmwcas import words_to_tensor
    if not pathlib.Path(kernel.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernel.__file__}, not {tree}'s")
    kernel.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = {}
    for S, B, K in SHAPES:
        host = rng.integers(1, 1 << 32, (S, WORDS),
                            dtype=np.uint64).astype(np.uint32)
        addr = np.stack([rng.choice(WORDS, B * K, replace=False)
                         for _ in range(S)]).reshape(S, B, K)
        addr = np.sort(addr, axis=2).astype(np.int32)
        exp = np.take_along_axis(host, addr.reshape(S, -1),
                                 1).reshape(addr.shape)
        words = words_to_tensor(host, dev)
        a, e = (words_to_tensor(x, dev) for x in (addr, exp))
        d = e.clone()
        claim = kernel.claim_scratch(words)
        success = torch.empty((S, B), dtype=torch.bool, device=dev)
        w_p = words.clone()
        s_k = kernel.pmwcas_apply_cuda(words, a, e, d, route="global",
                                       claim=claim)
        _, s_p = ref.pmwcas_apply_stacked(w_p, a, e, d)
        torch.cuda.synchronize()
        if not (bool(s_k.all()) and torch.equal(s_k, s_p)
                and torch.equal(words, w_p)):
            raise SystemExit(f"[{S}, {B}, {K}]: kernel != plain")

        def run():
            kernel.launch(words, a, e, d, success, route="global",
                          claim=claim)

        us = _per_launch_us(run, 200)
        out[f"{S}x{B}x{K}"] = dict(
            us=us if us is not None else _event_us(run, 200),
            source="profiler" if us is not None else "CUDA events",
            event_us=_event_us(run, 200))
        del words, w_p, claim
    print("WIDE " + json.dumps({"tree": str(tree), "us": out}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path,
                    help="source trees, run in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true",
                    help="run a single tree in this process")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pmwcas_wide_probe: needs a CUDA card", file=sys.stderr)
        return 2
    if args.one:
        run_one(args.trees[0].resolve(), args.seed)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in args.trees:
        rc = subprocess.run([sys.executable, __file__, "--one", "--seed",
                             str(args.seed), str(tree)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
