#!/usr/bin/env python3
"""Run chip_smoke.py's ycsb cell from several source trees in turns.

The cell is ``full_slice`` (phase 3 and its traced and profiled
windows); running it from two trees in turns compares two versions on
one card.

Each tree runs in a fresh process that imports the tree's own
``chip_smoke.py`` and ``src/repro_torch`` and builds its PMwCAS kernel
into the tree's ``build/``.  Unpack the parent with ``git archive`` into
an ignored directory and give the trees in turns::

    python3 scripts/ycsb_pairs.py baseline/parent . . baseline/parent

Every run prints the smoke's own phase 3/4 lines (the per-wave host
split among them), then one ``PAIR {...}`` line: ops/s, p50/p99 µs,
waves (through the traced and profiled windows) and kernel launches.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys


def run_one(tree: pathlib.Path, seed: int) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import repro_torch.obs as obs
    import repro_torch.pmwcas as pm
    import repro_torch.service as svc_mod
    import repro_torch.structures as st
    from repro_torch.kernels.pmwcas_apply import kernel
    if not pathlib.Path(kernel.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernel.__file__}, not {tree}'s")
    kernel.build()
    run = smoke.full_slice(pm, svc_mod, st, obs, kernel,
                           torch.device("cuda"), seed)
    stats = run["stats"]
    print("PAIR " + json.dumps({
        "tree": str(tree), "ops_per_s": run["ops_per_s"],
        "p50_us": stats.p50_latency_us, "p99_us": stats.p99_latency_us,
        "waves": stats.steps, "launches": run["launches"]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path,
                    help="source trees, run in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true",
                    help="run a single tree in this process")
    args = ap.parse_args(argv)
    if args.one:
        run_one(args.trees[0].resolve(), args.seed)
        return 0
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              "--seed", str(args.seed), str(tree)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
