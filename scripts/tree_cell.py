#!/usr/bin/env python3
"""Run chip_smoke.py's range-index phase (phase 8) alone.

``chip_smoke.tree_phase``: BzTree kernel shards loaded and driven by
YCSB-E, launches by route against the splits, GC, the ``global`` route
at the tree's widths, the tree differential and ``BatchScheduler`` on
the card against the CPU.  ``--records`` sizes the cell (default the
smoke's ``TREE_RECORDS``), for sizing it against the phase's budget::

    python3 scripts/tree_cell.py --records 65536

Builds only the PMwCAS kernel, into ``build/``.  Prints the smoke's
phase 8 lines and one ``TREE {...}`` line.  This is no smoke: it prints
no kernels line and no ok line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=smoke.TREE_RECORDS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import repro_torch.obs as obs
    import repro_torch.pmwcas as pm
    import repro_torch.service as svc_mod
    import repro_torch.structures as st
    from repro_torch.kernels.pmwcas_apply import kernel, ref
    smoke.build_kernels([kernel.build])
    tree = smoke.tree_phase(pm, ref, svc_mod, st, obs, kernel,
                            torch.device("cuda"), args.seed, args.records)
    print("TREE " + json.dumps(tree, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
