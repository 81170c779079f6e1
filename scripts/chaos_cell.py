#!/usr/bin/env python3
"""Run chip_smoke.py's chaos phase (phase 10) alone.

``chip_smoke.chaos_phase``: the seven chaos families on the card at the
reference bench's full setting (``default_scenarios(0, 60)``), the
kernel-shard storm and ``sim_native`` held to CPU runs of the port, with
the smoke's checks, at the smoke's own constants::

    python3 scripts/chaos_cell.py

Builds the PMwCAS and simulator kernels into ``build/`` first, so no
``nvcc`` run falls inside a timed scenario.  Prints the smoke's phase 10
lines and one ``CHAOS {...}`` line.  This is no smoke: it prints no
kernels line and no ok line.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    import torch
    import repro_torch.chaos as chaos
    import repro_torch.obs as obs
    from repro_torch.kernels.pmwcas_apply import kernel
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    if not torch.cuda.is_available():
        print("chaos_cell: needs a CUDA card", file=sys.stderr)
        return 2
    smoke.build_kernels([kernel.build, sim_kernel.build])
    out = smoke.chaos_phase(chaos, obs, kernel, sim_kernel,
                            torch.device("cuda"), 0)
    print("CHAOS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
