#!/usr/bin/env python3
"""Run chip_smoke.py's simulator phase (phase 9) alone.

``chip_smoke.sim_phase``: the simulator kernel on both of its routes
(``smem`` by the plan, ``global`` forced) against its plain version on
the whole state, every crash point of a short hot schedule,
``SimBackend``'s mode, the hash-map differential with the simulator, and
the Figs. 9-10 grid at 1,000,000 words in one launch a route with its
five slowest cells, at the smoke's own constants::

    python3 scripts/sim_cell.py

Builds the simulator and PMwCAS kernels (the latter for its latency
probe) into ``build/``.  Prints the smoke's phase 9 lines and one
``SIM {...}`` line.  This is no smoke: it prints no kernels line and no
ok line.  Needs a CUDA card.
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
    import repro_torch.core as core
    import repro_torch.pmwcas as pm
    import repro_torch.structures as st
    from repro_torch.kernels.pmwcas_apply import kernel
    from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
    smoke.build_kernels([kernel.build, sim_kernel.build])
    sim = smoke.sim_phase(core, pm, st, sim_kernel, kernel,
                          torch.device("cuda"), 0)
    print("SIM " + json.dumps(sim, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
