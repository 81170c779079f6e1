#!/usr/bin/env python3
"""Run cells across four cards: chip_smoke.py's phases 17 (b) and 18 (b).

``chip_smoke.mesh_cells`` (phase 17 (b)): four processes, one a card, joined over NCCL,
run llama3-8b at its published size through ``build_cell`` on two
meshes over ``("data", "model")``: ``prefill_32k_llama3_8b_B32_4x1`` (32
prompts of 32,768 tokens; FSDP and the batch over ``data``) and
``decode_32k_llama3_8b_B32_1x4`` (32 requests over a 32,768-position
cache of seeded bf16; heads, the MLP's width and the vocabulary over
``model``).  Each rank's held bytes against the dry run's, its peak
memory, the prefill's seconds and the decode step's ms (median of 5),
the time in the collectives, the collectives issued against the dry
run's trace, each rank's flash launches by route and its flash call
timed beside SDPA; rank 0's logits against one card's on the gathered
weights, and the planted faults.

``chip_smoke.jamba_mesh_cells`` (phase 18 (b)): four processes run
jamba-v0.1 at its published 32 layers on ``(1, 4)`` (experts, Mamba's
inner channels and the heads over ``model``), each rank's weights drawn
one parameter at a time and cut: ``decode_32k_jamba_v01_52b_B128_1x4``,
``long_500k_jamba_v01_52b_B1_1x4`` and
``prefill_32k_jamba_v01_52b_B8_1x4``; each rank's held bytes against the
table's, its collectives against the trace, its flash launches by route
and split count, the prefill's seconds and the decode steps' ms (median
of 5) against each cell's bound; then each cell at one unit, rank 0
against one card's step in bf16 and f32, and the planted faults::

    python3 scripts/mesh_cell.py [--small] [--seed N]

``--small`` runs the same meshes at llama3-8b's smoke config (bf16 at
head_dim 128, 4 kv heads; 8 x 256 tokens, 8 requests over 512
positions) and jamba's (bf16 at head_dim 128, 4 kv heads, 8 experts;
``chip_smoke.JAMBA_SMALL``).  Builds the flash kernels into ``build/`` first; needs four
CUDA cards.  Prints the card's name and power limit, the phases' lines
and one ``MESH {...}`` line.  Rehearse on the CPU with
``chip_smoke.mesh_cells(0, small=True, device="cpu")`` (four gloo ranks,
~20 s) and ``chip_smoke.jamba_mesh_cells(0, small=True, device="cpu")``
(~210 s: bf16 on the CPU; the route checks need the card; call it from
a script file, which the ranks' ``spawn`` re-imports).
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the smoke config instead of the published size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    if not torch.cuda.is_available():
        print("mesh_cell: needs CUDA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < smoke.MESH_RANKS:
        print(f"mesh_cell: needs {smoke.MESH_RANKS} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smoke.log(smoke.card_line())
    smoke.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}")
    smoke.build_kernels([functools.partial(fa_kernel.build, r)
                         for r in fa_kernel.ROUTES])
    out = {"phase 17": smoke.mesh_cells(args.seed, small=args.small),
           "phase 18": smoke.jamba_mesh_cells(args.seed, small=args.small)}
    print("MESH " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
