#!/usr/bin/env python3
"""Run chip_smoke.py's cell-program phase (phase 16) alone.

``chip_smoke.cells_phase`` at the smoke's constants: the dry run of every
(arch x shape) cell on the two production meshes and the host mesh,
``prefill_32k_llama3_8b_B1`` and ``decode_32k_llama3_8b_B8`` through
``build_cell`` on the card, and the flash call of each held to its plain
version and timed; then ``build_cell``'s small prefill and decode card
against CPU (f32 and bf16)::

    python3 scripts/cells_cell.py

Builds the flash kernels into ``build/`` first.  Prints the smoke's phase
16 lines and one ``CELLS {...}`` line.  This is no smoke: it prints no
kernels line and no ok line.  Needs a CUDA card.
"""
from __future__ import annotations

import functools
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if not torch.cuda.is_available():
        print("cells_cell: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(smoke.card_line())
    smoke.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    smoke.build_kernels([functools.partial(fa_kernel.build, r)
                         for r in fa_kernel.ROUTES])
    dev = torch.device("cuda")
    small = {f"{mode}_{dtype}": smoke.cell_small_vs_cpu(
        get_config, fa_kernel, dev, 0, mode, dtype)
        for mode in ("prefill", "decode")
        for dtype in ("float32", "bfloat16")}
    out = smoke.cells_phase(fa_ref, fa_kernel, dev, 0)
    out["small"] = small
    print("CELLS " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
