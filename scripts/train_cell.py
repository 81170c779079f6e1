#!/usr/bin/env python3
"""Run chip_smoke.py's training phase (phase 11) alone.

``chip_smoke.train_phase`` at the smoke's constants: the flash kernel's
training launch (with the log-sum-exp) against its plain version, small
training card against CPU, the full-width cell
``train_llama3_8b_L8_s4096`` and the ``Trainer``'s crash and restart::

    python3 scripts/train_cell.py

Builds the flash kernels into ``build/`` first.  Prints the smoke's
phase 11 lines and one ``TRAIN {...}`` line.  This is no smoke: it
prints no kernels line and no ok line.  Needs a CUDA card.
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
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if not torch.cuda.is_available():
        print("train_cell: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.build_kernels([functools.partial(fa_kernel.build, r)
                         for r in fa_kernel.ROUTES])
    out = smoke.train_phase(fa_kernel, fa_ref, torch.device("cuda"), 0)
    print("TRAIN " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
