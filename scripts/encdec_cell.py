#!/usr/bin/env python3
"""Run chip_smoke.py's encoder-decoder and frontend phase (phase 14) alone.

``chip_smoke.encdec_phase`` at the smoke's constants: the flash op at
every call form of the three cells against its plain version with
planted faults and timed beside its bound and SDPA, the seamless and
paligemma smoke configs served and trained card against CPU, and the
full-size cells ``serve_seamless_m4t_medium``, ``serve_paligemma_3b``
and ``train_seamless_m4t_medium_s4096``::

    python3 scripts/encdec_cell.py

Builds the PMwCAS and flash kernels into ``build/`` first.  Prints the
smoke's phase 14 lines and one ``ENCDEC {...}`` line.  This is no smoke:
it prints no kernels line and no ok line.  Needs a CUDA card.
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
    from repro_torch.kernels.pmwcas_apply import kernel as pm_kernel
    from repro_torch.kernels.pmwcas_apply import ref as pm_ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        print("encdec_cell: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(smoke.card_line())
    smoke.build_kernels([pm_kernel.build]
                        + [functools.partial(fa_kernel.build, r)
                           for r in fa_kernel.ROUTES])
    out = smoke.encdec_phase(serve_mod, build_model, fa_ref, fa_kernel,
                             pm_ref, pm_kernel, torch.device("cuda"), 0)
    print("ENCDEC " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
