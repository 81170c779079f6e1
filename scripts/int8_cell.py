#!/usr/bin/env python3
"""Run chip_smoke.py's int8 KV cache phase (phase 15) alone.

``chip_smoke.int8_phase`` at the smoke's constants: ``_quant`` and
``_sdpa_chunked_quant`` card against CPU with planted faults, the
llama3-8b and qwen1.5-32b smoke configs served with an int8 cache card
against CPU, llama3-8b's serve cell with a bf16 and an int8 cache, and
the full-size cell ``serve_qwen15_32b_int8``::

    python3 scripts/int8_cell.py

Builds the PMwCAS and flash kernels into ``build/`` first.  Prints the
smoke's phase 15 lines and one ``INT8 {...}`` line.  This is no smoke:
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
    from repro_torch.kernels.pmwcas_apply import kernel as pm_kernel
    from repro_torch.kernels.pmwcas_apply import ref as pm_ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        print("int8_cell: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(smoke.card_line())
    smoke.build_kernels([pm_kernel.build]
                        + [functools.partial(fa_kernel.build, r)
                           for r in fa_kernel.ROUTES])
    out = smoke.int8_phase(serve_mod, build_model, pm_ref, pm_kernel,
                           fa_kernel, torch.device("cuda"), 0)
    print("INT8 " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
