"""Dry run: every (arch x shape x mesh) cell's program built on ``meta``
tensors, and the per-device memory its sharding rules give.

The port of ``repro/launch/dryrun.py``.  Nothing is compiled and no step
runs: :func:`~repro_torch.launch.steps.build_cell` builds each cell on
tensors with shapes and dtypes only.  What the port derives exactly is
the per-device argument bytes, from the rules' specs on the mesh: the
parameters, the optimizer state, the cache and the batch.  A serving
cell's parameters are counted in the dtype the port's serving ``Model``
holds them in, ``cfg.dtype`` (bf16; the final norm float32), where the
reference's abstract parameters are its ``param_dtype`` float32; a
training cell's masters and AdamW's moments in float32.  The model FLOPs
follow the reference's formulas (6 N T to train, 2 N T to prefill, 2 N B
a decode step, N the active parameters).

The reference reads FLOPs, bytes accessed, temporary memory and
collective bytes from XLA's compiled program.  The port has no such
compiler: it traces the program instead.  For every cell that runs on a
mesh (the prefill and decode of the dense, MoE and jamba archs where the
heads, widths, experts and Mamba's channels split over the model axis
and no cache spec shards the sequence,
:func:`repro_torch.launch.steps.mesh_refusal`),
:meth:`~repro_torch.launch.steps.CellProgram.trace` runs rank 0's step
on ``meta`` tensors over the cell's mesh, its collectives recorded as
they are issued (kind, count and per-device output bytes, the
reference's output-shape proxy) and its FLOPs counted by
``FlopCounterMode`` (``flops_per_device``; the flash kernel's as a dense
attention's, no causal mask skipped; Mamba's step loop as one product of
the same FLOPs, ``2 B d_in N`` a step).  As the reference's accounting
builds do, the dry run traces the cell at one and at two units and takes
the rest as repeats of the second (every unit issues the same products
and collectives): the full trace's numbers, in a fraction of its time.  Every other cell keeps those
fields ``null``, with a ``null_because`` that names its ROADMAP item;
bytes accessed and temporary memory are ``null`` everywhere (no
compiler).  The roofline terms it prints are named for what they divide:
the model FLOPs by the card's 989 TFLOP/s, the argument bytes by its
3.35 TB/s.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host \\
        [--device cpu]

Meshes (:mod:`.mesh`): ``single`` is 32 nodes x 8 H100s over ``("data",
"model")``, ``multi`` two such pods over ``("pod", "data", "model")``,
``host`` the local cards as ``(n, 1)`` (``(1, 1)`` with ``--device
cpu``).  Writes one JSON a cell under ``experiments/dryrun_torch/``
(git-ignored); :mod:`.report` tabulates them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

from repro_torch.configs import ALIASES, SHAPES, get_config, shapes_for
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (build_cell, cell_model_config,
                                     mesh_refusal)
from repro_torch.parallel.collectives import tally
from repro_torch.parallel.sharding import ShardingRules

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
MESH_TAGS = {"single": "sp", "multi": "mp", "host": "host"}
NO_COMPILER = "no compiler: the port traces its program and reads no " \
    "compiled one"
NOT_TRACED = "; the dry run traces what runs on a mesh (its collectives " \
    "and FLOPs: ROADMAP Queue 1 A #8.5)"
TRACED_BY = ("rank 0's step on meta tensors: collectives as issued (the "
             "reference's output-shape proxy), FLOPs by FlopCounterMode")


def make_mesh(mesh: str, device="cuda"):
    """The mesh named ``single``, ``multi`` or ``host`` (on ``device``)."""
    if mesh == "host":
        return mesh_lib.make_host_mesh(device)
    return mesh_lib.make_production_mesh(multi_pod=mesh == "multi")


def model_flops(cfg, shape) -> int:
    """The reference's model FLOPs of one step of the cell (``cfg``
    after ``cell_model_config``)."""
    n = cfg.n_active_params * shape.global_batch
    if shape.mode == "train":
        return 6 * n * shape.seq_len
    if shape.mode == "prefill":
        return 2 * n * shape.seq_len
    return 2 * n


def accounting(cell) -> dict:
    """The cell's traced FLOPs and collectives a device (null, with the
    reason, where the program does not run on a mesh), and the compiler's
    fields, null."""
    out = {"flops_per_device": None, "collective_bytes_per_device": None,
           "collective_counts": None,
           "collective_total_bytes_per_device": None,
           "bytes_accessed_per_device": None, "temp_bytes": None}
    why = {"bytes_accessed_per_device": NO_COMPILER,
           "temp_bytes": NO_COMPILER}
    refusal = mesh_refusal(cell, any_mesh=True)
    if refusal:
        for k in ("flops_per_device", "collective_bytes_per_device",
                  "collective_counts", "collective_total_bytes_per_device"):
            why[k] = refusal + NOT_TRACED
    else:
        t, flops = traced(cell)
        out.update(flops_per_device=flops,
                   collective_bytes_per_device=t["bytes"],
                   collective_counts=t["counts"],
                   collective_total_bytes_per_device=t["total_bytes"],
                   traced_by=TRACED_BY)
    out["null_because"] = why
    return out


def traced(cell):
    """``(tally, flops)`` of ``cell``'s step a device, from traces of the
    cell cut to one and to two units: one unit's, plus ``n_units - 1``
    times the second unit's."""
    u = len(cell.cfg.unit)
    parts = []
    for n in (1, 2):
        cut = build_cell(dataclasses.replace(cell.cfg, n_layers=n * u),
                         cell.shape, cell.mesh, rules=cell.rules)
        records, flops = cut.trace()
        parts.append((tally(records), flops))
    (t1, f1), (t2, f2) = parts
    reps = cell.cfg.n_units - 1

    def extrap(a, b):
        return a + reps * (b - a)

    t = {k: {kind: extrap(t1[k][kind], t2[k][kind]) for kind in t1[k]}
         for k in ("bytes", "counts")}
    t["total_bytes"] = extrap(t1["total_bytes"], t2["total_bytes"])
    return t, extrap(f1, f2)


def cell_file(arch: str, shape_name: str, mesh: str, tag: str = ""):
    suffix = f"_{tag}" if tag else ""
    return OUT_DIR / (f"{ALIASES.get(arch, arch)}_{shape_name}_"
                      f"{MESH_TAGS[mesh]}{suffix}.json")


def run_cell(arch: str, shape_name: str, mesh: str = "single",
             write: bool = True, rules_overrides=None, tag: str = "",
             device="cuda") -> dict:
    """Build one cell on ``meta`` tensors and return (and with ``write``
    save) its record; ``rules_overrides`` are ``ShardingRules`` fields.
    Raises ``ValueError`` if a spec does not divide its tensor."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    m = make_mesh(mesh, device)
    rules = None
    if rules_overrides:
        rules = ShardingRules(mesh=m, cfg=cell_model_config(cfg, shape),
                              **rules_overrides)
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, m, rules=rules)
    args = cell.argument_bytes()
    t_build = time.perf_counter() - t0
    flops = model_flops(cell.cfg, shape)
    t0 = time.perf_counter()
    acct = accounting(cell)
    t_trace = time.perf_counter() - t0
    report = {
        "arch": arch,
        "shape": shape.name,
        "mesh": f"{mesh}_{m.name}",
        "mesh_axes": m.shape,
        "n_devices": m.size,
        "mode": shape.mode,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "kv_dtype": cell.cfg.kv_dtype,
        "params_dtype": (cell.cfg.param_dtype if shape.mode == "train"
                         else cell.cfg.dtype),
        "t_build_s": round(t_build, 3),
        "argument_bytes_per_device": args,
        "model_flops_global": flops,
        "model_flops_per_device": flops / m.size,
        "roofline": {
            "model_flops_at_peak_s": flops / m.size
            / mesh_lib.PEAK_FLOPS_BF16,
            "argument_bytes_at_hbm_s": args["total"] / mesh_lib.HBM_BW,
        },
        "accounting": acct,
        "t_trace_s": round(t_trace, 3),
        "tag": tag,
    }
    if write:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        cell_file(arch, shape_name, mesh, tag).write_text(
            json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the host mesh's device (default cuda; cpu gives "
                         "(1, 1))")
    args = ap.parse_args(argv)

    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    archs = list(ALIASES) if args.all or not args.arch else [args.arch]
    cells = []
    for arch in archs:
        shape_names = ([args.shape] if args.shape
                       else [s.name for s in shapes_for(get_config(arch))])
        cells += [(arch, sn, m) for sn in shape_names for m in meshes]

    failures = []
    for arch, sn, m in cells:
        path = cell_file(arch, sn, m)
        if args.skip_existing and path.exists():
            print(f"[skip] {path.stem}")
            continue
        print(f"[dryrun] {path.stem} ...", flush=True)
        try:
            rep = run_cell(arch, sn, m, device=args.device)
            b, rf = rep["argument_bytes_per_device"], rep["roofline"]
            a = rep["accounting"]
            traced = ("not traced" if a["flops_per_device"] is None else
                      f"traced {a['flops_per_device']:.4e} FLOPs, "
                      f"collectives {a['collective_counts']} of "
                      f"{a['collective_total_bytes_per_device'] / 1e9:.3f} GB")
            print(f"  ok: args {b['total'] / 1e9:.3f} GB/device (params "
                  f"{b['params'] / 1e9:.3f}, opt {b['opt_state'] / 1e9:.3f},"
                  f" cache {b['cache'] / 1e9:.3f}, batch "
                  f"{b['batch'] / 1e9:.6f}); model FLOPs at peak "
                  f"{rf['model_flops_at_peak_s']:.4f} s, argument bytes at "
                  f"HBM {rf['argument_bytes_at_hbm_s']:.4f} s; {traced} "
                  f"a device (build {rep['t_build_s']} s, trace "
                  f"{rep['t_trace_s']} s)", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((path.stem, repr(e)))
            print(f"  FAIL {path.stem}: {e}", flush=True)
            traceback.print_exc()
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells passed")
    for n, e in failures:
        print(f"  FAILED: {n}: {e[:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
