"""Tabulate the dry run's records (``experiments/dryrun_torch/*.json``).

The port of ``repro/launch/report.py``::

    PYTHONPATH=src python -m repro_torch.launch.report > \\
        experiments/roofline_torch.md

A cell fits when its per-device argument bytes fit the card's memory:
``torch.cuda.get_device_properties(0).total_memory`` where a card is
present, else the H100 data sheet's 80 GB.  The dry run derives no
temporary memory, so a cell that fits here may still not run.  The traced
collectives (all-gather and all-reduce counts, the bytes of all kinds a
device) and FLOPs a device print where the dry run traced the cell;
fields the port leaves ``null`` (temporary bytes everywhere, the traced
fields of a cell that does not run on a mesh) print as ``-``.
"""
from __future__ import annotations

import json

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import MESH_TAGS, OUT_DIR

ORDER = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "qwen15_32b",
         "glm4_9b", "llama3_8b", "gemma2_9b", "xlstm_125m",
         "seamless_m4t_medium", "jamba_v01_52b", "paligemma_3b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
LABELS = {"single": "32 nodes x 8 H100 = 256 cards",
          "multi": "2 pods x 32 nodes x 8 H100 = 512 cards",
          "host": "the local cards"}


def device_memory() -> tuple:
    """``(bytes, label)`` of one card's memory: the card's own where one
    is present, else the data sheet's."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return int(mesh_lib.HBM_BYTES), "H100 data sheet"


def load(mesh: str):
    rows = []
    for arch in ORDER:
        for shape in SHAPES:
            p = OUT_DIR / f"{arch}_{shape}_{MESH_TAGS[mesh]}.json"
            if p.exists():
                rows.append(json.loads(p.read_text()))
    return rows


def fmt_gb(x):
    return "-" if x is None else f"{x / 1e9:.3f}"


def fmt_s(x):
    return "-" if x is None else f"{x:.4f}"


def fmt_count(counts, kind):
    return "-" if counts is None else str(counts[kind])


def dryrun_table(rows, memory: int, label: str) -> str:
    out = [f"| arch | shape | args GB/dev | params | opt state | cache | "
           f"batch | temp GB/dev | args fit {memory / 1e9:.1f} GB "
           f"({label}) | kv | collective GB/dev | all-gathers | "
           f"all-reduces | build s |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        b, a = r["argument_bytes_per_device"], r["accounting"]
        fits = "yes" if b["total"] <= memory else "NO"
        counts = a["collective_counts"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_gb(b['total'])} | "
            f"{fmt_gb(b['params'])} | {fmt_gb(b['opt_state'])} | "
            f"{fmt_gb(b['cache'])} | {fmt_gb(b['batch'])} | "
            f"{fmt_gb(a['temp_bytes'])} | {fits} | {r['kv_dtype']} | "
            f"{fmt_gb(a['collective_total_bytes_per_device'])} | "
            f"{fmt_count(counts, 'all-gather')} | "
            f"{fmt_count(counts, 'all-reduce')} | {r['t_build_s']} |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | model FLOPs at 989 TFLOP/s, s | argument "
           "bytes at 3.35 TB/s, s | larger | MODEL_FLOPS/traced FLOPs | "
           "what would move it |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        f, b = rf["model_flops_at_peak_s"], rf["argument_bytes_at_hbm_s"]
        traced = r["accounting"]["flops_per_device"]
        ratio = ("-" if not traced else
                 f"{r['model_flops_per_device'] / traced:.3f}")
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(f)} | {fmt_s(b)} | "
            f"{'flops' if f >= b else 'bytes'} | {ratio} | {_hint(r)} |")
    return "\n".join(out)


def _hint(r) -> str:
    rf, mode = r["roofline"], r["mode"]
    if rf["argument_bytes_at_hbm_s"] > rf["model_flops_at_peak_s"]:
        if mode == "decode":
            return "int8 or grouped KV reads; dequantize inside attention"
        if mode == "train":
            return "shard the optimizer state over more axes"
        return "shard the cache over the model axis"
    if mode == "train":
        return ("overlap FSDP all-gathers with compute; less remat "
                "recompute")
    return "larger attention tiles; fuse the norms into the products"


def main():
    memory, label = device_memory()
    print("# Dry-run report of the port (auto-generated)\n")
    for mesh in ("single", "multi", "host"):
        rows = load(mesh)
        if not rows:
            continue
        print(f"\n## Mesh: {LABELS[mesh]} ({rows[0]['mesh']}) — "
              f"{len(rows)} cells\n")
        print("### Per-device argument memory\n")
        print(dryrun_table(rows, memory, label))
        print("\n### Roofline terms (one train/prefill/decode step)\n")
        print(roofline_table(rows))


if __name__ == "__main__":
    main()
