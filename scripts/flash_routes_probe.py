#!/usr/bin/env python3
"""Where the flash op's Hopper routes spend their time, at the serve
cell's shapes (llama3-8b, 13 requests: q ``[416, Sq, 128]``, k/v ``[104,
2080, 128]``, bf16, causal).

Run from the root of a checkout on a machine with one CUDA card::

    python3 scripts/flash_routes_probe.py

Two measurements, each printed as a line of JSON:

1. ``decode_splits`` -- the decode route at one q row per head, forced to
   several key splits, against SDPA: device time per call from a
   replayed CUDA graph of 50 back-to-back calls.  At the serve cell's 104
   kv heads (1, 2, 4, 7 and 13 splits) it shows whether more CTAs than
   SMs pay off against the combine launch they need; at 8 kv heads (one
   request: 1, 2, 4 and 11 splits) whether splitting fills an idle card.
   ``plan_splits`` is what :func:`plan` picks at each.
2. ``tc_ablation`` -- the tensor-core prefill (Sq = 2048), causal and
   not, as committed and with one part of the kernel switched off in a
   copy of its source built beside it (``build/repro_torch/ablation/``):
   ``no_softmax`` (scores go straight to P: no max, exp or sum),
   ``no_exp`` (``ex2`` replaced by an add) and ``no_pingpong`` (the two
   consumer warpgroups issue their products without taking turns).  CUDA
   events over 5 back-to-back launches.  The variants compute wrong
   answers on purpose; only their times mean anything.  What a variant
   saves is what that part costs beyond the tensor cores.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402

HK, G, HD, SK, SQ = 104, 4, 128, 2080, 2048

# (anchor in flash_attention_tc.cu, text inserted right after it)
ABLATIONS = {
    "no_softmax": ("    auto softmax = [&](int kt, float* a0, float* a1) {\n",
                   "      *a0 = 1.0f; *a1 = 1.0f; l0 += s[0]; l1 += s[2];\n"
                   "      return;\n"),
    "no_exp": ("__device__ __forceinline__ float ex2(float x) {\n",
               "  return x + 1.0f;\n"),
    "no_pingpong": (
        "__device__ __forceinline__ void named_sync(int id, int threads) {\n",
        "  if (id >= 3) return;\n"),
}
PINGPONG_ARRIVE = ("__device__ __forceinline__ void named_arrive(int id, "
                   "int threads) {\n")


def ablated_source(name: str) -> pathlib.Path:
    """A copy of the tc source with one part switched off."""
    src = K.SOURCES["tc"].read_text()
    anchor, body = ABLATIONS[name]
    assert src.count(anchor) == 1, f"anchor of {name} not found once"
    src = src.replace(anchor, anchor + body)
    if name == "no_pingpong":        # the turn barriers are 3 and 4
        assert src.count(PINGPONG_ARRIVE) == 1
        src = src.replace(PINGPONG_ARRIVE, PINGPONG_ARRIVE + body)
    out = _build.BUILD_DIR / "ablation" / f"flash_attention_tc_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def tc_entry(path: pathlib.Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_tc_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, i32, f32, ptr]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_routes_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(
            torch.bfloat16)

    k, v = rand(HK, SK, HD), rand(HK, SK, HD)
    kp = torch.arange(SK, device=dev, dtype=torch.float32)
    kw = dict(g=G, scale=HD ** -0.5, causal=True, window=0, attn_cap=0.0)

    # 1. decode split sweeps: the serve cell's kv heads, then one request's
    qp = torch.tensor([SK - 1.0], device=dev)
    sweeps = {}
    for hk, splits in ((HK, (1, 2, 4, 7, 13)), (8, (1, 2, 4, 11))):
        q = rand(hk * G, 1, HD)
        kh, vh = k[:hk], v[:hk]
        out = torch.empty_like(q)
        row = {"sdpa_graph_us": cs._graph_ms(cs._sdpa_library(
            q, kh, vh, qp, kp, kw["scale"], hk // 8), 50) * 1e3}
        for want in splits:
            _, n = K.plan(q.dtype, HD, G, SK, hk, K.n_sms(0), want)
            ws = torch.empty(K.workspace_floats(hk, n, G, HD), device=dev)
            row[f"splits_{n}_graph_us"] = cs._graph_ms(
                lambda: K.launch(q, kh, vh, qp, kp, out, **kw, splits=n,
                                 workspace=ws), 50) * 1e3
        row["plan_splits"] = K.plan(q.dtype, HD, G, SK, hk, K.n_sms(0))[1]
        sweeps[f"HK{hk}"] = row
    print(json.dumps({"decode_splits": sweeps}), flush=True)

    # 2. tensor-core prefill ablation
    with ThreadPoolExecutor(len(ABLATIONS) + 1) as pool:
        paths = dict(zip(["as_committed", *ABLATIONS], pool.map(
            lambda s: _build.build(s),
            [K.SOURCES["tc"], *map(ablated_source, ABLATIONS)])))
    qf = rand(HK * G, SQ, HD)
    qpf = torch.arange(SQ, device=dev, dtype=torch.float32)
    of = torch.empty_like(qf)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for causal in (1, 0):
        for name, path in paths.items():
            fn = tc_entry(path)

            def run():
                err = fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                         qpf.data_ptr(), kp.data_ptr(), of.data_ptr(), None, HK, G,
                         SQ, SK, HD, kw["scale"], causal, 0, 0.0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")

            key = f"{'causal' if causal else 'full'}_{name}_us"
            res[key] = cs._event_ms(run, 5) * 1e3
    print(json.dumps({"tc_ablation": res}), flush=True)
    print(cs._clocks(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
