#!/usr/bin/env python3
"""Where the PMwCAS kernel's smem route spends its time, at the KV
service's shape (``[4, 1024, 2]`` rounds against four 1,048,576-word
tables).

Run from the root of a checkout on a machine with one CUDA card::

    python3 scripts/pmwcas_kernel_probe.py

The committed source (``src/repro_torch/csrc/pmwcas_apply.cu``) is built
as it is and in copies with one part of the smem kernel changed
(``build/repro_torch/ablation/``): ``all_contested`` sends every passing
slot through the shared-memory atomics (right answers, the cost the tag
pass saves), ``no_pairs`` gathers and stores neighbouring slots one word
at a time (right answers); ``no_gather``, ``no_scatter`` and ``empty``
compute wrong answers on purpose, only their times mean anything.  The
committed kernel also runs with tag tables 4 and 16 times smaller
(``as_committed_tag_bits-2``, ``-4``).  A copy that stores ``clock64()``
of thread 0 of each CTA at the phase boundaries gives the cycles of each
phase (median over the CTAs of 20 launches).  Two batches:

- ``full``: every row a distinct bucket's two words (key guard, value),
  expected == current and desired == expected, so every launch does the
  whole work again (``chip_smoke.kernel_timings``' batch);
- ``wave``: what a YCSB-A wave of the ycsb cell looks like (about 233
  ops over the 4 shards: 58 rows a shard, the rest padding).

Device time per launch from the profiler (mean over 200 launches, the
variants taken in turns, then again in reverse order).  The card's name
and power limit are printed first; the last line is one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pmwcas_apply import kernel as K  # noqa: E402
from repro_torch.kernels.pmwcas_apply import ref  # noqa: E402

S, B, KS, W, WAVE_ROWS = 4, 1024, 2, 1 << 20, 58

# name -> [(text in pmwcas_apply.cu, its replacement), ...]
ABLATIONS = {
    # every passing slot through the shared-memory atomics (still right)
    "all_contested": [(
        "    if (h[k] >= 0 && tag[h[k]] != i * K + k) {\n"
        "      tag[h[k]] = kContested;\n",
        "    if (h[k] >= 0) {\n      tag[h[k]] = kContested;\n")],
    # no 8-byte accesses for neighbouring slots (still right)
    "no_pairs": [("  return a0 >= 0 && a1 == a0 + 1 &&",
                  "  return false && a1 == a0 + 1 &&")],
    "no_gather": [("  bool pass = live;\n",
                   "  for (int k = 0; k < KMAX; ++k) cur[k] = e[k];\n"
                   "  bool pass = live;\n")],
    "no_scatter": [
        ("      *reinterpret_cast<int2*>(w + a[k]) = make_int2(d[k], "
         "d[k + 1]);\n", ""),
        ("      if (a[k] >= 0) w[a[k]] = d[k];\n"
         "      if (k + 1 < KMAX && a[k + 1] >= 0) w[a[k + 1]] = d[k + 1];\n",
         "")],
    "empty": [("  extern __shared__ int4 smem_raw[];\n",
               "  extern __shared__ int4 smem_raw[];\n  return;\n")],
}

# clock64() of thread 0 of each CTA at the phase boundaries: kernel start,
# after the tag stores' barrier, after the contested marks' barrier, after
# the claims (when a bucket is contested), and when thread 0 has stored
# its verdict
STAMP = "  if (threadIdx.x == 0) g_stamp[blockIdx.x * 8 + {}] = clock64();\n"
STAMPS = [
    ("  const int i = threadIdx.x;                    // this thread's row\n",
     STAMP.format(0)),
    ("static_cast<unsigned short>(i * K + k);\n  }\n  __syncthreads();\n",
     STAMP.format(1)),
    ("  const bool any_contested = __syncthreads_or(other);\n",
     STAMP.format(2)),
    ("    for (int k = 0; k < KMAX; ++k) h[k] = -1;\n  }\n", STAMP.format(3)),
    ("  success[s * B + i] = win ? 1 : 0;\n", STAMP.format(4)),
]
PHASES = ["loads, gather, tags", "contested marks",
          "hash clear and claims", "verdict"]
STAMP_DECL = ("extern \"C\" int pmwcas_read_stamps(void* host) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
              "      host, g_stamp, sizeof(g_stamp)));\n}\n")


def stamped_source() -> pathlib.Path:
    """A copy of the source whose smem kernel records clock64() stamps."""
    src = K.SOURCE.read_text()
    anchor = "constexpr int kMaxThreads = 1024;\n"
    src = src.replace(anchor,
                      anchor + "__device__ long long g_stamp[64 * 8];\n")
    for old, add in STAMPS:
        assert src.count(old) == 1, f"stamp anchor not found once: {old!r}"
        src = src.replace(old, old + add)
    src += STAMP_DECL
    out = _build.BUILD_DIR / "ablation" / "pmwcas_apply_stamped.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def ablated_source(name: str) -> pathlib.Path:
    """A copy of the source with one part of the smem kernel changed."""
    src = K.SOURCE.read_text()
    for old, new in ABLATIONS[name]:
        assert src.count(old) == 1, f"anchor of {name} not found once"
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "ablation" / f"pmwcas_apply_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def smem_entry(path: pathlib.Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.pmwcas_apply_smem_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_longlong, i32, i32, ptr]
    fn.restype = i32
    return fn


def _smem_run(fn, name, bits, words, arrays, success, stream):
    """A launch of the smem route of library entry ``fn`` with the tables
    at ``bits = (tag_bits, cap_bits)``."""
    a, e, d = arrays

    def run():
        err = fn(words.data_ptr(), a.data_ptr(), e.data_ptr(), d.data_ptr(),
                 success.data_ptr(), S, B, KS, W, *bits, stream)
        if err:
            raise RuntimeError(f"{name}: launch error {err}")
    return run


def phase_stamps(path, words, arrays, success, bits, stream) -> dict:
    """Cycles of thread 0 of each CTA between the stamped kernel's phase
    boundaries, the median over the CTAs of 20 launches (launches after
    a warm-up of 10)."""
    lib = ctypes.CDLL(str(path))
    lib.pmwcas_read_stamps.argtypes = [ctypes.c_void_p]
    lib.pmwcas_read_stamps.restype = ctypes.c_int
    run = _smem_run(smem_entry(path), "stamped", bits, words, arrays,
                    success, stream)
    host = np.zeros(64 * 8, np.int64)
    rows = []
    for it in range(30):
        run()
        torch.cuda.synchronize()
        if it >= 10:
            assert lib.pmwcas_read_stamps(host.ctypes.data) == 0
            rows += [np.diff(host[c * 8:c * 8 + 5]) for c in range(S)]
    med = np.median(np.stack(rows), axis=0)
    return dict(zip(PHASES, med.tolist()))


def batches(rng, words_np):
    """The ``full`` and ``wave`` batches (addr, exp, des as int32)."""
    out = {}
    for name in ("full", "wave"):
        addr = np.full((S, B, KS), -1, np.int32)
        for s in range(S):
            rows = B if name == "full" else WAVE_ROWS
            bucket = rng.choice(W // 2, rows, replace=False)
            addr[s, :rows, 0] = 2 * bucket
            addr[s, :rows, 1] = 2 * bucket + 1
        exp = np.take_along_axis(words_np, np.maximum(addr, 0).reshape(S, -1),
                                 1).reshape(addr.shape)
        out[name] = (addr, exp.view(np.int32), exp.view(np.int32))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pmwcas_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(ABLATIONS) + 2) as pool:
        paths = dict(zip(["as_committed", "stamped", *ABLATIONS], pool.map(
            _build.build, [K.SOURCE, stamped_source(),
                           *map(ablated_source, ABLATIONS)])))
    stamped = paths.pop("stamped")
    rng = np.random.default_rng(0)
    words_np = rng.integers(0, 1 << 32, (S, W), dtype=np.uint64).astype(
        np.uint32)
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    claim = K.claim_scratch(words)
    success = torch.empty((S, B), dtype=torch.bool, device=dev)
    bits = K.table_bits(B, KS)
    res = {}
    for bname, arrays in batches(rng, words_np).items():
        a, e, d = (torch.from_numpy(x.copy()).to(dev) for x in arrays)
        _, want = ref.pmwcas_apply_stacked(words.clone(), a, e, d)
        fns = {"global": lambda: K.launch(words, a, e, d, success,
                                          route="global", claim=claim)}
        for name, path in paths.items():
            # the committed kernel also with smaller tag tables
            for less in ((0, 2, 4) if name == "as_committed" else (0,)):
                fns[name + (f"_tag_bits-{less}" if less else "")] = \
                    _smem_run(smem_entry(path), name,
                              (bits[0] - less, bits[1]), words, (a, e, d),
                              success, stream)
        for name in ("as_committed", "as_committed_tag_bits-4",
                     "all_contested", "no_pairs", "global"):
            fns[name]()
            torch.cuda.synchronize()
            assert torch.equal(success, want), f"{name} != plain"
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                us, n = cs._per_launch_us(fns[name], 200, "pmwcas_apply")
                times[name].append(None if us is None else round(us, 3))
        res[bname] = times
        print(json.dumps({bname: times}), flush=True)
        res[bname + "_phases"] = phase_stamps(stamped, words, (a, e, d),
                                              success, bits, stream)
        print(json.dumps({bname + "_phases": res[bname + "_phases"]}),
              flush=True)
    print(cs._clocks(), flush=True)
    print(json.dumps({"pmwcas_kernel_probe": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
