#!/usr/bin/env python3
"""Where the simulator kernel's steps spend their time, one simulation of
the Figs. 9-10 grid at a time (``chip_smoke.fig_specs``: 1,000,000 words,
60,000 steps, drained).

Run from the root of a checkout on a machine with one CUDA card::

    python3 scripts/sim_kernel_probe.py [--cells fig9_ours_t56_a1,...]

The committed source (``src/repro_torch/csrc/pmwcas_sim.cu``) is built
as it is and in copies (``build/repro_torch/ablation/``), each with one
part of the smem route changed; every copy gives right answers:

- ``profile``: the schedule loop stores ``clock64()`` before and after
  each step's switch and branch into a per-branch sum and count (the
  thread's PC is loaded and mapped outside the window; the stamps and
  atomics cost time of their own, outside the sums);
- ``max_carveout``: the SM's split at its most shared memory and least
  L1, where the committed launch asks for what its blocks need;
- ``line_div``: a word's line by floor division, as the global route,
  where the committed route shifts at a power-of-two line width;
- ``alg_generic``: one schedule loop for every algorithm, which it reads
  at run time, where the committed route has one a algorithm;
- ``words_in_order``: a word event loads the line's owner after its
  stores, as the global route, where the committed route loads the word
  and its owner together first;
- ``mod_div``: the thread a descriptor names and the op row by division,
  as the global route, where the committed route multiplies (fastmod);
- ``wait_first``: a back-off wait, most of the steps of a contended
  simulation, tested for before the switch;
- ``prefetch``: when an op is staged, its words, their pmem copies, their
  lines' owners and the next op's row prefetched into L1;
- ``no_stage``: no staged op: the steps read the op's row in device
  memory, as the global route;
- ``cold_noinline``: the branches only ORIGINAL runs not inlined, so the
  other algorithms' branches lie closer together;
- ``noinline_step``: a step's switch and branches not inlined, one copy
  for all its call sites.

Each copy runs each cell alone on the ``smem`` route (the committed
source on both routes); the kernel's own nanoseconds a simulation
(``%globaltimer``) over its steps give ns a step, each copy in turns,
then again in reverse order.  The card's name and power limit are
printed first; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
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
import repro_torch.core as core  # noqa: E402
import repro_torch.pmwcas as pm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pmwcas_sim import kernel as K  # noqa: E402

STEP = ("      step_at<reach_of(A)>(s, tid, dispatch_pc(s, s.pc[tid]));\n")
PROFILE = [(
    STEP,
    "      const int pc = dispatch_pc(s, s.pc[tid]);\n"
    "      const long long c0 = clock64();\n"
    "      step_at<reach_of(A)>(s, tid, pc);\n"
    "      const long long c1 = clock64();\n"
    "      atomicAdd(&g_prof_cycles[pc],\n"
    "                static_cast<unsigned long long>(c1 - c0));\n"
    "      atomicAdd(&g_prof_count[pc], 1ull);\n"), (
    "}  // namespace\n",
    "}  // namespace\n\n"
    "extern \"C\" int pmwcas_sim_profile(unsigned long long* host) {\n"
    "  cudaMemcpyFromSymbol(host, g_prof_cycles, sizeof(g_prof_cycles));\n"
    "  cudaMemcpyFromSymbol(host + PC_COUNT, g_prof_count,\n"
    "                       sizeof(g_prof_count));\n"
    "  const unsigned long long zero[2 * PC_COUNT] = {};\n"
    "  cudaMemcpyToSymbol(g_prof_cycles, zero, sizeof(g_prof_cycles));\n"
    "  cudaMemcpyToSymbol(g_prof_count, zero, sizeof(g_prof_count));\n"
    "  return static_cast<int>(cudaGetLastError());\n"
    "}\n"), (
    "// -- dispatch -----",
    "__device__ unsigned long long g_prof_cycles[PC_COUNT];\n"
    "__device__ unsigned long long g_prof_count[PC_COUNT];\n\n"
    "// -- dispatch -----")]

# name -> [(text in pmwcas_sim.cu, its replacement), ...]
ABLATIONS = {
    "profile": PROFILE,
    # the SM's split at its most shared memory, the least L1
    "max_carveout": [("        static_cast<int>(pct < 100 ? pct : 100));",
                      "        100);")],
    # line_of by floor division, as the global route
    "line_div": [("  return s.wpl_shift >= 0 ? addr >> s.wpl_shift\n"
                  "                          : line_of(static_cast<const "
                  "Sim&>(s), addr);",
                  "  return line_of(static_cast<const Sim&>(s), addr);")],
    # one schedule loop for every algorithm, the algorithm read at run time
    "alg_generic": [(
        "        switch (s.alg) {\n"
        "          case ALG_OURS: steps += run_stage<ALG_OURS>(s, stage, m); "
        "break;\n",
        "        switch (-1) {\n"
        "          case -1: steps += run_stage_generic(s, stage, m); break;\n"
        "          case ALG_OURS: steps += run_stage<ALG_OURS>(s, stage, m); "
        "break;\n"), (
        "// lane 0's steps over one stage of the schedule, for algorithm A",
        "__device__ long long run_stage_generic(SimS& s, const int32_t* "
        "stage,\n                                       int m) {\n"
        "  long long steps = 0;\n"
        "  for (int i = 0; i < m; ++i) {\n"
        "    if (stage[i] >= 0) {\n"
        "      step(s, stage[i]);\n"
        "      ++steps;\n"
        "    }\n"
        "  }\n"
        "  return steps;\n"
        "}\n\n"
        "// lane 0's steps over one stage of the schedule, for algorithm A")],
    # a word's owner loaded after the word's store, as the global route
    "words_in_order": [
        ("__device__ __forceinline__ uint32_t ev_load_word(SimS& s,",
         "__device__ __forceinline__ uint32_t unused_load_word(SimS& s,"),
        ("__device__ bool ev_cas_word(SimS& s,",
         "__device__ bool unused_cas_word(SimS& s,"),
        ("__device__ void ev_store_word(SimS& s,",
         "__device__ void unused_store_word(SimS& s,")],
    # the thread a descriptor names and the op row by division, as the
    # global route, where the committed smem route multiplies (fastmod)
    "mod_div": [
        ("__device__ __forceinline__ int desc_tid(const SimS& s,",
         "__device__ __forceinline__ int unused_desc_tid(const SimS& s,"),
        ("__device__ __forceinline__ uint32_t word_tid(const SimS& s,",
         "__device__ __forceinline__ uint32_t unused_word_tid(const SimS& s,"),
        ("__device__ __forceinline__ int op_row(const SimS& s,",
         "__device__ __forceinline__ int unused_op_row(const SimS& s,")],
    # a back-off wait tested for before the switch
    "wait_first": [(STEP,
                    "      const int pc = dispatch_pc(s, s.pc[tid]);\n"
                    "      if (pc == READ_WAIT || pc == RESERVE_WAIT) {\n"
                    "        br_read_wait(s, tid);\n"
                    "      } else {\n"
                    "        step_at<reach_of(A)>(s, tid, pc);\n"
                    "      }\n")],
    # the staged op's words, pmem copies and line owners, and the next op's
    # row, prefetched into L1 (prefetch.L1) when an op is staged
    "prefetch": [(
        "    s.op_d[tk(s, t, j)] = __ldg(s.ops_des + row + j);\n"
        "  }\n",
        "    s.op_d[tk(s, t, j)] = __ldg(s.ops_des + row + j);\n"
        "    const int a = s.op_a[tk(s, t, j)];\n"
        "    asm volatile(\"prefetch.L1 [%0];\" ::\"l\"(s.cache + a));\n"
        "    asm volatile(\"prefetch.L1 [%0];\" ::\"l\"(s.pmem + a));\n"
        "    asm volatile(\"prefetch.L1 [%0];\" ::\"l\"(s.lo + "
        "line_of(s, a)));\n"
        "  }\n"
        "  const int next = (t * s.max_ops + static_cast<int>(fastmod(\n"
        "      static_cast<uint32_t>(s.op_idx[t] + 1), s.ops_magic,\n"
        "      static_cast<uint32_t>(s.max_ops)))) * s.k;\n"
        "  asm volatile(\"prefetch.L1 [%0];\" ::\"l\"(s.ops + next));\n"
        "  asm volatile(\"prefetch.L1 [%0];\" ::\"l\"(s.ops_des + next));\n")],
    # no staged op: the steps read the op's row in device memory, as the
    # global route
    "no_stage": [
        ("__device__ __forceinline__ void next_op(SimS& s, int t) "
         "{ stage_op(s, t); }", "__device__ __forceinline__ void "
         "next_op(SimS& s, int t) {}"),
        ("  return {s.op_a + tk(s, t, 0), s.op_d + tk(s, t, 0)};",
         "  return cur_op(static_cast<const Sim&>(s), t);"),
        ("  for (int t = lane; t < s.T; t += 32) stage_op(s, t);\n", "")],
    # the ORIGINAL-only branches (RDCSS install, helping) not inlined, so
    # the branches the other algorithms run lie closer together
    "cold_noinline": [("__device__ void br_o_", "__device__ __noinline__ "
                       "void br_o_", 10),
                      ("__device__ void br_h_", "__device__ __noinline__ "
                       "void br_h_", 6)],
    # step not inlined: one copy of the interpreter a call site fewer
    "noinline_step": [("__device__ __forceinline__ void step_at(",
                       "__device__ __noinline__ void step_at(")],
}

PC_NAMES = ("READ_TGT READ_WAIT INIT_DESC PERSIST_DESC RESERVE_TEST "
            "RESERVE_WAIT RESERVE_CAS PERSIST_TGT SET_SUCC PERSIST_STATE "
            "FIN_STORE_DIRTY FIN_PERSIST_DIRTY FIN_STORE FIN_PERSIST OP_DONE "
            "O_RDCSS_CAS O_PROMOTE_CAS O_PERSIST_TGT O_CLEAR_TGT "
            "O_STATUS_CAS O_STATUS_PERSIST O_STATUS_CLEAR O_FIN_CAS "
            "O_FIN_PERSIST O_FIN_CLEAR H_TEST H_CAS H_STATUS_CAS H_FIN_CAS "
            "H_FIN_PERSIST H_FIN_CLEAR P_READ P_CAS P_PERSIST "
            "P_CLEAR").split()


def variant_source(name: str) -> pathlib.Path:
    src = K.SOURCE.read_text()
    for old, new, *times in ABLATIONS[name]:
        if src.count(old) != (times[0] if times else 1):
            raise SystemExit(f"{name}: anchor found {src.count(old)} "
                             f"times: {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "ablation" / f"pmwcas_sim_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def load(path: pathlib.Path, profile: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pmwcas_sim_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.pmwcas_sim_smem_launch.argtypes = [ptr, ptr, i32, i64, ptr]
    if profile:
        lib.pmwcas_sim_profile.argtypes = [ptr]
    return lib


def run(lib, cfg, route: str) -> tuple:
    """One drained simulation of ``cfg`` through ``lib`` on ``route``:
    its steps and the kernel's nanoseconds."""
    dev = torch.device("cuda")
    job = K.SimJob(cfg, core.init_state(cfg, device=dev),
                   core.generate_schedule(cfg), drain=True)
    sched = torch.as_tensor(job.schedule, device=dev)
    rec = torch.as_tensor(K.records([job], [sched.data_ptr()]), device=dev)
    out = torch.zeros((1, K.OUT_LEN), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if route == "smem":
        err = lib.pmwcas_sim_smem_launch(rec.data_ptr(), out.data_ptr(), 1,
                                         K.smem_bytes(cfg), stream)
    else:
        err = lib.pmwcas_sim_launch(rec.data_ptr(), out.data_ptr(), 1,
                                    stream)
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"launch failed: {err}")
    o = out.cpu().numpy()[0]
    return int(o[K.O_STEPS]), int(o[K.O_NS])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="fig9_ours_t56_a1,fig9_ours_t56_a0,"
                    "fig10_ours_t1_a0,fig10_pcas_t56_a0,fig9_original_t56_a0")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    specs = dict(cs.fig_specs(core, pm))
    cells = args.cells.split(",")
    paths = {"committed": K.SOURCE}
    paths.update({n: variant_source(n) for n in ABLATIONS})
    def build(path):
        try:
            return _build.build(path)
        except RuntimeError as e:
            print(f"{path.name}: {e}", flush=True)
            return None

    with ThreadPoolExecutor(len(paths)) as pool:
        libs = {n: p for n, p in zip(paths, pool.map(build, paths.values()))
                if p is not None}
    for name, lib in libs.items():
        log = lib.with_name(lib.name + ".log").read_text()
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "stack" in ln]
        print(f"{name}: {regs}", flush=True)
    loaded = {n: load(p, n == "profile") for n, p in libs.items()}
    runs = [("committed", "global")] + [(n, "smem") for n in loaded]
    ns = {f"{n}/{r}": {c: [] for c in cells} for n, r in runs}
    steps = {}
    for order in (runs, runs[::-1]):
        for name, route in order:
            for cell in cells:
                st, t = run(loaded[name], specs[cell][0], route)
                steps[cell] = st
                ns[f"{name}/{route}"][cell].append(t / st)
    for key, by_cell in ns.items():
        print(f"{key}: " + ", ".join(f"{c} {v[0]:.1f} / {v[1]:.1f} ns a step"
                                     for c, v in by_cell.items()),
              flush=True)
    prof = {}
    host = (ctypes.c_ulonglong * (2 * len(PC_NAMES)))()
    loaded["profile"].pmwcas_sim_profile(host)     # zero the sums
    for cell in cells:
        run(loaded["profile"], specs[cell][0], "smem")
        loaded["profile"].pmwcas_sim_profile(host)
        cyc, cnt = np.array(host[:len(PC_NAMES)]), np.array(
            host[len(PC_NAMES):])
        prof[cell] = {PC_NAMES[i]: [int(cnt[i]), float(cyc[i] / cnt[i])]
                      for i in range(len(PC_NAMES)) if cnt[i]}
        print(f"profile {cell}: " + ", ".join(
            f"{n} {c} x {m:.0f} cyc" for n, (c, m) in prof[cell].items()),
            flush=True)
    print(json.dumps(dict(steps=steps, ns_step=ns, profile=prof)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
