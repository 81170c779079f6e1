"""Hopper kernel: the cycle-accurate PMwCAS simulator, whole schedules
interpreted on the card, many independent simulations in one launch.

The reference runs the simulator as a jitted ``lax.scan`` over a
schedule of micro-ops (``src/repro/core/sim.py:33-42``, driven by
``_compiled_runner`` at ``:175``), each step a ``lax.switch`` on the
thread's program counter (``src/repro/core/engine.py:1025-1031``); it
has no Pallas kernel.  Eager PyTorch would pay ~50 launches a micro-op.
The CUDA C++ source, ``src/repro_torch/csrc/pmwcas_sim.cu``, translates
``repro_torch.core.engine.Machine`` (the plain version) branch by branch
and runs it for a batch of simulations: one warp per simulation, lane 0
stepping (simulations in one warp would diverge on their ``switch (pc)``
and run one after another), the states updated in place.

Each simulation has a record of ``REC_LEN`` int64s: its algorithm and
geometry, back-off, the ten costs, its mode, its schedule (pointer,
length, cut), drain flag and attempt cap, then one device pointer per state
field (``core.model.FIELDS`` order).  So one launch mixes algorithms,
thread counts, ``k`` and word counts.  Modes:

- ``MODE_SCHEDULE``: ``engine.step`` for each schedule entry ``>= 0``
  below the cut, then, with the drain flag, rounds over the non-clean
  threads (each thread's cleanliness tested at its own turn) until all
  are clean or ``MAX_DRAIN_ROUNDS`` rounds ran (the reference's
  ``core.sim._drain``);
- ``MODE_BACKEND``: ``SimBackend``'s two phases — every thread steps
  while at a read PC, then each in index order until ``op_idx >= 1`` or
  ``CNT_FAILS >= 1`` (``src/repro/pmwcas/backends.py:294-312``); a thread
  that takes more than ``attempt_cap`` steps in a phase stops the
  simulation with its phase and index in the output.

What bounds it on the card: latency.  A step is a chain of dependent
steps of one thread of one warp (the schedule entry, the thread's PC, the
dispatch on it, then the branch's loads and stores of the thread's
registers, its op's address, the word and its line's owner); a
simulation is sequential, so nothing hides that latency but other
simulations on other SMs.  Two routes, one kernel each over the same
branch code; :func:`plan` picks one a launch:

- ``smem``: each simulation's per-thread state (:data:`SMEM_FIELDS`, and
  the descriptor lines' entries of ``line_owner``) lives in the block's
  shared memory from entry to end, copied in and written back by all
  lanes; the schedule streams through a ``cp.async`` double buffer; each
  thread's current op is staged in shared memory; a word event loads the
  word and its owner together; the line of a word, the thread a
  descriptor names and the op row take a shift or multiplies where the
  global route divides; the schedule loop has one copy an algorithm,
  whose switch covers only that algorithm's PCs; the launch leaves the
  SM's L1 all it does not need as shared memory.
  Taken when the launch's largest state fits :data:`SMEM_LIMIT`;
- ``global``: the state stays in the caller's tensors, every field read
  and written in place in device memory.  It takes any
  state, wide ``SimBackend`` rounds (one thread an op) among them.

Both write each simulation's elapsed ``%globaltimer`` nanoseconds into
its output (``O_NS``).

Build: at first use the source is compiled with ``nvcc`` for ``sm_90a``
into ``build/repro_torch/`` (``repro_torch.kernels._build``) and loaded
with ``ctypes``; nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.model import (ALGORITHMS, FIELDS, SimConfig,
                                    field_dtype, field_shapes)

from .. import _build

SOURCE = _build.CSRC / "pmwcas_sim.cu"
_ITEMSIZE = {torch.int64: 8, torch.int32: 4, torch.bool: 1}

MODE_SCHEDULE, MODE_BACKEND = 0, 1
# record layout (int64 slots; the source's enum of the same names)
(R_ALG, R_T, R_K, R_NWORDS, R_WPL, R_NWL, R_DL, R_MAXOPS, R_BINIT,
 R_BCAP) = range(10)
R_COST = 10                          # ten costs, C_* order
R_MODE, R_NSCHED, R_CUT, R_DRAIN, R_CAP, R_SCHED = range(20, 26)
R_FIELD = 26                         # one pointer per state field
REC_LEN = R_FIELD + len(FIELDS)
# output slots a simulation (the source's O_* enum)
O_ROUNDS, O_ERR, O_ERR_THREAD, O_STEPS, O_NS = range(5)
OUT_LEN = 5
# ERR_SMEM: the smem route was given less shared memory than a state
ERR_READ_PHASE, ERR_ATTEMPT, ERR_SMEM = 1, 2, 3
ROUTES = ("smem", "global")
# dynamic shared memory a block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
# schedule entries a stage of the smem route's double buffer (int32)
SCHED_CHUNK = 512
# the state fields the smem route keeps in shared memory (the source's
# bind_smem lays them out); besides them it holds the schedule's two
# stages, the descriptor lines' owners and each thread's staged op
SMEM_FIELDS = ("counters",
               "d_state", "d_state_p", "d_state_dirty", "d_ver", "d_ver_p",
               "pc", "op_idx", "tgt_idx", "backoff", "backoff_exp",
               "help_desc", "help_tgt", "ret_pc", "ref_cache", "ref_pmem",
               "d_addr", "d_exp", "d_des", "d_addr_p", "d_exp_p", "d_des_p",
               "exp", "success", "help_ok")
# the reference's _drain(max_rounds=); the source's kMaxDrainRounds
MAX_DRAIN_ROUNDS = 100_000


class SimJob(NamedTuple):
    """One simulation of a launch: its config, its state (a dict of
    tensors, updated in place), its schedule (int32 numpy; entries < 0
    are no-ops) and what to do with it."""
    cfg: SimConfig
    state: dict
    schedule: np.ndarray
    cut: int = 1 << 62               # entries at index >= cut are no-ops
    drain: bool = False
    mode: int = MODE_SCHEDULE
    attempt_cap: int = 10_000


def smem_bytes(cfg: SimConfig) -> int:
    """Shared memory the smem route takes for one simulation of ``cfg``:
    the schedule's two stages, every field of :data:`SMEM_FIELDS`, the
    descriptor lines' owners (``n_threads * desc_lines`` int32) and each
    thread's staged op (``k`` addresses and ``k`` desired values)."""
    T, k = cfg.n_threads, cfg.k
    fields = sum(int(np.prod(shape)) * _ITEMSIZE[field_dtype(name)]
                 for name, shape in field_shapes(cfg).items()
                 if name in SMEM_FIELDS)
    return 2 * SCHED_CHUNK * 4 + fields + 4 * T * cfg.desc_lines + 8 * T * k


def plan(jobs: Sequence[SimJob]) -> tuple:
    """``(route, shared-memory bytes)`` of one launch over ``jobs``:
    ``smem`` with the largest :func:`smem_bytes` of them when that fits
    :data:`SMEM_LIMIT` (one launch takes one route, so its largest state
    decides), else ``global`` (no shared memory)."""
    need = max((smem_bytes(job.cfg) for job in jobs), default=0)
    if need <= SMEM_LIMIT:
        return "smem", need
    return "global", 0


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.pmwcas_sim_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.pmwcas_sim_smem_launch.argtypes = [ptr, ptr, i32, i64, ptr]
    lib.pmwcas_sim_smem_bytes.argtypes = [i32, i32, i32]
    lib.pmwcas_sim_smem_bytes.restype = i64
    for fn in (lib.pmwcas_sim_launch, lib.pmwcas_sim_smem_launch,
               lib.pmwcas_sim_rec_len, lib.pmwcas_sim_out_len):
        fn.restype = i32
    lib.pmwcas_sim_rec_len.argtypes = []
    lib.pmwcas_sim_out_len.argtypes = []
    lib.pmwcas_sim_error_string.argtypes = [i32]
    lib.pmwcas_sim_error_string.restype = ctypes.c_char_p
    return lib


def kernel_rec_len() -> int:
    """The compiled source's record length (the card tests hold it equal
    to :data:`REC_LEN`)."""
    return int(_lib().pmwcas_sim_rec_len())


def kernel_out_len() -> int:
    """The compiled source's output length (held equal to
    :data:`OUT_LEN`)."""
    return int(_lib().pmwcas_sim_out_len())


def kernel_smem_bytes(cfg: SimConfig) -> int:
    """The compiled source's own count of :func:`smem_bytes` (the card
    tests hold the two equal)."""
    return int(_lib().pmwcas_sim_smem_bytes(cfg.n_threads, cfg.k,
                                            cfg.desc_lines))


def check_job(job: SimJob, device: torch.device) -> None:
    """Raise on a state the kernel (and its plain version) does not take:
    every field present, of its dtype and shape under the config,
    contiguous and on ``device``; schedule entries below the thread
    count."""
    job.cfg.validate()
    shapes = field_shapes(job.cfg)
    for name in FIELDS:
        t = job.state.get(name)
        if t is None:
            raise ValueError(f"state lacks field {name!r}")
        if t.dtype != field_dtype(name):
            raise TypeError(f"state field {name} must be "
                            f"{field_dtype(name)}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"state field {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if t.device != device:
            raise ValueError(f"state field {name} is on {t.device}, the "
                             f"launch on {device}")
        if not t.is_contiguous():
            raise ValueError(f"state field {name} must be contiguous")
    sched = job.schedule
    if sched.dtype != np.int32 or sched.ndim != 1:
        raise ValueError("a schedule is a 1-d int32 array")
    if sched.size and int(sched.max()) >= job.cfg.n_threads:
        raise ValueError(f"schedule names thread {int(sched.max())} of "
                         f"{job.cfg.n_threads}")


def records(jobs: Sequence[SimJob], sched_ptrs: Sequence[int]) -> np.ndarray:
    """The ``[len(jobs), REC_LEN]`` int64 records of a launch."""
    rec = np.zeros((len(jobs), REC_LEN), np.int64)
    for i, (job, sp) in enumerate(zip(jobs, sched_ptrs)):
        cfg = job.cfg
        rec[i, :R_COST] = (ALGORITHMS.index(cfg.algorithm), cfg.n_threads,
                           cfg.k, cfg.n_words, cfg.words_per_line,
                           cfg.n_word_lines, cfg.desc_lines, cfg.max_ops,
                           cfg.backoff_init, cfg.backoff_cap)
        rec[i, R_COST:R_MODE] = cfg.cost.as_array()
        rec[i, R_MODE:R_FIELD] = (job.mode, job.schedule.size,
                                  min(job.cut, 1 << 62), int(job.drain),
                                  job.attempt_cap, sp)
        rec[i, R_FIELD:] = [job.state[f].data_ptr() for f in FIELDS]
    return rec


def pmwcas_sim_cuda(jobs: Sequence[SimJob],
                    route: Optional[str] = None) -> np.ndarray:
    """Run every job in ONE launch on the card (their states updated in
    place) on the route :func:`plan` gives, or on ``route`` when one is
    forced (tests and probes; ``smem`` raises for a state past
    :data:`SMEM_LIMIT`), and return the ``[len(jobs), OUT_LEN]`` int64
    outputs: drain rounds, error code and thread (``MODE_BACKEND``),
    engine steps executed, nanoseconds.  Waits for the card.  Counts the
    launch in ``launches`` and ``route_launches``; ``last_ms`` is its
    stream time (CUDA events around the launch), ``last_steps`` the engine
    steps it executed, ``last_route`` its route and ``last_out`` its
    outputs."""
    if not jobs:
        return np.zeros((0, OUT_LEN), np.int64)
    device = jobs[0].state["pc"].device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    for job in jobs:
        check_job(job, device)
    planned, nbytes = plan(jobs)
    if route is None:
        route = planned
    elif route not in ROUTES:
        raise ValueError(f"unknown route {route!r}, not one of {ROUTES}")
    elif route == "smem" and planned != "smem":
        raise ValueError(f"the smem route takes at most {SMEM_LIMIT} bytes "
                         "of shared memory; this launch's largest state "
                         f"needs {max(smem_bytes(j.cfg) for j in jobs)}")
    sizes = [job.schedule.size for job in jobs]
    flat = np.concatenate([job.schedule for job in jobs]
                          + [np.zeros(1, np.int32)])
    sched = torch.as_tensor(flat, device=device)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    rec = torch.as_tensor(records(jobs, sched.data_ptr() + 4 * offsets),
                          device=device)
    out = torch.zeros((len(jobs), OUT_LEN), dtype=torch.int64,
                      device=device)
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(rec, out, route, nbytes)
        end.record()
    pmwcas_sim_cuda.launches += 1
    pmwcas_sim_cuda.route_launches[route] += 1
    host = out.cpu().numpy()         # waits; sched and rec live until here
    if (host[:, O_ERR] == ERR_SMEM).any():
        raise RuntimeError("pmwcas_sim: the smem route was given less "
                           "shared memory than a state needs")
    pmwcas_sim_cuda.last_ms = start.elapsed_time(end)
    pmwcas_sim_cuda.last_steps = int(host[:, O_STEPS].sum())
    pmwcas_sim_cuda.last_route = route
    pmwcas_sim_cuda.last_out = host
    return host


def launch(rec: torch.Tensor, out: torch.Tensor, route: str = "global",
           smem: int = 0, stream: Optional[int] = None) -> None:
    """Enqueue one launch over the records ``rec [n, REC_LEN]`` writing
    ``out [n, OUT_LEN]`` on ``route`` (``smem`` with ``smem`` bytes of
    shared memory a block, at least :func:`smem_bytes` of every record's
    config), WITHOUT the job checks and without counting it (timing loops
    over records :func:`pmwcas_sim_cuda` has accepted).  Raises if the
    launch is refused."""
    lib = _lib()
    with torch.cuda.device(rec.device):
        if stream is None:
            stream = torch.cuda.current_stream(rec.device).cuda_stream
        if route == "smem":
            err = lib.pmwcas_sim_smem_launch(rec.data_ptr(), out.data_ptr(),
                                             rec.shape[0], smem, stream)
        elif route == "global":
            err = lib.pmwcas_sim_launch(rec.data_ptr(), out.data_ptr(),
                                        rec.shape[0], stream)
        else:
            raise ValueError(f"unknown route {route!r}, not one of {ROUTES}")
    if err:
        raise RuntimeError("pmwcas_sim launch failed: "
                           + lib.pmwcas_sim_error_string(err).decode())


def reset_counts() -> None:
    """Set the launch counts (all, and by route) to 0."""
    pmwcas_sim_cuda.launches = 0
    pmwcas_sim_cuda.route_launches = dict.fromkeys(ROUTES, 0)


pmwcas_sim_cuda.launches = 0         # launches issued by this process
pmwcas_sim_cuda.route_launches = dict.fromkeys(ROUTES, 0)   # by route
pmwcas_sim_cuda.last_ms = None       # the last launch's stream time,
pmwcas_sim_cuda.last_steps = 0       # its engine steps,
pmwcas_sim_cuda.last_route = None    # its route
pmwcas_sim_cuda.last_out = None      # and its outputs
