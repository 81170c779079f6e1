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
and run one after another), its state in the device memory of the
tensors it is given (updated in place).

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

What bounds it on the card: latency.  A step is a short chain of
dependent 4-byte loads and stores (the thread's PC, its registers, its
op's address, the word and its line's owner) with a data-dependent
branch between each; a simulation is sequential, so nothing hides that
latency but other simulations on other SMs.  A simple kernel that is
right comes first: the state stays in global memory.

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

MODE_SCHEDULE, MODE_BACKEND = 0, 1
# record layout (int64 slots; the source's enum of the same names)
(R_ALG, R_T, R_K, R_NWORDS, R_WPL, R_NWL, R_DL, R_MAXOPS, R_BINIT,
 R_BCAP) = range(10)
R_COST = 10                          # ten costs, C_* order
R_MODE, R_NSCHED, R_CUT, R_DRAIN, R_CAP, R_SCHED = range(20, 26)
R_FIELD = 26                         # one pointer per state field
REC_LEN = R_FIELD + len(FIELDS)
# output slots a simulation
O_ROUNDS, O_ERR, O_ERR_THREAD, O_STEPS = range(4)
OUT_LEN = 4
ERR_READ_PHASE, ERR_ATTEMPT = 1, 2
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


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library path (see :func:`repro_torch.kernels._build.build`)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pmwcas_sim_launch.argtypes = [ptr, ptr, i32, ptr]
    lib.pmwcas_sim_launch.restype = i32
    lib.pmwcas_sim_rec_len.argtypes = []
    lib.pmwcas_sim_rec_len.restype = i32
    lib.pmwcas_sim_error_string.argtypes = [i32]
    lib.pmwcas_sim_error_string.restype = ctypes.c_char_p
    return lib


def kernel_rec_len() -> int:
    """The compiled source's record length (the card tests hold it equal
    to :data:`REC_LEN`)."""
    return int(_lib().pmwcas_sim_rec_len())


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


def pmwcas_sim_cuda(jobs: Sequence[SimJob]) -> np.ndarray:
    """Run every job in ONE launch on the card (their states updated in
    place) and return the ``[len(jobs), OUT_LEN]`` int64 outputs: drain
    rounds, error code and thread (``MODE_BACKEND``), engine steps
    executed.  Waits for the card.  Counts the launch in ``launches``;
    ``last_ms`` is its stream time (CUDA events around the launch) and
    ``last_steps`` the engine steps it executed."""
    if not jobs:
        return np.zeros((0, OUT_LEN), np.int64)
    device = jobs[0].state["pc"].device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    for job in jobs:
        check_job(job, device)
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
        launch(rec, out)
        end.record()
    pmwcas_sim_cuda.launches += 1
    host = out.cpu().numpy()         # waits; sched and rec live until here
    pmwcas_sim_cuda.last_ms = start.elapsed_time(end)
    pmwcas_sim_cuda.last_steps = int(host[:, O_STEPS].sum())
    return host


def launch(rec: torch.Tensor, out: torch.Tensor,
           stream: Optional[int] = None) -> None:
    """Enqueue one launch over the records ``rec [n, REC_LEN]`` writing
    ``out [n, OUT_LEN]``, WITHOUT the job checks and without counting it
    (timing loops over records :func:`pmwcas_sim_cuda` has accepted).
    Raises if the launch is refused."""
    lib = _lib()
    with torch.cuda.device(rec.device):
        if stream is None:
            stream = torch.cuda.current_stream(rec.device).cuda_stream
        err = lib.pmwcas_sim_launch(rec.data_ptr(), out.data_ptr(),
                                    rec.shape[0], stream)
    if err:
        raise RuntimeError("pmwcas_sim launch failed: "
                           + lib.pmwcas_sim_error_string(err).decode())


def reset_counts() -> None:
    """Set the launch count to 0."""
    pmwcas_sim_cuda.launches = 0


pmwcas_sim_cuda.launches = 0         # launches issued by this process
pmwcas_sim_cuda.last_ms = None       # the last launch's stream time
pmwcas_sim_cuda.last_steps = 0       # and its engine steps
