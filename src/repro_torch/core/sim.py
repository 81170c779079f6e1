"""Simulation driver: whole schedules of micro-ops over a deterministic
interleaving, many simulations per call.

`run_sim` executes `cfg.n_steps` scheduler slots (one micro-op each) and
optionally *drains* in-flight operations so the memory reaches quiescence
(every word payload-tagged, cache == pmem) — the precondition for the exact
sum-invariant checks in the tests.  `run_sims` runs a list of independent
simulations (grid cells, crash points, seeds) at once: on a CUDA device
in ONE launch of the Hopper kernel (``csrc/pmwcas_sim.cu``, on the route
its plan gives: the state in shared memory where it fits), on the CPU
one after another through the plain version (``engine.Machine``).  Its
results equal one `run_sim` / `run_until` a simulation.

Throughput is modeled as  total completed ops / max-over-threads cycles
(threads run concurrently on real hardware; the per-thread cycle accumulators
already include contention, back-off and flush costs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.pmwcas_sim import kernel as sim_kernel
from repro_torch.kernels.pmwcas_sim.kernel import (ERR_ATTEMPT,
                                                   ERR_READ_PHASE,
                                                   MAX_DRAIN_ROUNDS,
                                                   MODE_BACKEND,
                                                   MODE_SCHEDULE, O_ERR,
                                                   O_ERR_THREAD, O_ROUNDS,
                                                   O_STEPS, OUT_LEN, SimJob)

from . import engine
from .model import (ALG_PCAS, CNT_CAS, CNT_CYCLES, CNT_FAILS, CNT_FLUSH,
                    CNT_HELPS, CNT_INVAL, CNT_LOAD, CNT_OPS, CNT_STORE, PC,
                    SimConfig, TAG_MASK, TAG_SHIFT, generate_schedule,
                    init_state, state_to_arrays)


def _device(device) -> torch.device:
    # the pmwcas package's resolve_device, without importing that package
    # here (it imports this module)
    from repro_torch.pmwcas.backends import resolve_device
    return resolve_device(device)


# ---------------------------------------------------------------------------
# The plain version: the scan loop, the drain loop and SimBackend's phases
# over CPU tensors
# ---------------------------------------------------------------------------

def run_plain(job: SimJob) -> np.ndarray:
    """Run one job on its CPU state in place, as the kernel runs it on
    the card; returns its ``OUT_LEN`` outputs."""
    cfg = job.cfg
    m = engine.Machine(cfg, engine.host_views(job.state))
    out = np.zeros(OUT_LEN, np.int64)
    steps = 0
    if job.mode == MODE_SCHEDULE:
        # negative schedule entries are no-ops (crash studies cut a
        # schedule by masking its tail)
        for tid in job.schedule[:max(0, min(job.schedule.size, job.cut))
                                ].tolist():
            if tid >= 0:
                m.step(tid)
                steps += 1
        rounds = 0
        if job.drain:
            threads = range(cfg.n_threads)
            while rounds < MAX_DRAIN_ROUNDS and \
                    not all(m.clean(t) for t in threads):
                for t in threads:      # each thread tested at its turn
                    if not m.clean(t):
                        m.step(t)
                        steps += 1
                rounds += 1
        out[O_ROUNDS] = rounds
    elif job.mode == MODE_BACKEND:
        read_pcs = ({PC.P_READ} if cfg.algorithm == ALG_PCAS
                    else {PC.READ_TGT, PC.READ_WAIT})
        phases = ((ERR_READ_PHASE, lambda t: int(m.pc[t]) in read_pcs),
                  (ERR_ATTEMPT, lambda t: int(m.op_idx[t]) < 1 and
                   int(m.cnt[t, CNT_FAILS]) < 1))
        for err, running in phases:
            for t in range(cfg.n_threads):
                n = 0
                while running(t):
                    m.step(t)
                    steps += 1
                    n += 1
                    if n > job.attempt_cap:
                        out[O_ERR], out[O_ERR_THREAD] = err, t
                        out[O_STEPS] = steps
                        return out
    else:
        raise ValueError(f"unknown simulation mode {job.mode}")
    out[O_STEPS] = steps
    return out


def run_jobs(jobs: Sequence[SimJob], *,
             route: Optional[str] = None) -> np.ndarray:
    """Run simulations on their states' device: CUDA tensors in one launch
    of the kernel (no fallback) on the route its plan gives or on
    ``route`` (``"smem"`` / ``"global"``, forced for tests and probes),
    CPU tensors through the plain version (which takes no route).
    Returns the ``[len(jobs), OUT_LEN]`` outputs."""
    if not jobs:
        return np.zeros((0, OUT_LEN), np.int64)
    devices = {job.state["pc"].device for job in jobs}
    if len(devices) != 1:
        raise ValueError(f"one launch runs on one device, got {devices}")
    if devices.pop().type == "cuda":
        return sim_kernel.pmwcas_sim_cuda(jobs, route)
    if route is not None:
        raise ValueError(f"route {route!r} is the kernel's; CPU states run "
                         "the plain version")
    for job in jobs:
        sim_kernel.check_job(job, torch.device("cpu"))
    return np.stack([run_plain(job) for job in jobs])


@dataclasses.dataclass
class SimResult:
    cfg: SimConfig
    state: Dict[str, Any]          # host copy: numpy, the reference's dtypes
    drained: bool
    drain_rounds: int

    # ----- instrumentation accessors --------------------------------------
    @property
    def counters(self) -> np.ndarray:
        return np.asarray(self.state["counters"])

    def total(self, cnt: int) -> int:
        return int(self.counters[:, cnt].sum())

    @property
    def ops_completed(self) -> int:
        return self.total(CNT_OPS)

    @property
    def wall_cycles(self) -> int:
        return int(self.counters[:, CNT_CYCLES].max())

    @property
    def throughput(self) -> float:
        """Completed operations per modeled cycle (scale-free)."""
        return self.ops_completed / max(1, self.wall_cycles)

    def mean_latency_cycles(self) -> float:
        """Average cycles per completed op, per thread, averaged."""
        ops = self.counters[:, CNT_OPS].astype(np.float64)
        cyc = self.counters[:, CNT_CYCLES].astype(np.float64)
        ok = ops > 0
        if not ok.any():
            return float("inf")
        return float((cyc[ok] / ops[ok]).mean())

    def percentile_latency_cycles(self, q: float) -> float:
        """Per-thread cycles/op distribution percentile (paper's p1/p99)."""
        ops = self.counters[:, CNT_OPS].astype(np.float64)
        cyc = self.counters[:, CNT_CYCLES].astype(np.float64)
        ok = ops > 0
        if not ok.any():
            return float("inf")
        return float(np.percentile(cyc[ok] / ops[ok], q))

    def per_op(self, cnt: int) -> float:
        """Average count per *successful* op (incl. retry overheads)."""
        return self.total(cnt) / max(1, self.ops_completed)

    def summary(self) -> Dict[str, float]:
        return {
            "algorithm": self.cfg.algorithm,
            "threads": self.cfg.n_threads,
            "k": self.cfg.k,
            "alpha": self.cfg.alpha,
            "ops": self.ops_completed,
            "fails": self.total(CNT_FAILS),
            "throughput_per_cycle": self.throughput,
            "cas_per_op": self.per_op(CNT_CAS),
            "flush_per_op": self.per_op(CNT_FLUSH),
            "load_per_op": self.per_op(CNT_LOAD),
            "store_per_op": self.per_op(CNT_STORE),
            "inval_per_op": self.per_op(CNT_INVAL),
            "helps": self.total(CNT_HELPS),
            "wall_cycles": self.wall_cycles,
        }

    # ----- invariants -------------------------------------------------------
    def payload_values(self, which: str = "pmem") -> np.ndarray:
        words = np.asarray(self.state[which])
        return words >> TAG_SHIFT

    def tags(self, which: str = "pmem") -> np.ndarray:
        return np.asarray(self.state[which]) & int(TAG_MASK)

    def expected_histogram(self) -> np.ndarray:
        """Per-word successful-increment counts implied by op_idx.

        Ops are retried until success, so thread t's completed set is exactly
        its first op_idx[t] pre-generated ops (with wrap-around reuse).
        """
        ops = np.asarray(self.state["ops"])  # [T, max_ops, k]
        op_idx = np.asarray(self.state["op_idx"])
        hist = np.zeros(self.cfg.n_words, dtype=np.int64)
        for t in range(self.cfg.n_threads):
            n = int(op_idx[t])
            full, part = divmod(n, self.cfg.max_ops)
            if full:
                np.add.at(hist, ops[t].reshape(-1), full)
            if part:
                np.add.at(hist, ops[t, :part].reshape(-1), 1)
        return hist


SimSpec = Tuple[SimConfig, Optional[np.ndarray], Optional[np.ndarray], bool,
                Optional[int]]


def _schedule(cfg: SimConfig, schedule) -> np.ndarray:
    if schedule is None:
        return generate_schedule(cfg)
    return np.ascontiguousarray(np.asarray(schedule), np.int32)


def run_sims(specs: Sequence[SimSpec], *,
             device: Union[str, torch.device] = "cuda",
             route: Optional[str] = None) -> List[SimResult]:
    """Run independent simulations, each ``(cfg, ops, schedule, drain,
    cut)``: ``ops``/``schedule`` as in :func:`run_sim` (``None``
    generates them from ``cfg``), ``cut`` as ``run_until``'s ``n_steps``
    (``None``: the whole schedule).  On ``"cuda"`` (the default) they run
    in one launch of the Hopper kernel, on ``"cpu"`` through the plain
    version; the results equal one :func:`run_sim` / :func:`run_until` a
    simulation.  ``route`` forces the kernel's route (:func:`run_jobs`)."""
    dev = _device(device)
    jobs = []
    for cfg, ops, schedule, drain, cut in specs:
        cfg.validate()
        jobs.append(SimJob(cfg, init_state(cfg, ops, device=dev),
                           _schedule(cfg, schedule),
                           cut=(1 << 62) if cut is None else int(cut),
                           drain=bool(drain)))
    out = run_jobs(jobs, route=route)
    return [SimResult(cfg=job.cfg, state=state_to_arrays(job.state),
                      drained=job.drain,
                      drain_rounds=int(o[O_ROUNDS]))
            for job, o in zip(jobs, out)]


def run_sim(cfg: SimConfig,
            ops: Optional[np.ndarray] = None,
            schedule: Optional[np.ndarray] = None,
            drain: bool = True, *,
            device: Union[str, torch.device] = "cuda",
            route: Optional[str] = None) -> SimResult:
    """Run the simulation (deterministic given cfg/ops/schedule)."""
    return run_sims([(cfg, ops, schedule, drain, None)], device=device,
                    route=route)[0]


def run_until(cfg: SimConfig, n_steps: int,
              ops: Optional[np.ndarray] = None,
              schedule: Optional[np.ndarray] = None, *,
              device: Union[str, torch.device] = "cuda",
              route: Optional[str] = None) -> SimResult:
    """Run exactly the first n_steps schedule slots WITHOUT draining (for
    crash studies); slots at n_steps and after are no-ops, as the
    reference masks them to -1."""
    return run_sims([(cfg, ops, schedule, False, n_steps)],
                    device=device, route=route)[0]


def run_state(cfg: SimConfig, state: Dict[str, torch.Tensor],
              schedule: Optional[np.ndarray] = None, *, drain: bool = True,
              cut: Optional[int] = None,
              route: Optional[str] = None) -> SimResult:
    """Continue a simulation from ``state`` (tensors on one device, e.g.
    from :func:`repro_torch.core.model.state_from_arrays`; updated in
    place) over ``schedule``, on that device (``route`` as in
    :func:`run_jobs`)."""
    job = SimJob(cfg.validate(), state, _schedule(cfg, schedule),
                 cut=(1 << 62) if cut is None else int(cut),
                 drain=bool(drain))
    o = run_jobs([job], route=route)[0]
    return SimResult(cfg=cfg, state=state_to_arrays(state), drained=drain,
                     drain_rounds=int(o[O_ROUNDS]))
