"""Fluent simulation sessions over the cycle-accurate PMwCAS simulator.

Replaces the ``SimConfig`` + free-function spread (``run_sim`` /
``run_until`` / ``check_crash_consistency``) with one chainable builder::

    result = (SimSession()
              .with_algorithm(OURS)
              .with_threads(32).with_k(3).with_skew(1.0)
              .with_steps(60_000)
              .run())

    rec, hist = (SimSession().with_algorithm(OURS_DF)
                 .with_threads(4).with_words(64)
                 .crash_at(423))          # run_until + recovery check

Sessions are immutable: every ``with_*`` returns a new session, so a base
session can be forked per sweep point (the benchmark pattern).  ``run``
results are plain :class:`repro_torch.core.SimResult` objects.  A session
runs on ``device`` (default ``"cuda"``: the simulator kernel,
``csrc/pmwcas_sim.cu``; ``"cpu"``: its plain version); ``specs`` gives
the ``run_sims`` entries of a sweep over this session, so many crash
points or grid cells run in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import (CostModel, SimConfig, SimResult,
                              check_crash_consistency, run_sim, run_until)
from .algorithms import Algorithm, resolve


@dataclasses.dataclass(frozen=True)
class SimSession:
    """Immutable builder; terminal operations: run / run_until / crash_at."""
    cfg: SimConfig = dataclasses.field(default_factory=SimConfig)
    ops: Optional[np.ndarray] = None          # pre-generated [T, max_ops, k]
    schedule: Optional[np.ndarray] = None     # explicit interleaving
    device: Union[str, torch.device] = "cuda"

    # -- generic configuration ----------------------------------------------
    def configure(self, **overrides) -> "SimSession":
        """Override any SimConfig field by name."""
        if "algorithm" in overrides:
            overrides["algorithm"] = resolve(overrides["algorithm"]).name
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, **overrides))

    # -- named builders -------------------------------------------------------
    def with_algorithm(self, alg: Union[str, Algorithm]) -> "SimSession":
        return self.configure(algorithm=alg)

    def with_threads(self, n: int) -> "SimSession":
        return self.configure(n_threads=n)

    def with_words(self, n: int) -> "SimSession":
        return self.configure(n_words=n)

    def with_k(self, k: int) -> "SimSession":
        return self.configure(k=k)

    def with_skew(self, alpha: float) -> "SimSession":
        """Zipf skew of the benchmark's word popularity (paper Eq. 1)."""
        return self.configure(alpha=alpha)

    def with_blocks(self, block_bytes: int) -> "SimSession":
        """Memory-block size (Fig. 14 false-sharing lever)."""
        return self.configure(block_bytes=block_bytes)

    def with_steps(self, n: int) -> "SimSession":
        return self.configure(n_steps=n)

    def with_max_ops(self, n: int) -> "SimSession":
        return self.configure(max_ops=n)

    def with_seed(self, seed: int) -> "SimSession":
        return self.configure(seed=seed)

    def with_backoff(self, init: int, cap: int) -> "SimSession":
        return self.configure(backoff_init=init, backoff_cap=cap)

    def with_cost_model(self, cost: CostModel) -> "SimSession":
        return self.configure(cost=cost)

    def with_device(self, device: Union[str, torch.device]) -> "SimSession":
        """Where the session's simulations run (``"cuda"`` or ``"cpu"``)."""
        return dataclasses.replace(self, device=device)

    # -- explicit workload/interleaving ---------------------------------------
    def with_ops(self, ops: np.ndarray) -> "SimSession":
        """Pin the pre-generated target table ([T, max_ops, k] word ids)."""
        return dataclasses.replace(self, ops=np.asarray(ops, np.int32))

    def with_schedule(self, schedule: np.ndarray) -> "SimSession":
        """Pin the thread interleaving (int32[n_steps]; <0 entries no-op)."""
        return dataclasses.replace(
            self, schedule=np.asarray(schedule, np.int32))

    # -- introspection ---------------------------------------------------------
    @property
    def algorithm(self) -> Algorithm:
        return resolve(self.cfg.algorithm)

    def describe(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self.cfg)
        d["algorithm"] = self.algorithm.title
        return d

    def spec(self, drain: bool = True, cut: Optional[int] = None) -> tuple:
        """This session's ``run_sims`` entry: ``run()`` with ``cut=None``,
        ``run_until(cut)`` with ``drain=False``."""
        return (self.cfg.validate(), self.ops, self.schedule, drain, cut)

    # -- terminal operations ---------------------------------------------------
    def run(self, drain: bool = True) -> SimResult:
        """Run the configured schedule; drain to quiescence by default."""
        return run_sim(self.cfg.validate(), ops=self.ops,
                       schedule=self.schedule, drain=drain,
                       device=self.device)

    def run_until(self, n_steps: int) -> SimResult:
        """Run exactly n_steps micro-ops WITHOUT draining (crash studies)."""
        return run_until(self.cfg.validate(), n_steps, ops=self.ops,
                         schedule=self.schedule, device=self.device)

    def crash_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Crash after ``step`` micro-ops, recover from the persisted
        descriptors, and verify the crash invariant.  Returns
        (recovered pmem, committed per-word histogram)."""
        r = self.run_until(step)
        return check_crash_consistency(self.cfg, r.state)
