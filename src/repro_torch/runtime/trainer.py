"""Fault-tolerant training runtime.

The port of ``repro/runtime/trainer.py``.  Wraps the train step
(``TrainModel.train_loss`` -> backward -> :func:`repro_torch.optim.adamw.
update`) with:
- atomic multi-group checkpointing (params / opt / data-iterator / meta
  committed together through the descriptor-WAL committer — the paper's
  technique guaranteeing no torn training state),
- automatic resume from the newest committed checkpoint,
- async (double-buffered) checkpoints overlapping training,
- straggler detection: per-step wall time is monitored and steps slower
  than ``straggler_factor`` x the running median are counted/logged,
- preemption hook: ``request_stop()`` finishes the current step, commits,
  and exits cleanly (SIGTERM-style elasticity).

The model holds its float32 masters (a ``TrainModel`` on ``device``);
``init_state`` draws them from a seeded ``torch.Generator`` on the device,
a restore loads the checkpoint's trees into them.  Checkpoints hold the
reference's trees (``params_to_numpy``/``opt_state_to_numpy``), so the
state a save commits has the reference's layout.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointManager, CheckpointManager
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import (load_params, opt_state_from_numpy,
                                        opt_state_to_numpy, params_to_numpy)
from repro_torch.models.transformer import TrainModel
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_async: bool = False
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    """``Trainer(model, opt_cfg, data_cfg, tcfg, device="cuda")`` trains
    ``model`` (a ``TrainModel``, moved to ``device``) for
    ``tcfg.total_steps`` steps."""

    def __init__(self, model: TrainModel, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *,
                 device="cuda"):
        self.model = model.to(torch.device(device))
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        mgr_cls = (AsyncCheckpointManager if tcfg.ckpt_async
                   else CheckpointManager)
        self.ckpt = mgr_cls(tcfg.ckpt_dir)
        self._stop = False
        self.step_times: list = []
        self.stragglers = 0
        self.metrics_log: list = []
        self._step = make_train_step(model, opt_cfg)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def request_stop(self):
        self._stop = True

    # -- state ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = self.model.init_params(seed)
        opt = adamw.init_state(self.opt_cfg, params)
        stream = SyntheticStream(self.data_cfg)
        return params, opt, stream, 0

    def restore_or_init(self, seed: int = 0):
        got = self.ckpt.restore()
        if got is None:
            return self.init_state(seed)
        step, state = got
        load_params(self.model, state["params"])
        opt = opt_state_from_numpy(state["opt"], self.model)
        stream = SyntheticStream.from_state(self.data_cfg,
                                            state["data_state"])
        return (self.model.param_dict(), opt, stream,
                int(np.asarray(state["meta_state"]["next_step"])))

    def _save(self, step, params, opt, stream):
        state = {
            "params": params_to_numpy(self.model),
            "opt": opt_state_to_numpy(opt, self.model),
            "data_state": {k: np.asarray(v)
                           for k, v in stream.state().items()},
            "meta_state": {"next_step": np.asarray(step + 1)},
        }
        if self.tcfg.ckpt_async:
            self.ckpt.save_async(step + 1, state)
        else:
            self.ckpt.save(step + 1, state)

    # -- loop -------------------------------------------------------------------
    def run(self, seed: int = 0, crash_at_step: Optional[int] = None):
        """Train from the newest checkpoint (or from ``seed``) to
        ``total_steps``; returns ``(params, opt, losses)``.  The step
        ``crash_at_step`` raises ``RuntimeError`` after its update and
        before its checkpoint."""
        params, opt, stream, start = self.restore_or_init(seed)
        t = self.tcfg
        losses = []
        for step in range(start, t.total_steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in stream.next_batch().items()}
            params, opt, m = self._step(params, opt, batch)
            loss = float(m["loss"])
            losses.append(loss)
            dt = time.time() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > t.straggler_factor * med:
                self.stragglers += 1
            if step % t.log_every == 0:
                self.metrics_log.append(
                    {"step": step, "loss": loss, "sec": dt})
            if crash_at_step is not None and step == crash_at_step:
                raise RuntimeError(f"injected crash at step {step}")
            if (step + 1) % t.ckpt_every == 0 or self._stop or \
                    step + 1 == t.total_steps:
                self._save(step, params, opt, stream)
            if self._stop:
                break
        if t.ckpt_async:
            self.ckpt.close()
        return params, opt, losses
