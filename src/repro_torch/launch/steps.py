"""Step builders for every (arch x shape) cell.

The port of ``repro/launch/steps.py``.  ``train_step`` (train_4k),
``prefill_step`` (prefill_32k) and ``decode_step`` (decode_32k /
long_500k) are the three programs the launcher runs.  The port's models
hold their weights, so the steps close over the model: ``train_step``
takes the model's parameter dict (``TrainModel.param_dict()``) and
updates it in place; the serving steps take no parameters.

The reference's abstract input specs and sharded programs
(``abstract_batch``, ``input_specs``, ``build_cell``, ``CellProgram``)
serve its dry-run and sharding, which the port has not yet: they raise
``NotImplementedError`` naming that item.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.optim import adamw

DRYRUN = ("the dry-run and sharding (parallel/sharding.py, launch/dryrun.py)"
          " are not ported yet (ROADMAP Queue 1 A #6)")


def cell_model_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-cell numeric policy: int8 KV where bf16 cannot fit 16 GB/chip
    (the reference's rule)."""
    if shape.is_decode and cfg.name == "qwen1.5-32b":
        return dataclasses.replace(cfg, kv_dtype="int8")
    return cfg


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig):
    raise NotImplementedError(f"abstract_batch: {DRYRUN}")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model=None):
    raise NotImplementedError(f"input_specs: {DRYRUN}")


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_cfg=None,
               rules=None, remat: bool = True):
    raise NotImplementedError(f"build_cell: {DRYRUN}")


class CellProgram:
    def __init__(self, *a, **kw):
        raise NotImplementedError(f"CellProgram: {DRYRUN}")


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def make_train_step(model, opt_cfg: adamw.AdamWConfig, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss of ``model.train_loss(batch, remat)``, its
    backward into the masters' ``.grad``, one AdamW update in place (the
    gradients are then dropped).  ``params`` is ``model.param_dict()``;
    ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` as 0-d
    tensors."""
    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        for p in params.values():
            p.grad = None
        loss = model.train_loss(batch, remat=remat)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        params, opt_state, info = adamw.update(opt_cfg, grads, opt_state,
                                               params)
        for p in params.values():
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), **info}

    return train_step


def make_prefill_step(model):
    """``prefill_step(tokens, cache, frontend_embeds=None)``: the model's
    prefill; an arch with a frontend takes its embeddings (the encoder's
    frames, or a vision prefix)."""
    def prefill_step(tokens, cache, frontend_embeds=None):
        return model.prefill(tokens, cache, frontend_embeds)

    return prefill_step


def make_decode_step(model):
    def decode_step(token, cache):
        return model.decode_step(token, cache)

    return decode_step


__all__ = ["CellProgram", "abstract_batch", "build_cell", "cell_model_config",
           "input_specs", "make_decode_step", "make_prefill_step",
           "make_train_step"]
