"""AdamW + schedules + gradient clipping/compression.

The port of ``repro/optim/adamw.py``.  Parameters, gradients and the
state's ``m``/``v``/``ef`` are dicts of tensors keyed alike (a model's
``param_dict()``: parameter name -> float32 master), ``step`` a 0-d
int32 tensor.  Every function runs under ``torch.no_grad()``.  Where the
reference returns new trees, :func:`update` writes the parameters,
``m``, ``v`` and ``ef`` in place (it saves a copy of the whole state:
2.79 B float32 parameters are 11 GB a tree) and returns the same dicts;
the arithmetic is the reference's, operation for operation, in float32.

Optional gradient compression (``bf16``, or ``int8_ef``: int8 with
error feedback) models the reduce-scatter wire format, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression: none | bf16 | int8_ef
    compression: str = "none"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio *
    lr`` at ``total_steps``; a 0-d float32 tensor."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                        - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def init_state(cfg: AdamWConfig, params: Tree) -> Dict[str, Any]:
    """Zero ``m`` and ``v`` (and ``ef`` under ``int8_ef``) in float32,
    keyed like ``params``, and ``step`` 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}

    device = next(iter(params.values())).device
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compression == "int8_ef":
        state["ef"] = zeros()
    return state


def _global_norm(tree: Tree) -> torch.Tensor:
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def compress_grads(cfg: AdamWConfig, grads: Tree,
                   state: Dict[str, Any]) -> Tuple[Tree, Dict[str, Any]]:
    """Apply the configured wire-format reduction to gradients; under
    ``int8_ef`` the quantisation error is kept in ``state["ef"]`` (in
    place) and added back before the next step's quantisation."""
    if cfg.compression == "bf16":
        return {k: g.to(torch.bfloat16).to(torch.float32)
                for k, g in grads.items()}, state
    if cfg.compression == "int8_ef":
        deq = {}
        for k, g in grads.items():
            g = g.to(torch.float32) + state["ef"][k]
            scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
            qg = torch.round(g / scale).to(torch.int8)
            deq[k] = qg.to(torch.float32) * scale
            state["ef"][k].copy_(g - deq[k])
        return deq, state
    if cfg.compression != "none":
        raise ValueError(f"unknown compression {cfg.compression!r}")
    return grads, state


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tree, state: Dict[str, Any],
           params: Tree) -> Tuple[Tree, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step: clip by the global norm, compress, then the
    bias-corrected moments and decoupled weight decay.  Writes
    ``params`` and the state in place, and clips float32 gradients in
    place too (a model's ``.grad``s: 11 GB not copied at the training
    cell's size); returns ``(params, state, {"lr",
    "grad_norm"})``, the last two 0-d float32 tensors."""
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if cfg.grad_clip > 0:
        norm = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale)
    grads, state = compress_grads(cfg, grads, state)

    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - _f32(cfg.b1, stepf) ** stepf
    b2c = 1 - _f32(cfg.b2, stepf) ** stepf
    for k, p in params.items():
        g, m, v = grads[k], state["m"][k], state["v"][k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": _global_norm(grads)}
