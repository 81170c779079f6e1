"""Carry the reference's parameters across to the port.

The reference's ``Model.init_params`` returns a tree of arrays; the
caller turns it into numpy (``tree_map(np.asarray, params)``), so this
module never sees the other framework.  Keys follow the reference's
``transformer.py``: ``embedding``, ``lm_head`` (untied), ``final_norm``
and ``units``, whose leaves carry a leading ``n_units`` axis.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .transformer import Model


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[
        Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, name)
        else:
            yield name, np.asarray(val)


def _target(model: Model, name: str, unit: int = -1) -> torch.nn.Parameter:
    """The port's parameter for a reference key (``units.layer0.attn.wq``
    with ``unit`` picking the slice of the stacked axis)."""
    parts = name.split(".")
    if parts[0] == "units":
        obj = model.units[unit]
        parts = parts[1:]
    elif parts[0] in ("embedding", "lm_head"):
        return model.embed[parts[0]]
    else:
        obj = model
    for part in parts:
        obj = obj[part] if isinstance(obj, (torch.nn.ModuleDict,
                                            torch.nn.ParameterDict)) \
            else getattr(obj, part)
    return obj


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> Model:
    """A port ``Model`` holding the same numbers as the reference's
    parameter tree (numpy arrays).  Each value is cast to the dtype the
    port holds it in (``cfg.dtype`` for 2-D and wider weights).  Raises
    if a key or a shape does not match, or a port parameter is left
    unset."""
    model = Model(cfg, device=device, init=False)
    names = {id(p): n for n, p in model.named_parameters()}
    unset = set(names.values())
    for name, arr in _leaves(tree):
        stacked = name.startswith("units.")
        for u in range(cfg.n_units if stacked else 1):
            try:
                dst = _target(model, name, u)
            except (AttributeError, KeyError) as e:
                raise KeyError(f"no port parameter for {name!r}") from e
            src = arr[u] if stacked else arr
            if tuple(dst.shape) != src.shape:
                raise ValueError(f"{name}: port shape {tuple(dst.shape)} != "
                                 f"{src.shape}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(src, np.float32)))
            unset.discard(names[id(dst)])
    if unset:
        raise KeyError(f"parameters not in the tree: {sorted(unset)[:8]}")
    return model
