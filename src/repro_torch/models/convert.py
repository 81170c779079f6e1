"""Carry parameters and optimizer state across between the reference and
the port, both ways.

The reference's ``Model.init_params`` returns a tree of arrays; the
caller turns it into numpy (``tree_map(np.asarray, params)``), so this
module never sees the other framework.  Keys follow the reference's
``transformer.py``: ``embedding``, ``lm_head`` (untied), ``final_norm``
and ``units``, whose leaves carry a leading ``n_units`` axis: a
sublayer's ``ln1``, its mixer (``units.layer0.attn.wq``,
``units.layer0.mamba.a_log``, ``units.layer0.mlstm.b_f``,
``units.layer1.slstm.r_z``), in an encoder-decoder's decoder
``ln_cross`` and ``cross.{wq,wk,wv,wo}``, and, unless its ``ffn`` is
``"none"`` (no ``ln2`` then, as in xlstm-125m), ``ln2`` and ``mlp`` or
``moe`` (``units.layer0.moe.{router,wi_gate,wi_up,wo}``).  An
encoder-decoder also has ``encoder`` (``encoder.layer0.{ln1,attn,ln2,
mlp}``, its leaves stacked over ``n_enc_layers``) and ``enc_norm``; an
arch with a frontend ``frontend_proj``.  The port holds one parameter a
unit or encoder layer (``units.<u>.layer0.attn.wq``,
``encoder.<l>.layer0.attn.wq``); the tree stacks them.

- :func:`params_from_numpy` builds a serving ``Model`` (or, with
  ``train=True``, a ``TrainModel`` of float32 masters) from such a tree;
- :func:`params_to_numpy` is its inverse: the reference-keyed tree of a
  model's parameters (:func:`named_to_numpy` does the same for any
  tensors keyed by parameter name, gradients for one);
- :func:`opt_state_from_numpy` / :func:`opt_state_to_numpy` carry the
  AdamW state (``m``, ``v``, ``ef`` trees keyed like the parameters, and
  the int32 ``step``) between the reference's tree and the port's dicts
  keyed by parameter name.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .transformer import Model, TrainModel

AnyModel = Union[Model, TrainModel]


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[
        Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, name)
        else:
            yield name, np.asarray(val)


STACKS = ("units", "encoder")      # reference keys stacked on a leading axis


def stack_len(cfg: ModelConfig, key: str) -> int:
    """The length of a reference key's stacked axis: ``n_units`` for
    ``units.*``, ``n_enc_layers`` for ``encoder.*``, 0 for the rest."""
    head = key.split(".", 1)[0]
    return {"units": cfg.n_units, "encoder": cfg.n_enc_layers}.get(head, 0)


def _target(model: AnyModel, name: str, unit: int = -1) -> torch.nn.Parameter:
    """The port's parameter for a reference key (``units.layer0.attn.wq``
    with ``unit`` picking the slice of the stacked axis)."""
    parts = name.split(".")
    if parts[0] in STACKS:
        obj = getattr(model, parts[0])[unit]
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


def ref_key(port_name: str) -> Tuple[str, int]:
    """``(reference key, unit)`` of a port parameter name:
    ``embed.embedding`` -> ``("embedding", -1)``,
    ``units.3.layer0.attn.wq`` -> ``("units.layer0.attn.wq", 3)``,
    ``encoder.1.layer0.ln1`` -> ``("encoder.layer0.ln1", 1)``."""
    parts = port_name.split(".")
    if parts[0] == "embed":
        return parts[1], -1
    if parts[0] in STACKS:
        return ".".join(parts[:1] + parts[2:]), int(parts[1])
    return port_name, -1


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda", train: bool = False) -> AnyModel:
    """A port model holding the same numbers as the reference's parameter
    tree (numpy arrays): a serving ``Model``, each value rounded to the
    dtype it holds it in (``cfg.dtype`` for every leaf but the float32
    ``final_norm``: the reference's ``_cast_params`` of its stacked
    tree; ``enc_norm`` stays float32 too), or with
    ``train=True`` a ``TrainModel`` whose masters keep the tree's float32
    values.  Raises if a key or a shape does not match, or a port
    parameter is left unset."""
    cls = TrainModel if train else Model
    model = cls(cfg, device=device, init=False)
    load_params(model, tree)
    return model


def load_params(model: AnyModel, tree: Dict[str, Any]) -> AnyModel:
    """Copy a reference-keyed tree into ``model``'s parameters in place
    (the checks of :func:`params_from_numpy`); returns ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    unset = set(names.values())
    for name, arr in _leaves(tree):
        n = stack_len(model.cfg, name)
        if n and (arr.ndim < 1 or arr.shape[0] != n):
            raise ValueError(f"{name}: stacked over {arr.shape[:1]}, the "
                             f"port has {n}")
        for u in range(max(n, 1)):
            try:
                dst = _target(model, name, u)
            except (AttributeError, KeyError, IndexError) as e:
                raise KeyError(f"no port parameter for {name!r}") from e
            src = arr[u] if n else arr
            if tuple(dst.shape) != src.shape:
                raise ValueError(f"{name}: port shape {tuple(dst.shape)} != "
                                 f"{src.shape}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(src, np.float32)))
            unset.discard(names[id(dst)])
    if unset:
        raise KeyError(f"parameters not in the tree: {sorted(unset)[:8]}")
    return model


def named_to_numpy(named: Dict[str, torch.Tensor],
                   model: AnyModel) -> Dict[str, Any]:
    """Tensors keyed by ``model``'s parameter names (the parameters, their
    gradients, a moment) as the reference's nested tree of numpy arrays,
    unit (and encoder) leaves stacked on a leading axis."""
    flat: Dict[str, Any] = {}
    for name, t in named.items():
        key, unit = ref_key(name)
        arr = t.detach().cpu().numpy()
        if unit < 0:
            flat[key] = arr
        else:
            flat.setdefault(key, [None] * stack_len(model.cfg, key))[unit] = \
                arr
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(val) if isinstance(val, list) else val
    return tree


def params_to_numpy(model: AnyModel) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: every parameter of
    ``model`` as numpy, in the reference's tree (``units`` stacked)."""
    return named_to_numpy(dict(model.named_parameters()), model)


def opt_state_to_numpy(state: Dict[str, Any],
                       model: AnyModel) -> Dict[str, Any]:
    """The port's AdamW state (``m``/``v``/``ef``: dicts keyed by
    parameter name; ``step``) as the reference's ``init_state`` tree:
    ``m``/``v``/``ef`` keyed like the parameters, ``step`` a 0-d int32
    array."""
    out: Dict[str, Any] = {}
    for key, val in state.items():
        if key == "step":
            out[key] = np.asarray(torch.as_tensor(val).cpu().numpy(),
                                  np.int32).reshape(())
        else:
            out[key] = named_to_numpy(val, model)
    return out


def opt_state_from_numpy(tree: Dict[str, Any], model: AnyModel, *,
                         device=None) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_to_numpy`: the reference's AdamW
    state tree as the port's dicts keyed by ``model``'s parameter names
    (float32 tensors on ``device``, the model's by default) and ``step``
    a 0-d int32 tensor.  Raises if a leaf is missing or misshapen."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if key == "step":
            out[key] = torch.as_tensor(np.asarray(val, np.int32).reshape(()),
                                       device=device)
            continue
        leaves = dict(_leaves(val))
        group = {}
        for name, p in model.named_parameters():
            rk, unit = ref_key(name)
            if rk not in leaves:
                raise KeyError(f"{key}: no {rk!r} in the tree")
            arr = leaves[rk] if unit < 0 else leaves[rk][unit]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}.{rk}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            group[name] = torch.as_tensor(np.array(arr, np.float32),
                                          device=device)
        out[key] = group
    return out
