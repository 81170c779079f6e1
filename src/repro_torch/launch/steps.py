"""Step builders, abstract input specs and cell programs for every (arch
x shape) cell.

The port of ``repro/launch/steps.py``.  ``train_step`` (train_4k),
``prefill_step`` (prefill_32k) and ``decode_step`` (decode_32k /
long_500k) are the three programs the dry run accounts and the launcher
runs.  The port's models hold their weights, so the steps close over the
model: ``train_step`` takes the model's parameter dict
(``TrainModel.param_dict()``) and updates it in place; the serving steps
take no parameters.

The abstract inputs are tensors on the ``meta`` device (the reference's
``ShapeDtypeStruct``s): shapes and dtypes, no storage.  :func:`build_cell`
builds a cell's :class:`CellProgram` on them: the config, the sharding
rules over a :class:`~repro_torch.parallel.sharding.Mesh`, the model's
hints, every argument's per-leaf specs and the step builder.

The program runs (:meth:`CellProgram.materialize`, :meth:`CellProgram.run`)
on a mesh of one device as it stands, and on a mesh of more than one as
explicit SPMD: one process a device, each joined to the mesh's process
group (:func:`repro_torch.parallel.group.init_mesh_group`) and holding
only its shards of the parameters (each cut as it is drawn, so no rank
holds the whole model), the cache and the batch, on plain local tensors.
The serving steps of the dense decoder, the MoE archs and jamba run so:
each layer's FSDP weights all-gathered over the data axes just before
use, the attention on the rank's heads (the flash kernel on local q, k
and v), Mamba on the rank's inner channels, the MoE layer on the rank's
experts (its tokens routed alike on every rank of the model axis, its
capacity groups those of the rank's own tokens), an all-reduce over the
model axis after each row-parallel product (``wo``, Mamba's ``x_proj``
and ``out_proj``, the experts' combine) and after the
vocabulary-parallel embedding lookup, the logits left split over the
vocabulary.  What else a mesh would need raises ``NotImplementedError``
naming its ROADMAP item (:func:`mesh_refusal`).
:meth:`CellProgram.trace` runs rank 0's step on ``meta`` tensors through
recording collectives: the dry run's collective bytes and FLOPs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MambaConfig, ModelConfig, ShapeConfig
from repro_torch.models.layers import on_draw
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import TP_AXES, Collectives, Spmd
from repro_torch.parallel.group import MeshGroup, local_shard
from repro_torch.parallel.sharding import (P, Mesh, ShardingRules,
                                           device_bytes, leaves,
                                           param_blocks)
from repro_torch.pmwcas import resolve_device

# what a mesh of more than one device does not run yet, by ROADMAP item
MULTI_CARD = {
    "train": "a training step on a mesh of more than one device is not "
             "ported yet (ROADMAP Queue 1 A #8.2: llama3-8b's train_4k on "
             "four cards)",
    "split": "a cache sharded over its sequence, or heads, the MLP's "
             "width, the vocabulary, the experts or Mamba's channels that "
             "do not split evenly over the model axis, is not ported yet "
             "(ROADMAP Queue 1 A #8.3)",
    "stacks": "xLSTM, encoder-decoder and vision-prefix stacks on a mesh "
              "of more than one device are not ported yet (ROADMAP Queue 1 "
              "A #8.4)",
}

# which per-device byte count each argument of a step falls under
ARG_GROUPS = {"params": "params", "opt_state": "opt_state",
              "cache": "cache", "batch": "batch", "tokens": "batch",
              "token": "batch", "frontend_embeds": "batch"}


# ---------------------------------------------------------------------------
# Cell = (arch config, shape config) + numeric policy decisions
# ---------------------------------------------------------------------------

def cell_model_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-cell numeric policy (the reference's rule): qwen1.5-32b's
    decode cells keep an int8 KV cache."""
    if shape.is_decode and cfg.name == "qwen1.5-32b":
        return dataclasses.replace(cfg, kv_dtype="int8")
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frames(cfg: ModelConfig, B: int) -> torch.Tensor:
    return _meta((B, cfg.frontend_len, cfg.frontend_dim), torch.float32)


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A training batch as ``meta`` tensors: ``tokens``/``labels [B, S]``
    int32, and ``frontend_embeds [B, frontend_len, frontend_dim]`` float32
    for an arch with a frontend."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = _frames(cfg, B)
    return specs


def abstract_model(cfg: ModelConfig, train: bool = False):
    """The serving ``Model`` (or the ``TrainModel``) of ``cfg`` on the
    ``meta`` device: every parameter's shape and dtype, no storage."""
    return (TrainModel if train else Model)(cfg, device="meta", init=False)


def abstract_cache(model: Model, batch: int, max_len: int) -> Dict[str, Any]:
    """``model.init_cache(batch, max_len)`` as ``meta`` tensors (the
    index stays the int 0)."""
    if model.device.type != "meta":
        model = abstract_model(model.cfg)
    return model.init_cache(batch, max_len)


def prefill_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The prefill cache's positions: the prompt, and a vision prefix
    before it (an encoder-decoder's frames are not in the cache)."""
    return shape.seq_len + (cfg.frontend_len if cfg.frontend != "none"
                            and not cfg.enc_dec else 0)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Optional[Model] = None) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell: ``batch``
    (train); ``tokens``, ``cache`` and ``frontend_embeds`` (prefill);
    ``token [B, 1]`` and ``cache`` of ``seq_len`` positions (decode)."""
    cfg = cell_model_config(cfg, shape)
    B = shape.global_batch
    if shape.mode == "train":
        return {"batch": abstract_batch(cfg, shape)}
    model = model or abstract_model(cfg)
    if shape.mode == "prefill":
        out = {"tokens": _meta((B, shape.seq_len), torch.int32),
               "cache": abstract_cache(model, B, prefill_len(cfg, shape))}
        if cfg.frontend != "none":
            out["frontend_embeds"] = _frames(cfg, B)
        return out
    return {"token": _meta((B, 1), torch.int32),
            "cache": abstract_cache(model, B, shape.seq_len)}


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


# ---------------------------------------------------------------------------
# The program of one cell
# ---------------------------------------------------------------------------

GROUPS = ("params", "opt_state", "cache", "batch")


@dataclasses.dataclass
class CellState:
    """A materialized cell: the model, the step over it, and the step's
    keyword arguments (``run`` calls ``step(**args)``; the cache and the
    parameters are updated in place)."""
    model: Union[Model, TrainModel]
    step: Callable
    args: Dict[str, Any]

    def held_bytes(self) -> Dict[str, int]:
        """Bytes the materialized tensors take, grouped as
        :meth:`CellProgram.argument_bytes`: the model's parameters, the
        optimizer state, the cache and the batch, and ``total``."""
        out = dict.fromkeys(GROUPS, 0)
        out["params"] = sum(p.numel() * p.element_size()
                            for p in self.model.parameters())
        for arg, tree in self.args.items():
            if arg == "params":            # the model's, counted above
                continue
            tree = tree if isinstance(tree, dict) else {"": tree}
            out[ARG_GROUPS[arg]] += sum(t.numel() * t.element_size()
                                        for _, t in leaves(tree))
        out["total"] = sum(out.values())
        return out


@dataclasses.dataclass
class CellProgram:
    """One cell's program: ``cfg`` after :func:`cell_model_config`, the
    rules and the model's ``hints``; ``args``, the program's arguments as
    ``meta`` tensors: ``params`` (the parameters by name: the training
    masters, or the serving ``Model``'s, which the serving steps close
    over), then the step's own, ``opt_state`` and ``batch`` when
    training, ``tokens``, ``cache`` and ``frontend_embeds`` at prefill,
    ``token`` and ``cache`` at decode; ``specs``, for each argument the
    spec of each of its tensors by path, as
    :func:`~repro_torch.parallel.sharding.leaves` walks it; and
    ``make_step``, the step builder, given the model."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    rules: ShardingRules
    hints: Dict[str, Any]
    mode: str
    args: Dict[str, Any]
    specs: Dict[str, Dict[str, P]]
    make_step: Callable
    opt_cfg: Optional[adamw.AdamWConfig] = None

    def arg_leaves(self):
        """``(argument, path, meta tensor, spec)`` of every tensor of the
        program's arguments."""
        for arg, tree in self.args.items():
            tree = tree if isinstance(tree, dict) else {"": tree}
            for path, t in leaves(tree):
                yield arg, path, t, self.specs[arg][path]

    def argument_bytes(self) -> Dict[str, int]:
        """Bytes of the program's arguments one device holds, by group
        (``params``, ``opt_state``, ``cache``, ``batch``) and ``total``:
        each tensor's bytes under its spec on the mesh, in the dtype the
        port holds it in (the serving ``Model``'s ``cfg.dtype``, the
        training masters' float32).  Raises ``ValueError`` if a spec
        does not divide its tensor (none does, by the rules' fitting)."""
        out = dict.fromkeys(GROUPS, 0)
        for arg, _, t, spec in self.arg_leaves():
            out[ARG_GROUPS[arg]] += device_bytes(t.shape, t.element_size(),
                                                 spec, self.mesh)
        out["total"] = sum(out.values())
        return out

    def _check_group(self, group) -> None:
        """Raise unless ``group`` is a rank of this program's mesh (or
        None on a mesh of one device) and the program runs there."""
        if group is None:
            if self.mesh.size > 1:
                raise ValueError(f"the mesh {self.mesh.shape} has "
                                 f"{self.mesh.size} devices: pass the rank's "
                                 f"group (parallel.group.init_mesh_group)")
            return
        if group.mesh != self.mesh:
            raise ValueError(f"the group's mesh {group.mesh.shape} "
                             f"({group.mesh.size} ranks) is not the "
                             f"program's {self.mesh.shape}")
        reason = mesh_refusal(self)
        if reason:
            raise NotImplementedError(f"{self.cfg.name} {self.shape.name} on "
                                      f"{self.mesh.shape}: {reason}")

    def _shard(self, name: str, t: torch.Tensor, group, dev=None):
        return local_shard(t.detach(), self.specs["params"][name], group,
                           dev, blocks=param_blocks(name))

    def _local_model(self, model, dev, seed: int, group) -> Model:
        """A serving ``Model`` holding this rank's shard of every
        parameter of ``model``, or of ``Model(cfg, device=dev,
        seed=seed)``: every mesh computes with the same global weights.
        That one is drawn one weight at a time from its generator, in the
        model's order, each cut to this rank's shard as it is made
        (:func:`~repro_torch.models.layers.on_draw`) and the rest of it
        freed before the next draw: the whole model is never held (jamba
        at 32 layers is 103 GB of bf16).  The draws' names come from the
        same construction on ``meta`` (each made tensor's storage is its
        parameter's; a draw that is not raises ``RuntimeError`` before
        anything is drawn); what no draw makes (the norms, the attention
        biases, Mamba's ``a_log``) is cut after."""
        if model is not None:
            return model_holding(self.cfg, {
                name: self._shard(name, t, group, dev)
                for name, t in model.named_parameters()})
        made = []
        with on_draw(lambda t: made.append(t) or t):
            shapes = Model(self.cfg, device="meta", init=False)
        name_of = {p.untyped_storage()._cdata: name
                   for name, p in shapes.named_parameters()}
        names = [name_of.get(t.untyped_storage()._cdata) for t in made]
        if None in names:       # reshaped or stacked into its parameter
            raise RuntimeError(f"{self.cfg.name}: draw {names.index(None)} "
                               f"is no parameter's own tensor, so it "
                               f"cannot be cut as it is made")
        order, cut = iter(names), set()

        def take(t):
            name = next(order)
            cut.add(name)
            return self._shard(name, t, group)

        with on_draw(take):
            drawn = Model(self.cfg, device=dev, seed=seed,
                          init=dev.type != "meta")
        return model_holding(self.cfg, {
            name: t.detach() if name in cut else self._shard(name, t, group)
            for name, t in drawn.named_parameters()})

    def materialize(self, device="cuda", seed: int = 0, model=None,
                    group=None, cache=None) -> CellState:
        """The model and its inputs on ``device``: ``model`` (of this
        cell's config and kind, its weights kept) or one drawn from
        ``seed`` there; tokens (and labels) drawn with numpy from
        ``seed`` (the same on every device), frontend embeddings ``0.02 *``
        a standard normal, a fresh cache (``init_cache``: zeros, index 0),
        AdamW's zero state.

        ``group`` (a :class:`~repro_torch.parallel.group.MeshGroup` of
        this program's mesh; needed on a mesh of more than one device)
        makes this rank's part: the model's parameters cut to the rank's
        shards (a full ``model`` given, on any device, or drawn whole from
        ``seed`` first), the tokens cut to its requests, a cache of its
        requests and kv heads, and the model's ``par``, the rank's
        :class:`~repro_torch.parallel.collectives.Spmd` (its collectives
        record into ``par.coll.records``).  On ``meta`` (the dry run's
        trace) nothing is drawn.  ``cache`` (a serving step's whole cache,
        filled) is held in place of a fresh one: its tensors cut to this
        rank's shards (on one device, the tensors themselves: nothing is
        copied).  Raises ``NotImplementedError`` for what a mesh does not
        run yet (:func:`mesh_refusal`)."""
        self._check_group(group)
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        cfg, B, S = self.cfg, self.shape.global_batch, self.shape.seq_len
        if group is not None and self.mesh.size > 1:
            model = self._local_model(model, dev, seed, group)
        elif model is None:
            cls = TrainModel if self.mode == "train" else Model
            model = cls(cfg, device=dev, seed=seed, init=dev.type != "meta")
        model.hints = dict(self.hints)
        if group is not None:
            model.par = Spmd(Collectives(group), self.specs["params"])
            if "moe_groups" in self.hints:   # the groups of its own tokens
                model.hints["moe_groups"] //= self._batch_shards()
        rng = np.random.default_rng(seed)

        def tokens(*shape):
            if dev.type == "meta":
                t = torch.empty(shape, dtype=torch.int32, device=dev)
            else:
                t = torch.from_numpy(rng.integers(
                    0, cfg.vocab, shape, dtype=np.int32)).to(dev)
            # every input of this program is sharded over its batch only
            return t if group is None else local_shard(
                t, self.rules.batch_pspecs({"": t})[""], group)

        def frames():
            return torch.from_numpy(0.02 * rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim),
                dtype=np.float32)).to(dev)

        if self.mode == "train":
            params = model.param_dict()
            batch = {"tokens": tokens(B, S), "labels": tokens(B, S)}
            if cfg.frontend != "none":
                batch["frontend_embeds"] = frames()
            args = {"params": params,
                    "opt_state": adamw.init_state(self.opt_cfg, params),
                    "batch": batch}
        elif self.mode == "prefill":
            args = {"tokens": tokens(B, S)}
            args["cache"] = self._cache(
                cache, group, model, args["tokens"].shape[0],
                prefill_len(cfg, self.shape))
            if cfg.frontend != "none":
                args["frontend_embeds"] = frames()
        else:
            args = {"token": tokens(B, 1)}
            args["cache"] = self._cache(cache, group, model,
                                        args["token"].shape[0], S)
        return CellState(model, self.make_step(model), args)

    def _batch_shards(self) -> int:
        """The ways the step's requests are split over the mesh."""
        return self.rules.axis_size(
            self.rules.batch_spec(self.shape.global_batch) or ())

    def _cache(self, cache, group, model, batch: int, length: int):
        """``cache`` with each tensor cut to this rank's shard (the same
        nesting; the index kept), or the model's fresh one."""
        if cache is None:
            return model.init_cache(batch, length)
        specs = self.specs["cache"]

        def cut(tree, prefix):
            out = {}
            for key, val in tree.items():
                path = f"{prefix}/{key}" if prefix else key
                if isinstance(val, dict):
                    out[key] = cut(val, path)
                elif isinstance(val, torch.Tensor) and group is not None:
                    out[key] = local_shard(val, specs[path], group)
                else:
                    out[key] = val
            return out
        return cut(cache, "")

    def run(self, state: CellState):
        """One step: ``state.step(**state.args)`` (the serving steps under
        ``torch.inference_mode``); on a mesh of more than one device, this
        rank's part of it (``state`` materialized with its group)."""
        if self.mesh.size > 1 and getattr(state.model, "par", None) is None:
            raise ValueError("a step on a mesh of more than one device runs "
                             "on a state materialized with the rank's group")
        if self.mode == "train":
            return state.step(**state.args)
        with torch.inference_mode():
            return state.step(**state.args)

    def trace(self):
        """Rank 0's step on ``meta`` tensors (every other rank issues the
        same collectives at the same shapes): ``(records, flops)``, the
        collectives it issues (:class:`~repro_torch.parallel.collectives.
        Record`) and the FLOPs ``FlopCounterMode`` counts, the flash
        kernel's as the two products of a dense attention.  Raises
        ``NotImplementedError`` where the program does not run on this
        mesh."""
        from torch.utils.flop_counter import FlopCounterMode
        state = self.materialize("meta", group=MeshGroup.trace(self.mesh))
        with FlopCounterMode(display=False) as counter:
            self.run(state)
        return state.model.par.coll.records, counter.get_total_flops()


def model_holding(cfg: ModelConfig, params: Dict[str, torch.Tensor]
                  ) -> Model:
    """A serving ``Model`` of ``cfg`` whose parameters are ``params`` (by
    name, every one; any shapes: a rank's shards, or tensors gathered
    whole), nothing drawn."""
    model = Model(cfg, device="meta", init=False)
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = nn.Parameter(t, requires_grad=False)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = p
        else:
            setattr(mod, leaf, p)
    return model


def mesh_refusal(cell: CellProgram, any_mesh: bool = False
                 ) -> Optional[str]:
    """Why ``cell`` does not run on its mesh yet (naming the ROADMAP item),
    or None: a mesh of one device runs every cell; a larger one runs the
    prefill and decode of a stack of attention, Mamba, dense MLP and MoE
    layers (the dense decoder, granite-moe, qwen3-moe, jamba) where the
    heads, the MLP's width, the vocabulary, the experts and Mamba's inner
    channels split evenly over the model axis, no cache is sharded over
    its sequence, and the MoE capacity groups fall on the requests'
    split.  ``any_mesh`` judges a one-device mesh as a larger one (the
    dry run traces only what runs on every mesh)."""
    if cell.mesh.size == 1 and not any_mesh:
        return None
    cfg = cell.cfg
    if cell.mode == "train":
        return MULTI_CARD["train"]
    if cfg.enc_dec or cfg.frontend != "none" or any(
            s.kind not in ("attn", "mamba") for s in cfg.unit):
        return MULTI_CARD["stacks"]
    tp = cell.rules.axis_size(TP_AXES)
    widths = [cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.padded_vocab]
    if cfg.moe is not None:
        widths.append(cfg.moe.n_experts)
    if any(s.kind == "mamba" for s in cfg.unit):
        widths.append((cfg.mamba or MambaConfig()).expand * cfg.d_model)
    if cell.rules.model_candidates[0] != TP_AXES or any(
            n % tp for n in widths):
        return MULTI_CARD["split"]
    if any(path.rsplit("/", 1)[-1] in ("k", "v", "k_scale", "v_scale")
           and spec[3] is not None
           for path, spec in cell.specs["cache"].items()):
        return MULTI_CARD["split"]          # a K/V cache over its sequence
    groups, shards = cell.hints.get("moe_groups", 1), cell._batch_shards()
    if cfg.moe is not None and cell.mode == "prefill" and shards > 1 and (
            groups % shards or cell.shape.global_batch
            * cell.shape.seq_len % groups):
        return MULTI_CARD["split"]
    return None


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               opt_cfg: Optional[adamw.AdamWConfig] = None,
               rules: Optional[ShardingRules] = None,
               remat: bool = True) -> CellProgram:
    """The cell's program on ``mesh``: the config after
    :func:`cell_model_config`, the rules (the defaults on ``mesh`` unless
    given), the hints (``activation_hints``; the residual stream
    sequence-sharded only when training), and the specs of every
    argument: parameters by the rules, AdamW's ``m``/``v``/``ef`` as their
    parameter and its ``step`` replicated, the batch and the tokens over
    the batch axes, the cache by the rules."""
    cfg = cell_model_config(cfg, shape)
    rules = rules or ShardingRules(mesh=mesh, cfg=cfg)
    train = shape.mode == "train"
    hints = rules.activation_hints(shape.global_batch, shape.seq_len,
                                   use_seq_sharding=train)
    model = abstract_model(cfg, train=train)
    named = dict(model.named_parameters())
    pspecs = rules.params_pspecs(named)
    inputs = input_specs(cfg, shape, None if train else model)
    if train:
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        opt_state = adamw.init_state(opt_cfg, named)
        ospecs = {"step": P()}
        for k in opt_state:
            if k != "step":
                ospecs.update({f"{k}/{n}": s for n, s in pspecs.items()})
        args = {"params": named, "opt_state": opt_state, **inputs}
        specs = {"params": pspecs, "opt_state": ospecs,
                 "batch": rules.batch_pspecs(inputs["batch"])}
        make_step = functools.partial(make_train_step, opt_cfg=opt_cfg,
                                      remat=remat)
    else:
        args = {"params": named, **inputs}
        specs = {"params": pspecs,
                 "cache": rules.cache_pspecs(inputs["cache"])}
        for name, t in inputs.items():
            if name != "cache":      # the tokens and the frames
                specs[name] = {"": rules.batch_pspecs({name: t})[name]}
        make_step = (make_prefill_step if shape.mode == "prefill"
                     else make_decode_step)
    return CellProgram(cfg, shape, mesh, rules, hints, shape.mode, args,
                       specs, make_step, opt_cfg)


__all__ = ["CellProgram", "CellState", "abstract_batch", "abstract_cache",
           "abstract_model", "build_cell", "cell_model_config",
           "input_specs", "make_decode_step", "make_prefill_step",
           "make_train_step", "mesh_refusal", "model_holding",
           "prefill_len"]
