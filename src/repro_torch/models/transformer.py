"""Model assembly: embeddings -> unit stack -> logits, for serving and
for training.

The port of ``repro/models/transformer.py`` for the decoder-only
attention archs: dense (llama3, gemma2 with local windows and softcaps,
glm4 with partial rotary, qwen1.5 with QKV bias) and MoE (qwen3-moe,
granite-moe: ``ffn="moe"``, :mod:`repro_torch.models.moe`).  Both models
are ``nn.Module``s of one layout: ``units`` is an ``nn.ModuleList`` of
units, each an ``nn.ModuleDict`` of ``layer{i}`` sublayers, beside the
embedding (and the untied ``lm_head``) and the final norm.

``Model`` serves.  It holds what the reference serves with: its
``prefill``/``decode_step`` cast every floating leaf of two or more
dimensions to the compute dtype on every call (``_cast_params``), and
the reference stacks a unit's leaves over the units, so every unit leaf
(norm weights, QKV biases and the MoE router too), the embedding and
``lm_head`` are held in ``cfg.dtype``; only the final norm stays
float32.  The port casts once, at load.  The stack runs the units in a
Python loop (the reference's ``lax.scan``) and the forward only: serve
under ``torch.inference_mode()``.  A prefill's MoE layers take the
capacity path, a decode step's (one token a sequence) the dense one, as
in the reference; the aux loss is dropped.

``TrainModel`` trains (``train_loss``).  Its weights are the float32
masters in ``cfg.param_dtype`` with ``requires_grad``, cast to
``cfg.dtype`` on every call as the reference's ``train_loss`` casts its
tree, by the same rule: every unit leaf, the embedding and ``lm_head``;
the final norm stays float32.  The gradients reach the masters through
the casts.  With ``remat`` every unit is a ``torch.utils.checkpoint``
region (the reference's ``jax.checkpoint`` with ``nothing_saveable``):
its forward, attention kernel included, runs again in the backward, and
it returns its MoE aux loss beside the activations.  With ``cfg.moe``
the loss adds ``aux_loss_weight * sum(aux) / n_layers``.

Mamba and xLSTM sublayers, encoder-decoder stacks and modality
frontends raise ``NotImplementedError`` (ROADMAP Queue 1 #8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from .layers import (KeyGen, apply_mlp, cross_entropy, dtype_of,
                     embed_tokens, init_embed, init_mlp, rms_norm, unembed)

LATER = "not ported yet (ROADMAP Queue 1 #8)"


def _param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _params(d: Dict[str, torch.Tensor],
            trainable: bool = False) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, trainable) for k, v in d.items()})


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder stacks are "
                                  f"{LATER}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"is {LATER}")
    for spec in cfg.unit:
        if spec.kind != "attn":
            raise NotImplementedError(f"{cfg.name}: {spec.kind} layers are "
                                      f"{LATER}")
    for spec in cfg.unit:
        if spec.ffn not in ("dense", "moe"):
            raise NotImplementedError(f"{cfg.name}: ffn={spec.ffn!r} is "
                                      f"{LATER}")
        if spec.ffn == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: ffn='moe' without cfg.moe")
    if cfg.kv_dtype != "bfloat16":
        raise NotImplementedError(f"{cfg.name}: the {cfg.kv_dtype} KV cache "
                                  f"is {LATER}")


class Layer(nn.Module):
    """One pre-norm sublayer: attention, then the dense gated MLP
    (``mlp``) or the MoE layer (``moe``).  Every weight, norm and bias is
    held in ``dtype`` (the MoE router drawn in float32 first, as in the
    reference); ``trainable`` sets ``requires_grad`` on every one."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 kg: Optional[KeyGen], device, mode: str,
                 dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        self.ln1 = _param(torch.zeros(cfg.d_model, dtype=dtype,
                                      device=device), trainable)
        self.attn = _params(attn_mod.init_attention(
            kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dtype, cfg.qkv_bias, mode=mode,
            device=device), trainable)
        self.ln2 = _param(torch.zeros(cfg.d_model, dtype=dtype,
                                      device=device), trainable)
        if spec.ffn == "moe":
            self.moe = _params(moe_mod.init_moe(
                kg, cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff, dtype,
                router_dtype=dtype, mode=mode, device=device), trainable)
        else:
            self.mlp = _params(init_mlp(kg, cfg.d_model, cfg.d_ff, dtype,
                                        mode=mode, device=device), trainable)

    def weights(self, spec: LayerSpec, dtype=None) -> Dict[str, Any]:
        """The mapping :func:`apply_layer` reads, every leaf cast to
        ``dtype`` when given."""
        ffn = "moe" if spec.ffn == "moe" else "mlp"
        cast = (lambda w: w) if dtype is None else (lambda w: w.to(dtype))
        return {"ln1": cast(self.ln1), "ln2": cast(self.ln2),
                "attn": {k: cast(w) for k, w in self.attn.items()},
                ffn: {k: cast(w) for k, w in getattr(self, ffn).items()}}


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x, *, positions,
                layer_cache=None, cache_index: int = 0):
    """One sublayer's forward: ``p`` maps ``ln1``, ``attn``, ``ln2`` and
    ``mlp`` or ``moe`` to the weights (:meth:`Layer.weights`).  Returns
    ``(x, aux)``: the MoE layer's aux loss (a float32 tensor; 0 after a
    decode step's dense path), 0.0 after a dense MLP."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if spec.attn_type == "local" else 0
    chunk = cfg.decode_chunk if h.shape[1] == 1 else cfg.attn_chunk
    y, _ = attn_mod.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        window=window, rotary_fraction=cfg.rotary_fraction,
        rope_theta=cfg.rope_theta, attn_cap=cfg.attn_softcap,
        impl=cfg.attn_impl, chunk=chunk, layer_cache=layer_cache,
        cache_index=cache_index)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.ffn != "moe":
        return x + apply_mlp(p["mlp"], h, cfg.act), 0.0
    if h.shape[1] == 1:          # decode: the dropless all-experts path
        y, aux = moe_mod.apply_moe_dense(p["moe"], h, top_k=cfg.moe.top_k,
                                         act=cfg.act)
    else:
        y, aux = moe_mod.apply_moe(
            p["moe"], h, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.act)
    return x + y, aux


class Model(nn.Module):
    """``Model(cfg, device=..., seed=...)`` draws random weights from a
    ``torch.Generator`` on ``device`` seeded with ``seed``;
    ``init=False`` only allocates them (see
    :func:`repro_torch.models.convert.params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 init: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        device = torch.device(device)
        kg = KeyGen(seed, device) if init else None
        mode = "normal" if init else "empty"
        self.embed = _params(init_embed(kg, cfg.padded_vocab, cfg.d_model,
                                        self.dtype, cfg.tie_embeddings,
                                        mode=mode, device=device))
        self.units = nn.ModuleList(
            nn.ModuleDict({f"layer{i}": Layer(cfg, spec, kg, device, mode,
                                              self.dtype)
                           for i, spec in enumerate(cfg.unit)})
            for _ in range(cfg.n_units))
        self.final_norm = _param(torch.zeros(cfg.d_model, device=device))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Decode cache: one bf16 ``[n_units, B, KV, max_len, hd]`` pair
        per unit position, and the write index."""
        cfg = self.cfg
        layers = {}
        for i in range(len(cfg.unit)):
            c = attn_mod.init_kv_cache(batch, cfg.n_kv_heads, max_len,
                                       cfg.resolved_head_dim, cfg.kv_dtype,
                                       cfg.n_units, device=self.device)
            c.pop("index")
            layers[f"layer{i}"] = c
        return {"layers": layers, "index": 0}

    # ---------------------------------------------------------------- stack
    def _run_units(self, x, *, positions, cache, cache_index):
        for u, unit in enumerate(self.units):
            for i, spec in enumerate(self.cfg.unit):
                name = f"layer{i}"
                c = cache["layers"][name]
                x, _ = apply_layer(       # serving drops the aux loss
                    self.cfg, spec, unit[name].weights(spec), x,
                    positions=positions,
                    layer_cache={"k": c["k"][u], "v": c["v"][u]},
                    cache_index=cache_index)
        return x

    # ----------------------------------------------------------- entrypoints
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, Any]):
        """Process a full prompt ``tokens [B, S]``, filling the cache in
        place.  Returns (logits of the last position [B, V] f32, cache)."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg.scale_embed, cfg.d_model,
                         self.dtype)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        x = self._run_units(x, positions=positions, cache=cache,
                            cache_index=0)
        cache["index"] = S
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        logits = unembed(self.embed, x, cfg.logit_softcap, cfg.vocab)
        return logits[:, 0], cache

    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]):
        """token: [B, 1] -> (logits [B, V] f32, the cache, updated in
        place)."""
        cfg = self.cfg
        idx = cache["index"]
        x = embed_tokens(self.embed, token, cfg.scale_embed, cfg.d_model,
                         self.dtype)
        positions = idx + torch.arange(1, device=x.device)
        x = self._run_units(x, positions=positions, cache=cache,
                            cache_index=idx)
        cache["index"] = idx + 1
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = unembed(self.embed, x, cfg.logit_softcap, cfg.vocab)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> Model:
    return Model(cfg, device=device, seed=seed)


class TrainModel(nn.Module):
    """The training model: float32 masters (``cfg.param_dtype``) with
    ``requires_grad``, in :class:`Model`'s layout.  ``TrainModel(cfg,
    device=..., seed=...)`` draws them from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (:meth:`init_params`); ``init=False``
    only allocates them (see
    :func:`repro_torch.models.convert.params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 init: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        pdt = dtype_of(cfg.param_dtype)
        device = torch.device(device)
        self.embed = _params(init_embed(None, cfg.padded_vocab, cfg.d_model,
                                        pdt, cfg.tie_embeddings,
                                        mode="empty", device=device), True)
        self.units = nn.ModuleList(
            nn.ModuleDict({f"layer{i}": Layer(cfg, spec, None, device,
                                              "empty", pdt, trainable=True)
                           for i, spec in enumerate(cfg.unit)})
            for _ in range(cfg.n_units))
        self.final_norm = _param(torch.zeros(cfg.d_model, device=device),
                                  True)
        if init:
            self.init_params(seed)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def param_dict(self) -> Dict[str, torch.Tensor]:
        """Every master by its parameter name (the optimizer's tree)."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
        """Draw every master in place from a ``torch.Generator`` on the
        model's device seeded with ``seed``, in :class:`Model`'s order
        (embedding, ``lm_head``, then each unit's ``wq wk wv wo`` and
        ``wi_gate wi_up wo``, or the MoE layer's ``router wi_gate wi_up
        wo``), so a :class:`Model` of the same seed holds these numbers
        cast to ``cfg.dtype``; norms and biases are zeros.  Returns
        :meth:`param_dict`."""
        cfg = self.cfg
        kg = KeyGen(seed, self.device)
        pdt = dtype_of(cfg.param_dtype)
        fresh = init_embed(kg, cfg.padded_vocab, cfg.d_model, pdt,
                           cfg.tie_embeddings, device=self.device)
        for name, t in fresh.items():
            self.embed[name].copy_(t)
        for unit in self.units:
            for i, spec in enumerate(cfg.unit):
                layer = unit[f"layer{i}"]
                fresh = {"attn": attn_mod.init_attention(
                    kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, pdt, cfg.qkv_bias,
                    device=self.device)}
                if spec.ffn == "moe":
                    fresh["moe"] = moe_mod.init_moe(
                        kg, cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff,
                        pdt, device=self.device)
                else:
                    fresh["mlp"] = init_mlp(kg, cfg.d_model, cfg.d_ff, pdt,
                                            device=self.device)
                for group, tensors in fresh.items():
                    for name, t in tensors.items():
                        getattr(layer, group)[name].copy_(t)
                layer.ln1.zero_()
                layer.ln2.zero_()
        self.final_norm.zero_()
        return self.param_dict()

    def _unit(self, unit: nn.ModuleDict, x, positions):
        aux = 0.0
        for i, spec in enumerate(self.cfg.unit):
            p = unit[f"layer{i}"].weights(spec, self.dtype)
            x, a = apply_layer(self.cfg, spec, p, x, positions=positions)
            aux = aux + a
        return x, aux

    def train_loss(self, batch: Dict[str, Any],
                   remat: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy (with the reference's z-loss) of
        ``batch`` (``tokens``/``labels [B, S]``, tensors or arrays); a
        scalar tensor whose backward fills every master's ``.grad``."""
        cfg, dt = self.cfg, self.dtype
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        emb = {k: w.to(dt) for k, w in self.embed.items()}
        x = embed_tokens(emb, tokens, cfg.scale_embed, cfg.d_model, dt)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = 0.0
        for unit in self.units:
            if remat:
                x, a = checkpoint(self._unit, unit, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._unit(unit, x, positions)
            aux = aux + a
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = unembed(emb, x, cfg.logit_softcap, cfg.vocab)
        loss = cross_entropy(logits, labels)
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux / cfg.n_layers
        return loss
