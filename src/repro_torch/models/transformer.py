"""Model assembly: embeddings -> unit stack -> logits, for serving and
for training.

The port of ``repro/models/transformer.py`` for the decoder-only dense
attention archs (llama3, gemma2 with local windows and softcaps, glm4
with partial rotary, qwen1.5 with QKV bias).  Both models are
``nn.Module``s of one layout: ``units`` is an ``nn.ModuleList`` of
units, each an ``nn.ModuleDict`` of ``layer{i}`` sublayers, beside the
embedding (and the untied ``lm_head``) and the final norm.

``Model`` serves.  Its weights of two or more dimensions are held in
``cfg.dtype``: the reference casts its float32 parameters to the compute
dtype on every call (``_cast_params``), the port casts once at load.
1-D norm weights stay float32 and QKV biases stay in
``cfg.param_dtype``.  The stack runs the units in a Python loop (the
reference's ``lax.scan``) and the forward only: serve under
``torch.inference_mode()``.

``TrainModel`` trains (``train_loss``).  Its weights are the float32
masters in ``cfg.param_dtype`` with ``requires_grad``, cast to
``cfg.dtype`` on every call as the reference's ``train_loss`` casts its
tree: every floating leaf of two or more dimensions.  The reference
stacks a unit's leaves over the units, so every unit leaf (norm weights
and QKV biases too) is cast; of the top-level leaves only the embedding
and ``lm_head`` are, the final norm stays float32.  The gradients reach
the masters through the casts.  With ``remat`` every unit is a
``torch.utils.checkpoint`` region (the reference's ``jax.checkpoint``
with ``nothing_saveable``): its forward, attention kernel included, runs
again in the backward.

MoE, Mamba and xLSTM sublayers, encoder-decoder stacks and modality
frontends raise ``NotImplementedError`` (ROADMAP Queue 1 #8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from . import attention as attn_mod
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
        if spec.ffn != "dense":
            raise NotImplementedError(f"{cfg.name}: ffn={spec.ffn!r} is "
                                      f"{LATER}")
    if cfg.kv_dtype != "bfloat16":
        raise NotImplementedError(f"{cfg.name}: the {cfg.kv_dtype} KV cache "
                                  f"is {LATER}")


class Layer(nn.Module):
    """One pre-norm sublayer: attention, then the dense gated MLP.  Its
    matrices are drawn in ``dtype``; ``trainable`` sets ``requires_grad``
    on every weight."""

    def __init__(self, cfg: ModelConfig, kg: Optional[KeyGen], device,
                 mode: str, dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        self.ln1 = _param(torch.zeros(cfg.d_model, device=device),
                           trainable)
        self.attn = _params(attn_mod.init_attention(
            kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dtype, cfg.qkv_bias,
            bias_dtype=dtype_of(cfg.param_dtype), mode=mode, device=device),
            trainable)
        self.ln2 = _param(torch.zeros(cfg.d_model, device=device),
                           trainable)
        self.mlp = _params(init_mlp(kg, cfg.d_model, cfg.d_ff, dtype,
                                    mode=mode, device=device), trainable)


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x, *, positions,
                layer_cache=None, cache_index: int = 0):
    """One sublayer's forward: ``p`` maps ``ln1``, ``attn``, ``ln2`` and
    ``mlp`` to the weights (a :class:`Layer` or a dict of cast ones)."""
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
    return x + apply_mlp(p["mlp"], h, cfg.act)


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
            nn.ModuleDict({f"layer{i}": Layer(cfg, kg, device, mode,
                                              self.dtype)
                           for i in range(len(cfg.unit))})
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
                layer = unit[name]
                x = apply_layer(
                    self.cfg, spec, {"ln1": layer.ln1, "attn": layer.attn,
                                     "ln2": layer.ln2, "mlp": layer.mlp},
                    x, positions=positions,
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
            nn.ModuleDict({f"layer{i}": Layer(cfg, None, device, "empty",
                                              pdt, trainable=True)
                           for i in range(len(cfg.unit))})
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
        ``wi_gate wi_up wo``), so a :class:`Model` of the same seed holds
        these numbers cast to ``cfg.dtype``; norms and biases are zeros.
        Returns :meth:`param_dict`."""
        kg = KeyGen(seed, self.device)
        pdt = dtype_of(self.cfg.param_dtype)
        fresh = init_embed(kg, self.cfg.padded_vocab, self.cfg.d_model, pdt,
                           self.cfg.tie_embeddings, device=self.device)
        for name, t in fresh.items():
            self.embed[name].copy_(t)
        for unit in self.units:
            for layer in unit.values():
                fresh = attn_mod.init_attention(
                    kg, self.cfg.d_model, self.cfg.n_heads,
                    self.cfg.n_kv_heads, self.cfg.resolved_head_dim, pdt,
                    self.cfg.qkv_bias, bias_dtype=pdt, device=self.device)
                for name, t in fresh.items():
                    layer.attn[name].copy_(t)
                for name, t in init_mlp(kg, self.cfg.d_model, self.cfg.d_ff,
                                        pdt, device=self.device).items():
                    layer.mlp[name].copy_(t)
                layer.ln1.zero_()
                layer.ln2.zero_()
        self.final_norm.zero_()
        return self.param_dict()

    def _unit(self, unit: nn.ModuleDict, x, positions):
        dt = self.dtype
        for i, spec in enumerate(self.cfg.unit):
            layer = unit[f"layer{i}"]
            p = {"ln1": layer.ln1.to(dt), "ln2": layer.ln2.to(dt),
                 "attn": {k: w.to(dt) for k, w in layer.attn.items()},
                 "mlp": {k: w.to(dt) for k, w in layer.mlp.items()}}
            x = apply_layer(self.cfg, spec, p, x, positions=positions)
        return x

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
        for unit in self.units:
            if remat:
                x = checkpoint(self._unit, unit, x, positions,
                               use_reentrant=False)
            else:
                x = self._unit(unit, x, positions)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = unembed(emb, x, cfg.logit_softcap, cfg.vocab)
        return cross_entropy(logits, labels)
