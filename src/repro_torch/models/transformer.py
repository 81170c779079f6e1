"""Model assembly: embeddings -> unit stack -> logits, for serving.

The port of ``repro/models/transformer.py`` for the decoder-only dense
attention archs (llama3, gemma2 with local windows and softcaps, glm4
with partial rotary, qwen1.5 with QKV bias).  ``Model`` is an
``nn.Module``: ``units`` is an ``nn.ModuleList`` of units, each an
``nn.ModuleDict`` of ``layer{i}`` sublayers, beside the embedding (and
the untied ``lm_head``) and the final norm.

Weights of two or more dimensions are held in ``cfg.dtype``: the
reference casts its float32 parameters to the compute dtype on every
call (``_cast_params``), the port casts once at load.  1-D norm weights
stay float32 and QKV biases stay in ``cfg.param_dtype``, as the
reference's cast leaves them.  The stack runs the units in a Python loop
(the reference's ``lax.scan``) and the forward only: serve under
``torch.inference_mode()``.

MoE, Mamba and xLSTM sublayers, encoder-decoder stacks and modality
frontends raise ``NotImplementedError`` (ROADMAP Queue 1 #8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from . import attention as attn_mod
from .layers import (KeyGen, apply_mlp, dtype_of, embed_tokens, init_embed,
                     init_mlp, rms_norm, unembed)

LATER = "not ported yet (ROADMAP Queue 1 #8)"


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(d: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


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
    """One pre-norm sublayer: attention, then the dense gated MLP."""

    def __init__(self, cfg: ModelConfig, kg: Optional[KeyGen], device,
                 mode: str):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.ln1 = _frozen(torch.zeros(cfg.d_model, device=device))
        self.attn = _params(attn_mod.init_attention(
            kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dt, cfg.qkv_bias,
            bias_dtype=dtype_of(cfg.param_dtype), mode=mode, device=device))
        self.ln2 = _frozen(torch.zeros(cfg.d_model, device=device))
        self.mlp = _params(init_mlp(kg, cfg.d_model, cfg.d_ff, dt, mode=mode,
                                    device=device))


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
            nn.ModuleDict({f"layer{i}": Layer(cfg, kg, device, mode)
                           for i in range(len(cfg.unit))})
            for _ in range(cfg.n_units))
        self.final_norm = _frozen(torch.zeros(cfg.d_model, device=device))

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

    # -------------------------------------------------------------- sublayer
    def _apply_layer(self, spec: LayerSpec, p: Layer, x, *, positions,
                     layer_cache, cache_index):
        cfg = self.cfg
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        window = cfg.sliding_window if spec.attn_type == "local" else 0
        chunk = cfg.decode_chunk if h.shape[1] == 1 else cfg.attn_chunk
        y, _ = attn_mod.attention(
            p.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            window=window, rotary_fraction=cfg.rotary_fraction,
            rope_theta=cfg.rope_theta, attn_cap=cfg.attn_softcap,
            impl=cfg.attn_impl, chunk=chunk, layer_cache=layer_cache,
            cache_index=cache_index)
        x = x + y
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        return x + apply_mlp(p.mlp, h, cfg.act)

    def _run_units(self, x, *, positions, cache, cache_index):
        for u, unit in enumerate(self.units):
            for i, spec in enumerate(self.cfg.unit):
                name = f"layer{i}"
                c = cache["layers"][name]
                x = self._apply_layer(
                    spec, unit[name], x, positions=positions,
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
