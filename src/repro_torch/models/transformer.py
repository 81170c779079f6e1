"""Model assembly: embeddings -> unit stack -> logits, for serving and
for training.

The port of ``repro/models/transformer.py`` for every assigned arch:
dense attention (llama3, gemma2 with local windows and softcaps, glm4
with partial rotary, qwen1.5 with QKV bias), MoE (qwen3-moe,
granite-moe: ``ffn="moe"``, :mod:`repro_torch.models.moe`), xLSTM
(xlstm-125m: ``mlstm``/``slstm`` sublayers with ``ffn="none"``,
:mod:`repro_torch.models.xlstm`), the hybrid jamba (``mamba`` sublayers
beside attention, :mod:`repro_torch.models.ssm`), the encoder-decoder
seamless-m4t and the vision-language paligemma.  Both models are
``nn.Module``s of one layout: ``units`` is an ``nn.ModuleList`` of units,
each an ``nn.ModuleDict`` of ``layer{i}`` sublayers, beside the embedding
(and the untied ``lm_head``) and the final norm.  A sublayer holds
``ln1``, its mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``), in an
encoder-decoder's decoder ``ln_cross`` and ``cross`` (cross-attention
over the encoder's memory), and, unless its ``ffn`` is ``"none"``,
``ln2`` and ``mlp`` or ``moe``.

The modality frontends are stubs, as in the reference: the caller passes
precomputed embeddings ``frontend_embeds [B, frontend_len,
frontend_dim]``, which ``frontend_proj`` maps to ``d_model``.  With an
encoder-decoder (``cfg.enc_dec``, seamless's audio frontend) they are
the encoder's input: ``encoder`` is a list of ``n_enc_layers`` global
attention sublayers with a dense MLP, non-causal over the frames with
RoPE at ``arange(frontend_len)``, then ``enc_norm``; each decoder unit
projects the memory to its cross K/V once (its ``layer0``'s ``cross``
weights, :func:`repro_torch.models.attention.precompute_cross_kv`) and
every layer of the unit attends to them after its mixer.  Otherwise
(paligemma's vision frontend) the projected embeddings are a prefix put
before the token embeddings; positions run over prefix and text and the
mask is causal over the whole sequence, as in the reference.  An arch
with a frontend called without embeddings raises ``ValueError``.

``Model`` serves.  It holds what the reference serves with: its
``prefill``/``decode_step`` cast every floating leaf of two or more
dimensions to the compute dtype on every call (``_cast_params``), and
the reference stacks a unit's (and an encoder layer's) leaves, so every
unit leaf (norm weights, QKV biases, the MoE router, the xLSTM gate
biases and ``out_norm``, Mamba's ``a_log``, ``dt_proj_b``, ``d_skip``
and ``conv_b``), every encoder leaf, ``frontend_proj``, the embedding
and ``lm_head`` are held in ``cfg.dtype``; only the final norm and
``enc_norm`` stay float32.  The port casts once, at load.  The stack
runs the units in a Python loop (the reference's ``lax.scan``) and the
forward only: serve under ``torch.inference_mode()``.  The decode cache
holds one entry a unit position, stacked over the units: the KV pair of
an attention layer (written in place), the recurrent state of a Mamba
or xLSTM layer (replaced after every call); an encoder-decoder's also
holds each unit's cross K/V, written once by the prefill.  A prefill
starts from the cache's states (fresh: the zero states).  A prefill's
MoE layers take the capacity path, a decode step's (one token a
sequence) the dense one, as in the reference; the aux loss is dropped.

``TrainModel`` trains (``train_loss``).  Its weights are the float32
masters in ``cfg.param_dtype`` with ``requires_grad``, cast to
``cfg.dtype`` on every call as the reference's ``train_loss`` casts its
tree, by the same rule: every unit and encoder leaf, ``frontend_proj``,
the embedding and ``lm_head``; the final norm and ``enc_norm`` stay
float32.  The gradients reach the masters through the casts.  With
``remat`` every unit and every encoder layer is a
``torch.utils.checkpoint`` region (the reference's ``jax.checkpoint``
with ``nothing_saveable``): its forward, attention kernel included, runs
again in the backward, and a unit returns its MoE aux loss beside the
activations.  With ``cfg.moe`` the loss adds ``aux_loss_weight *
sum(aux) / n_layers``.  Training runs no cache: recurrent layers start
from the zero states.  With a vision prefix the loss covers the text
positions only.

The decode cache's attention entries are bf16 or, with ``cfg.kv_dtype =
"int8"``, int8 with a float32 scale a token and kv head
(:func:`repro_torch.models.attention.init_kv_cache`); such a layer
attends over its cache through the chunk-dequantizing plain path on
every device, as the reference does, while an encoder-decoder's cross
K/V stay in ``cfg.dtype``.  Training holds no cache, so ``TrainModel``
takes either.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (KeyGen, apply_mlp, cross_entropy, dtype_of,
                     embed_tokens, init_embed, init_mlp, make_param, matmul,
                     rms_norm, unembed)

KINDS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")
FRONTENDS = ("none", "vision", "audio")
# an encoder layer: global self-attention (non-causal) and a dense MLP
ENC_SPEC = LayerSpec(kind="attn", attn_type="global", ffn="dense")


def _param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _params(d: Dict[str, torch.Tensor],
            trainable: bool = False) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, trainable) for k, v in d.items()})


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config no model can build."""
    for spec in cfg.unit:
        if spec.kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown layer kind {spec.kind!r}")
        if spec.ffn not in FFNS:
            raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
        if spec.ffn == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: ffn='moe' without cfg.moe")
        if spec.kind in ("mlstm", "slstm") and cfg.xlstm is None:
            raise ValueError(f"{cfg.name}: {spec.kind} layers without "
                             f"cfg.xlstm")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    if cfg.frontend != "none" and (cfg.frontend_dim < 1
                                   or cfg.frontend_len < 1):
        raise ValueError(f"{cfg.name}: a frontend needs frontend_dim and "
                         f"frontend_len")
    if cfg.enc_dec and (cfg.frontend == "none" or cfg.n_enc_layers < 1):
        raise ValueError(f"{cfg.name}: an encoder-decoder needs a frontend "
                         f"(its input) and n_enc_layers")
    if cfg.kv_dtype not in attn_mod.KV_DTYPES:
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")


def init_layer(cfg: ModelConfig, spec: LayerSpec, kg: Optional[KeyGen],
               dtype: torch.dtype, vec_dtype: torch.dtype = torch.float32,
               mode: str = "normal", device=None,
               cross: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A sublayer's weight groups, drawn in the reference's order: the
    mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``), then with
    ``cross`` the cross-attention (``cross``, no QKV bias), then the ffn
    (``mlp`` or ``moe``; none with ``ffn="none"``).  Weights in
    ``dtype``; the leaves the reference makes in float32 (the MoE router,
    the gate biases, ``out_norm``, Mamba's ``a_log``, ``dt_proj_b``,
    ``d_skip``) in ``vec_dtype``.  The norms are not drawn."""
    kw = dict(mode=mode, device=device)
    if spec.kind == "attn":
        mixer = attn_mod.init_attention(
            kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dtype, cfg.qkv_bias, **kw)
    elif spec.kind == "mamba":
        m = cfg.mamba or MambaConfig()
        mixer = ssm_mod.init_mamba(kg, cfg.d_model, dtype, m.d_state,
                                   m.d_conv, m.expand, m.dt_rank,
                                   vec_dtype=vec_dtype, **kw)
    else:
        init = (xlstm_mod.init_mlstm if spec.kind == "mlstm"
                else xlstm_mod.init_slstm)
        mixer = init(kg, cfg.d_model, cfg.n_heads, dtype,
                     cfg.xlstm.proj_factor, vec_dtype=vec_dtype, **kw)
    groups = {spec.kind: mixer}
    if cross:
        groups["cross"] = attn_mod.init_attention(
            kg, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dtype, False, **kw)
    if spec.ffn == "moe":
        groups["moe"] = moe_mod.init_moe(
            kg, cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff, dtype,
            router_dtype=vec_dtype, **kw)
    elif spec.ffn == "dense":
        groups["mlp"] = init_mlp(kg, cfg.d_model, cfg.d_ff, dtype, **kw)
    return groups


# the norm before each group after the mixer (the mixer's is ln1): the
# cross-attention's and the ffn's
NORM_OF = {"cross": "ln_cross", "mlp": "ln2", "moe": "ln2"}


class Layer(nn.Module):
    """One pre-norm sublayer: ``ln1`` and the mixer (attention, Mamba,
    mLSTM or sLSTM); with ``cross`` (a decoder layer of an
    encoder-decoder) ``ln_cross`` and the cross-attention (``cross``);
    then, unless ``ffn="none"``, ``ln2`` and the dense gated MLP
    (``mlp``) or the MoE layer (``moe``): :func:`init_layer`'s groups, in
    the reference's key order.  Every weight, norm and bias is held in
    ``dtype`` (the leaves the reference makes in float32 drawn in float32
    first); ``trainable`` sets ``requires_grad`` on every one."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 kg: Optional[KeyGen], device, mode: str,
                 dtype: torch.dtype, trainable: bool = False,
                 cross: bool = False):
        super().__init__()
        groups = init_layer(cfg, spec, kg, dtype, vec_dtype=dtype, mode=mode,
                            device=device, cross=cross)
        self.groups = tuple(groups)
        self._norms = ("ln1",) + tuple(NORM_OF[g] for g in self.groups
                                       if g in NORM_OF)

        def norm():
            return _param(torch.zeros(cfg.d_model, dtype=dtype,
                                      device=device), trainable)

        self.ln1 = norm()
        for name, tensors in groups.items():
            if name in NORM_OF:
                setattr(self, NORM_OF[name], norm())
            setattr(self, name, _params(tensors, trainable))

    def norms(self) -> Tuple[str, ...]:
        return self._norms

    def weights(self, dtype=None) -> Dict[str, Any]:
        """The mapping :func:`apply_layer` reads, every leaf cast to
        ``dtype`` when given."""
        cast = (lambda w: w) if dtype is None else (lambda w: w.to(dtype))
        out: Dict[str, Any] = {n: cast(getattr(self, n))
                               for n in self.norms()}
        for name in self.groups:
            out[name] = {k: cast(w) for k, w in getattr(self, name).items()}
        return out


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x, *, positions,
                layer_cache=None, cache_index: int = 0, cross_kv=None,
                causal: bool = True, moe_groups: int = 1, par=None):
    """One sublayer's forward: ``p`` maps ``ln1``, the mixer, with a
    ``cross`` group ``ln_cross`` and ``cross``, and unless ``ffn="none"``
    ``ln2`` and ``mlp`` or ``moe`` to the weights
    (:meth:`Layer.weights`).  ``layer_cache`` is the layer's slice of the
    decode cache: an attention layer's KV pair (written in place) or a
    recurrent layer's state (None: the zero state, and no state back).
    ``causal=False`` makes the self-attention non-causal (the encoder).
    ``cross_kv`` (the unit's cross K/V ``[B, KV, Sk, hd]``) runs the
    cross-attention after the mixer: non-causal, no RoPE, the keys at
    ``arange(Sk)``.  ``moe_groups`` is the MoE capacity path's number of
    token groups (the model's ``hints``).  Returns ``(x, aux, state)``:
    the MoE layer's aux loss (a float32 tensor; 0 after a decode step's
    dense path), 0.0 without one; the recurrent layer's new state, None
    for attention.  ``par`` (a rank's
    :class:`~repro_torch.parallel.collectives.Spmd`; an attention or
    Mamba mixer, a dense MLP or an MoE layer) makes ``p`` the rank's
    model-axis shards: the attention runs on the rank's ``n_heads / tp``
    and ``n_kv_heads / tp`` heads (its cache holds those kv heads) and its
    ``wo`` product, like the MLP's, is all-reduced over the model axis;
    Mamba runs on the rank's ``d_in / tp`` channels (its state holds
    those), and the MoE layer on its ``E / tp`` experts
    (:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.moe`)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    state = None
    if spec.kind == "attn":
        window = cfg.sliding_window if spec.attn_type == "local" else 0
        chunk = cfg.decode_chunk if h.shape[1] == 1 else cfg.attn_chunk
        tp = 1 if par is None else par.tp
        y, _ = attn_mod.attention(
            p["attn"], h, n_heads=cfg.n_heads // tp,
            n_kv_heads=cfg.n_kv_heads // tp,
            head_dim=cfg.resolved_head_dim, positions=positions,
            causal=causal, window=window,
            rotary_fraction=cfg.rotary_fraction, rope_theta=cfg.rope_theta,
            attn_cap=cfg.attn_softcap, impl=cfg.attn_impl, chunk=chunk,
            layer_cache=layer_cache, cache_index=cache_index)
        if par is not None:
            y = par.reduce(y, "attn/wo")
    elif spec.kind == "mamba":
        y, state = ssm_mod.apply_mamba(p["mamba"], h, chunk=cfg.mamba_chunk,
                                       state=layer_cache, par=par)
    elif spec.kind == "mlstm":
        y, state = xlstm_mod.apply_mlstm(p["mlstm"], h, n_heads=cfg.n_heads,
                                         chunk=cfg.xlstm.chunk,
                                         state=layer_cache)
    else:
        y, state = xlstm_mod.apply_slstm(p["slstm"], h, state=layer_cache)
    x = x + y
    if cross_kv is not None and "cross" in p:
        # the reference passes no chunk, softcap or window here
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        y, _ = attn_mod.attention(
            p["cross"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            causal=False, use_rope=False, impl=cfg.attn_impl, kv=cross_kv)
        x = x + y
    if spec.ffn == "none":
        return x, 0.0, state
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.ffn == "dense":
        return x + apply_mlp(p["mlp"], h, cfg.act, par=par), 0.0, state
    if h.shape[1] == 1:          # decode: the dropless all-experts path
        y, aux = moe_mod.apply_moe_dense(p["moe"], h, top_k=cfg.moe.top_k,
                                         act=cfg.act, par=par)
    else:
        y, aux = moe_mod.apply_moe(
            p["moe"], h, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
            groups=moe_groups, par=par)
    return x + y, aux, state


def init_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
               device=None, tp: int = 1) -> Dict[str, torch.Tensor]:
    """A recurrent layer's zero state for ``batch`` sequences (float32):
    Mamba ``{conv, ssm}`` (a rank's ``d_in / tp`` channels on a model
    axis of ``tp`` devices), mLSTM ``{C, n, m}``, sLSTM ``{c, n, m,
    h}``."""
    if spec.kind == "mamba":
        m = cfg.mamba or MambaConfig()
        return ssm_mod.init_mamba_state(batch, cfg.d_model, m.d_state,
                                        m.d_conv, m.expand, device=device,
                                        tp=tp)
    if spec.kind == "mlstm":
        return xlstm_mod.init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm.proj_factor,
                                          device=device)
    return xlstm_mod.init_slstm_state(batch, cfg.d_model,
                                      cfg.xlstm.proj_factor, device=device)


def make_units(cfg: ModelConfig, kg: Optional[KeyGen], device, mode: str,
               dtype: torch.dtype, trainable: bool = False) -> nn.ModuleList:
    """The decoder's ``n_units`` units (each a ``layer{i}`` ModuleDict;
    an encoder-decoder's layers hold the cross group)."""
    return nn.ModuleList(
        nn.ModuleDict({f"layer{i}": Layer(cfg, spec, kg, device, mode, dtype,
                                          trainable, cross=cfg.enc_dec)
                       for i, spec in enumerate(cfg.unit)})
        for _ in range(cfg.n_units))


def make_encoder(cfg: ModelConfig, kg: Optional[KeyGen], device, mode: str,
                 dtype: torch.dtype,
                 trainable: bool = False) -> nn.ModuleList:
    """The encoder's ``n_enc_layers`` layers (each ``{"layer0": ...}`` of
    :data:`ENC_SPEC`, as the reference's stacked ``encoder`` tree)."""
    return nn.ModuleList(
        nn.ModuleDict({"layer0": Layer(cfg, ENC_SPEC, kg, device, mode,
                                       dtype, trainable)})
        for _ in range(cfg.n_enc_layers))


def project_frontend(cfg: ModelConfig, proj: torch.Tensor, frontend_embeds,
                     dtype: torch.dtype) -> torch.Tensor:
    """``frontend_embeds [B, L, frontend_dim]`` (a tensor or an array) in
    ``dtype`` times ``frontend_proj`` in ``dtype``: ``[B, L, d_model]``.
    Raises ``ValueError`` without embeddings or at another width."""
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name} requires frontend embeddings "
                         f"(frontend_embeds [B, {cfg.frontend_len}, "
                         f"{cfg.frontend_dim}])")
    fe = torch.as_tensor(frontend_embeds, device=proj.device)
    if fe.dim() != 3 or fe.shape[-1] != cfg.frontend_dim:
        raise ValueError(f"{cfg.name}: frontend_embeds {tuple(fe.shape)} "
                         f"must be [B, L, {cfg.frontend_dim}]")
    return matmul(fe.to(dtype), proj.to(dtype))


def run_encoder(cfg: ModelConfig, encoder: nn.ModuleList,
                enc_norm: torch.Tensor, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None,
                remat: bool = False) -> torch.Tensor:
    """The encoder over the projected frames ``x [B, L, D]``: every layer
    non-causal with RoPE at ``arange(L)`` (its weights cast to ``dtype``
    when given; with ``remat`` each layer a checkpoint region), then
    ``enc_norm``."""
    positions = torch.arange(x.shape[1], device=x.device)

    def layer_fwd(layer, x):
        return apply_layer(cfg, ENC_SPEC, layer.weights(dtype), x,
                           positions=positions, causal=False)[0]

    for layer in encoder:
        if remat:
            x = checkpoint(layer_fwd, layer["layer0"], x,
                           use_reentrant=False)
        else:
            x = layer_fwd(layer["layer0"], x)
    return rms_norm(x, enc_norm, cfg.norm_eps)


class Model(nn.Module):
    """``Model(cfg, device=..., seed=...)`` draws random weights from a
    ``torch.Generator`` on ``device`` seeded with ``seed``;
    ``init=False`` only allocates them (see
    :func:`repro_torch.models.convert.params_from_numpy`).
    ``hints`` (set by :func:`repro_torch.launch.steps.build_cell`) is the
    reference's dict of activation hints: ``moe_groups`` acts (the MoE
    capacity path routes that many groups of tokens on their own; on a
    rank of a mesh, the groups of its own tokens); the placement hints
    (``act``, ``logits``, ``moe_ecd``, ``moe_gather``, ``moe_grp``,
    ``state_b``) are what ``par`` does on a mesh.
    ``par`` (None on one device; set by
    :meth:`repro_torch.launch.steps.CellProgram.materialize` on a mesh) is
    the rank's :class:`~repro_torch.parallel.collectives.Spmd`: the
    parameters are then the rank's shards, each all-gathered over its
    FSDP axes just before use and dropped after, the cache holds the
    rank's requests, kv heads and Mamba channels, the experts are split
    over the model axis, the embedding and the head over the vocabulary,
    and the logits stay so split."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 init: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.hints: Dict[str, Any] = {}
        self.par = None
        device = torch.device(device)
        kg = KeyGen(seed, device) if init else None
        mode = "normal" if init else "empty"
        self.embed = _params(init_embed(kg, cfg.padded_vocab, cfg.d_model,
                                        self.dtype, cfg.tie_embeddings,
                                        mode=mode, device=device))
        self.units = make_units(cfg, kg, device, mode, self.dtype)
        self.final_norm = _param(torch.zeros(cfg.d_model, device=device))
        if cfg.enc_dec:
            self.encoder = make_encoder(cfg, kg, device, mode, self.dtype)
            self.enc_norm = _param(torch.zeros(cfg.d_model, device=device))
        if cfg.frontend != "none":
            self.frontend_proj = _param(make_param(
                kg() if kg is not None else None,
                (cfg.frontend_dim, cfg.d_model), self.dtype, mode=mode,
                device=device))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Decode cache: one entry a unit position, stacked over the units
        (a leading ``n_units`` axis): for attention ``{k, v}``
        ``[n_units, B, KV, max_len, hd]`` in ``cfg.kv_dtype`` (an int8
        pair beside float32 ``k_scale``/``v_scale [n_units, B, KV,
        max_len]``), the zero state (:func:`init_state`) for a recurrent
        layer; the write index; and
        for an encoder-decoder the cross K/V ``cross_k``/``cross_v
        [n_units, B, KV, frontend_len, hd]`` in ``cfg.dtype`` (zeros until
        a prefill writes them)."""
        cfg = self.cfg
        tp = 1 if self.par is None else self.par.tp
        kv_heads = cfg.n_kv_heads // tp
        layers = {}
        for i, spec in enumerate(cfg.unit):
            if spec.kind == "attn":
                c = attn_mod.init_kv_cache(batch, kv_heads, max_len,
                                           cfg.resolved_head_dim,
                                           cfg.kv_dtype, cfg.n_units,
                                           device=self.device)
                c.pop("index")
            else:
                c = {k: t.expand(cfg.n_units, *t.shape).clone()
                     for k, t in init_state(cfg, spec, batch, self.device,
                                            tp).items()}
            layers[f"layer{i}"] = c
        cache = {"layers": layers, "index": 0}
        if cfg.enc_dec:
            shape = (cfg.n_units, batch, cfg.n_kv_heads, cfg.frontend_len,
                     cfg.resolved_head_dim)
            cache["cross_k"] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
        return cache

    # ---------------------------------------------------------------- stack
    def _weight(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name`` as this rank computes with it (gathered over
        its FSDP axes on a mesh)."""
        return t if self.par is None else self.par.param(t, name)

    def _layer_weights(self, u: int, name: str):
        w = self.units[u][name].weights()
        if self.par is None:
            return w
        pre = f"units.{u}.{name}."
        return {g: ({k: self._weight(t, f"{pre}{g}.{k}")
                     for k, t in v.items()} if isinstance(v, dict)
                    else self._weight(v, pre + g))
                for g, v in w.items()}

    def _embed(self, key: str) -> Dict[str, torch.Tensor]:
        return {key: self._weight(self.embed[key], f"embed.{key}")}

    def _head(self) -> Dict[str, torch.Tensor]:
        return self._embed("embedding" if self.cfg.tie_embeddings
                           else "lm_head")

    def _run_units(self, x, *, positions, cache, cache_index):
        for u in range(len(self.units)):
            cross_kv = ((cache["cross_k"][u], cache["cross_v"][u])
                        if self.cfg.enc_dec else None)
            for i, spec in enumerate(self.cfg.unit):
                name = f"layer{i}"
                c = cache["layers"][name]
                x, _, state = apply_layer(   # serving drops the aux loss
                    self.cfg, spec, self._layer_weights(u, name), x,
                    positions=positions,
                    layer_cache={k: t[u] for k, t in c.items()},
                    cache_index=cache_index, cross_kv=cross_kv,
                    moe_groups=self.hints.get("moe_groups", 1),
                    par=self.par)
                for k, t in (state or {}).items():
                    c[k][u] = t
        return x

    def _encode_into(self, frontend_embeds, cache) -> None:
        """The encoder over the projected frames, then every unit's cross
        K/V (its ``layer0``'s ``cross`` weights) written into the cache."""
        cfg = self.cfg
        mem = project_frontend(cfg, self.frontend_proj, frontend_embeds,
                               self.dtype)
        if mem.shape[1] != cfg.frontend_len:
            raise ValueError(f"{cfg.name}: {mem.shape[1]} frames, the cache "
                             f"holds {cfg.frontend_len}")
        memory = run_encoder(cfg, self.encoder, self.enc_norm, mem)
        for u, unit in enumerate(self.units):
            k, v = attn_mod.precompute_cross_kv(
                unit["layer0"].cross, memory, cfg.n_kv_heads,
                cfg.resolved_head_dim)
            cache["cross_k"][u] = k
            cache["cross_v"][u] = v

    # ----------------------------------------------------------- entrypoints
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, Any],
                frontend_embeds=None):
        """Process a full prompt ``tokens [B, S]``, filling the cache in
        place.  An encoder-decoder first encodes ``frontend_embeds`` and
        writes the cross K/V; a vision arch puts their projection before
        the tokens (the cache index then counts the prefix).  Returns
        (logits of the last position [B, V] f32, cache)."""
        cfg = self.cfg
        if cfg.enc_dec:
            self._encode_into(frontend_embeds, cache)
        x = embed_tokens(self._embed("embedding"), tokens, cfg.scale_embed,
                         cfg.d_model, self.dtype, par=self.par)
        if cfg.frontend != "none" and not cfg.enc_dec:
            x = torch.cat([project_frontend(cfg, self.frontend_proj,
                                            frontend_embeds, self.dtype), x],
                          dim=1)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        x = self._run_units(x, positions=positions, cache=cache,
                            cache_index=0)
        cache["index"] = S
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        logits = unembed(self._head(), x, cfg.logit_softcap, cfg.vocab,
                         par=self.par)
        return logits[:, 0], cache

    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]):
        """token: [B, 1] -> (logits [B, V] f32, the cache, updated in
        place)."""
        cfg = self.cfg
        idx = cache["index"]
        x = embed_tokens(self._embed("embedding"), token, cfg.scale_embed,
                         cfg.d_model, self.dtype, par=self.par)
        positions = idx + torch.arange(1, device=x.device)
        x = self._run_units(x, positions=positions, cache=cache,
                            cache_index=idx)
        cache["index"] = idx + 1
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = unembed(self._head(), x, cfg.logit_softcap, cfg.vocab,
                         par=self.par)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> Model:
    return Model(cfg, device=device, seed=seed)


class TrainModel(nn.Module):
    """The training model: float32 masters (``cfg.param_dtype``) with
    ``requires_grad``, in :class:`Model`'s layout.  ``TrainModel(cfg,
    device=..., seed=...)`` draws them from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (:meth:`init_params`); ``init=False``
    only allocates them (see
    :func:`repro_torch.models.convert.params_from_numpy`).
    ``hints`` (set by :func:`repro_torch.launch.steps.build_cell`) is the
    reference's dict of activation hints: only ``moe_groups`` acts (the
    MoE capacity path routes that many groups of tokens on their own).
    Training runs on one device: a training cell on a mesh of more than
    one refuses (:meth:`repro_torch.launch.steps.CellProgram.materialize`),
    so the placement hints have nothing to place here."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 init: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.hints: Dict[str, Any] = {}
        pdt = dtype_of(cfg.param_dtype)
        device = torch.device(device)
        self.embed = _params(init_embed(None, cfg.padded_vocab, cfg.d_model,
                                        pdt, cfg.tie_embeddings,
                                        mode="empty", device=device), True)
        self.units = make_units(cfg, None, device, "empty", pdt, True)
        self.final_norm = _param(torch.zeros(cfg.d_model, device=device),
                                 True)
        if cfg.enc_dec:
            self.encoder = make_encoder(cfg, None, device, "empty", pdt,
                                        True)
            self.enc_norm = _param(torch.zeros(cfg.d_model, device=device),
                                   True)
        if cfg.frontend != "none":
            self.frontend_proj = _param(torch.empty(
                cfg.frontend_dim, cfg.d_model, dtype=pdt, device=device),
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
        (embedding, ``lm_head``, each sublayer's :func:`init_layer`
        groups, each encoder layer's, ``frontend_proj``), so a
        :class:`Model` of the same seed holds these numbers cast to
        ``cfg.dtype``; norms are zeros, the other constants the
        reference's.  Returns :meth:`param_dict`."""
        cfg = self.cfg
        kg = KeyGen(seed, self.device)
        pdt = dtype_of(cfg.param_dtype)
        fresh = init_embed(kg, cfg.padded_vocab, cfg.d_model, pdt,
                           cfg.tie_embeddings, device=self.device)
        for name, t in fresh.items():
            self.embed[name].copy_(t)
        stacks = [(unit, cfg.unit, cfg.enc_dec) for unit in self.units]
        stacks += [(layer, (ENC_SPEC,), False)
                   for layer in getattr(self, "encoder", ())]
        for unit, specs, cross in stacks:
            for i, spec in enumerate(specs):
                layer = unit[f"layer{i}"]
                groups = init_layer(cfg, spec, kg, pdt, device=self.device,
                                    cross=cross)
                for group, tensors in groups.items():
                    for name, t in tensors.items():
                        getattr(layer, group)[name].copy_(t)
                for norm in layer.norms():
                    getattr(layer, norm).zero_()
        self.final_norm.zero_()
        if cfg.enc_dec:
            self.enc_norm.zero_()
        if cfg.frontend != "none":
            self.frontend_proj.copy_(make_param(
                kg(), (cfg.frontend_dim, cfg.d_model), pdt))
        return self.param_dict()

    def _unit(self, unit: nn.ModuleDict, x, positions, cross_kv=None):
        aux = 0.0
        for i, spec in enumerate(self.cfg.unit):
            p = unit[f"layer{i}"].weights(self.dtype)
            x, a, _ = apply_layer(self.cfg, spec, p, x, positions=positions,
                                  cross_kv=cross_kv,
                                  moe_groups=self.hints.get("moe_groups", 1))
            aux = aux + a
        return x, aux

    def train_loss(self, batch: Dict[str, Any],
                   remat: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy (with the reference's z-loss) of
        ``batch`` (``tokens``/``labels [B, S]``, tensors or arrays; an
        arch with a frontend also ``frontend_embeds [B, L,
        frontend_dim]``); a scalar tensor whose backward fills every
        master's ``.grad``.  A vision prefix is left out of the loss."""
        cfg, dt = self.cfg, self.dtype
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        fe = batch.get("frontend_embeds")
        emb = {k: w.to(dt) for k, w in self.embed.items()}
        x = embed_tokens(emb, tokens, cfg.scale_embed, cfg.d_model, dt)
        cross = [None] * cfg.n_units
        if cfg.enc_dec:
            memory = run_encoder(
                cfg, self.encoder, self.enc_norm,
                project_frontend(cfg, self.frontend_proj, fe, dt), dt,
                remat=remat)
            cross = [attn_mod.precompute_cross_kv(
                {k: w.to(dt) for k, w in unit["layer0"].cross.items()},
                memory, cfg.n_kv_heads, cfg.resolved_head_dim)
                for unit in self.units]
        elif cfg.frontend != "none":
            x = torch.cat([project_frontend(cfg, self.frontend_proj, fe, dt),
                           x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = 0.0
        for unit, cross_kv in zip(self.units, cross):
            if remat:
                x, a = checkpoint(self._unit, unit, x, positions, cross_kv,
                                  use_reentrant=False)
            else:
                x, a = self._unit(unit, x, positions, cross_kv)
            aux = aux + a
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if cfg.frontend != "none" and not cfg.enc_dec:
            x = x[:, -tokens.shape[1]:]      # loss over text positions only
        logits = unembed(emb, x, cfg.logit_softcap, cfg.vocab)
        loss = cross_entropy(logits, labels)
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux / cfg.n_layers
        return loss
