"""Grouped-query attention with the features the assigned archs need.

The port of ``repro/models/attention.py``.  Covered: GQA/MQA (kv groups),
RoPE (partial rotation for glm4), QKV bias (qwen1.5), attention-logit
softcapping and local/global layers (gemma2), sliding windows, a KV
cache in bf16 or in int8 with a float32 scale a token and kv head, and
the core softmax(QK^T)V; causal self-attention (the decoder),
non-causal self-attention (the encoder of seamless-m4t: ``causal=False``)
and cross-attention (the decoder's layers over the encoder's memory:
``kv=(k_mem, v_mem)`` from :func:`precompute_cross_kv`, non-causal, no
RoPE, ``use_rope=False``, and no cache write).

On a CUDA tensor the core is always the hand-written Hopper kernel of
:mod:`repro_torch.kernels.flash_attention`, whatever ``impl`` says, in
every one of these forms but one: a layer whose cache is int8 attends
through :func:`_sdpa_chunked_quant`, plain PyTorch on both devices, as
the reference attends over int8 in plain XLA.  On a CPU tensor ``impl``
picks one of three plain versions, the oracles of the parity tests:

- ``ref``      materialized [B,KV,G,S,S] scores with an additive mask
               bias -- the model's oracle
- ``chunked``  online softmax over KV chunks (the reference's
               flash-style jnp scan, as a loop over chunks), with the
               reference's recompute backward
- ``pallas``   the kernel's plain PyTorch version

Gradients (training) go through :class:`FlashAttention`, the port of the
reference's ``_make_flash`` custom VJP: its forward saves only ``(q, k,
v, out, lse)`` -- on a CUDA tensor the kernel writes ``out`` and the
row log-sum-exp ``lse`` in one launch, on the CPU the chunked forward
computes them -- and its backward recomputes the probabilities chunk by
chunk as ``exp(s - lse)``.  The backward is plain PyTorch on both
devices, as the reference leaves it to XLA outside any kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from .layers import KeyGen, apply_rope, make_param, matmul, softcap

NEG_INF = -2.0 ** 20  # large-but-finite to keep softcap/tanh well-behaved
# query rows a block of :func:`_sdpa_chunked_quant` (see its docstring)
QUANT_Q_BLOCK = 256


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(kg: Optional[KeyGen], d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype,
                   qkv_bias: bool = False, mode: str = "normal",
                   device=None) -> Dict[str, torch.Tensor]:
    """``wq wk wv wo`` drawn in ``dtype``; with ``qkv_bias`` the biases
    ``bq bk bv`` are zeros in ``dtype`` too, as in the reference."""
    gen = kg() if kg is not None else None
    shapes = {"wq": (d_model, n_heads * head_dim),
              "wk": (d_model, n_kv_heads * head_dim),
              "wv": (d_model, n_kv_heads * head_dim),
              "wo": (n_heads * head_dim, d_model)}
    p = {name: make_param(gen, shape, dtype, mode=mode, device=device)
         for name, shape in shapes.items()}
    if qkv_bias:
        dev = gen.device if gen is not None else device
        p["bq"] = torch.zeros(n_heads * head_dim, dtype=dtype,
                              device=dev)
        p["bk"] = torch.zeros(n_kv_heads * head_dim, dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros(n_kv_heads * head_dim, dtype=dtype,
                              device=dev)
    return p


# ---------------------------------------------------------------------------
# Score-level masks
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """Additive bias [S_q, S_k] in f32."""
    ok = torch.ones(q_pos.shape[-1], k_pos.shape[-1], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _fmask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """Additive bias from float positions; pad sentinels (>= 2**29) drop."""
    ok = (k_pos[None, :] < 2.0 ** 29).expand(q_pos.shape[-1],
                                             k_pos.shape[-1])
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Core softmax(QK^T)V implementations.  Layouts:
#   q: [B, KV, G, S_q, hd]   k/v: [B, KV, S_k, hd]
# ---------------------------------------------------------------------------

def _sdpa_ref(q, k, v, q_pos, k_pos, *, causal, window, attn_cap, scale):
    s = torch.einsum("bkgqd,bkcd->bkgqc", q.float(), k.float()) * scale
    s = softcap(s, attn_cap)
    s = s + _mask_bias(q_pos, k_pos, causal, window)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqc,bkcd->bkgqd", w.to(v.dtype), v)


def _chunk_kv(k, v, k_pos, chunk: int):
    """Keys padded to whole chunks of ``min(chunk, Sk)``: ``(k, v, k_pos,
    c, n_chunks, pad)``; padded keys sit at the sentinel position 2**30,
    beyond the validity limit, so every mask drops them."""
    Sk = k.shape[2]
    c = min(chunk, Sk)
    n_chunks = -(-Sk // c)
    pad = n_chunks * c - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2.0 ** 30)
    return k, v, k_pos, c, n_chunks, pad


def _chunked_forward(q, k, v, q_pos, k_pos, *, causal, window, attn_cap,
                     scale, chunk):
    """The reference's ``fwd_pass``: online softmax over KV chunks with an
    additive mask bias; returns ``(out in q's dtype, lse [B,KV,G,Sq]
    f32)``, ``lse = m + log(l)``."""
    B, KV, G, Sq, hd = q.shape
    k, v, k_pos, c, n_chunks, _ = _chunk_kv(k, v, k_pos, chunk)
    qf = q.float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        kb, vb = k[:, :, i * c:(i + 1) * c], v[:, :, i * c:(i + 1) * c]
        pb = k_pos[i * c:(i + 1) * c]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb.float()) * scale
        s = softcap(s, attn_cap)
        s = s + _fmask_bias(q_pos, pb, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        # the reference multiplies p (cast to v's dtype) by v in v's dtype
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(vb.dtype), vb).float()
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, lse


def _flash_backward(q, k, v, q_pos, k_pos, out, lse, do, *, causal, window,
                    attn_cap, scale, chunk):
    """The reference's ``flash_bwd``: the probabilities recomputed chunk by
    chunk as ``exp(s - lse)``, ``delta = sum(do * out)``, the softcap's
    factor ``1 - tanh^2``, the window and padding masks; dk/dv trimmed of
    the padding.  Products in f32.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    Sk = k.shape[2]
    kp, vp, k_pos, c, n_chunks, pad = _chunk_kv(k, v, k_pos, chunk)
    qf = q.float()
    do_f = do.float()
    delta = torch.sum(do_f * out.float(), dim=-1)             # [B,KV,G,S]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(n_chunks):
        kb = kp[:, :, i * c:(i + 1) * c].float()
        vb = vp[:, :, i * c:(i + 1) * c].float()
        pb = k_pos[i * c:(i + 1) * c]
        sraw = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb) * scale
        s = softcap(sraw, attn_cap)
        s = s + _fmask_bias(q_pos, pb, causal, window)
        p = torch.exp(s - lse[..., None])                      # true probs
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, do_f))
        dp = torch.einsum("bkgqd,bkcd->bkgqc", do_f, vb)
        ds = p * (dp - delta[..., None])
        if attn_cap > 0.0:
            th = torch.tanh(sraw * (1.0 / attn_cap))
            ds = ds * (1.0 - th * th)
        dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kb) * scale
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * scale)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    if pad:
        dk, dv = dk[:, :, :Sk], dv[:, :, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's recompute backward
    (``_make_flash``): ``q [B,KV,G,Sq,hd]``, ``k``/``v [B,KV,Sk,hd]``,
    float32 positions -> ``out`` in q's dtype.

    Forward: on a CUDA tensor one launch of the Hopper kernel that also
    writes the row log-sum-exp (``tc`` or ``simt``); on the CPU the
    chunked forward.  Only ``(q, k, v, out, lse)`` and the positions are
    saved, never a score.  Backward: :func:`_flash_backward`, plain
    PyTorch on both devices, ``chunk`` keys at a time."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, attn_cap,
                scale, chunk):
        kw = dict(causal=bool(causal), window=int(window),
                  attn_cap=float(attn_cap), scale=float(scale))
        if q.is_cuda:
            out, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos,
                                                  **kw)
        else:
            out, lse = _chunked_forward(q, k, v, q_pos, k_pos, **kw,
                                        chunk=int(chunk))
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.kw = dict(kw, chunk=int(chunk))
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, q_pos, k_pos, out, lse, do,
                                     **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, window, attn_cap, scale,
                  chunk: int = 1024):
    """Flash-style attention: online softmax forward + recompute backward
    (:class:`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, q_pos.float(), k_pos.float(),
                                causal, window, attn_cap, scale, chunk)


def _sdpa_chunked_quant(q, k8, ks, v8, vs, q_pos, k_pos, *, causal, window,
                        attn_cap, scale, chunk: int = 16384,
                        q_block: int = QUANT_Q_BLOCK):
    """Online-softmax attention directly over an int8 KV cache (the
    reference's ``_sdpa_chunked_quant``): ``q [B,KV,G,Sq,hd]``, int8
    ``k8``/``v8 [B,KV,Sk,hd]`` with float32 scales ``ks``/``vs
    [B,KV,Sk]``.  Keys are dequantized to float32 one chunk of ``chunk``
    at a time (the last chunk padded with zero keys at the sentinel
    position 2**30, which every mask drops), so no bf16 or f32 copy of
    the whole cache exists; scores, probabilities and the accumulator are
    float32, the output is cast to q's dtype.  Forward only (serving).

    The query rows go ``q_block`` at a time as well.  Each row's softmax
    is independent of the others, so this changes no value; it bounds
    the score tile.  At qwen1.5-32b's prefill (4 requests, 40 heads,
    2,048 rows over a 2,080-position cache) the whole f32 tile is 4 x 40
    x 2,048 x 2,080 x 4 B = 2.73 GB, and the scores, the probabilities
    and the exponential's temporary together ~8 GB, beside 70.4 GB of
    weights; a block of 256 rows makes each 341 MB."""
    B, KV, G, Sq, hd = q.shape
    Sk = k8.shape[2]
    c = min(chunk, Sk)
    n_chunks = -(-Sk // c)
    dev = q.device
    qf = q.float()
    q_posf = q_pos.float()
    k_posf = k_pos.float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        keys = slice(i * c, (i + 1) * c)
        kb = k8[:, :, keys].float() * ks[:, :, keys, None]
        vb = v8[:, :, keys].float() * vs[:, :, keys, None]
        pb = k_posf[keys]
        pad = c - kb.shape[2]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
            pb = torch.nn.functional.pad(pb, (0, pad), value=2.0 ** 30)
        for r0 in range(0, Sq, q_block):
            rows = slice(r0, r0 + q_block)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qf[..., rows, :],
                             kb) * scale
            s = softcap(s, attn_cap)
            s = s + _fmask_bias(q_posf[rows], pb, causal, window)
            m_old = m[..., rows]
            m_new = torch.maximum(m_old, s.amax(dim=-1))
            alpha = torch.exp(m_old - m_new)
            p = torch.exp(s.sub_(m_new[..., None]))
            l[..., rows] = l[..., rows] * alpha + p.sum(dim=-1)
            acc[..., rows, :] = acc[..., rows, :] * alpha[..., None] + \
                torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
            m[..., rows] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _sdpa_pallas(q, k, v, q_pos, k_pos, *, chunk: int = 1024, **kw):
    """The kernel: a serving call launches it alone (no log-sum-exp); a
    call that needs gradients goes through :class:`FlashAttention`, whose
    forward launches it with the log-sum-exp.  On the CPU, the kernel's
    plain version (differentiable as it is).  q, k and v share a dtype:
    the models hold their QKV biases in the compute dtype, as the
    reference's cast leaves them."""
    if q.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(
            q, k, v, q_pos.float(), k_pos.float(), kw["causal"],
            kw["window"], kw["attn_cap"], kw["scale"], chunk)
    return fa_ops.flash_attention(q, k, v, q_pos, k_pos, **kw)


_IMPLS = {"ref": _sdpa_ref, "chunked": _sdpa_chunked, "pallas": _sdpa_pallas}


# ---------------------------------------------------------------------------
# KV cache: bf16, or int8 with a float32 scale a token and kv head;
# updated in place
# ---------------------------------------------------------------------------

KV_DTYPES = ("bfloat16", "int8")


def init_kv_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
                  kv_dtype: str, n_layers: int,
                  device="cpu") -> Dict[str, Any]:
    """Stacked-over-layers cache ``k``/``v [n_layers, B, KV, max_len, hd]``
    in bf16, or for ``"int8"`` in int8 beside float32 scales
    ``k_scale``/``v_scale [n_layers, B, KV, max_len]``, all zeros, with
    the write position ``index`` as a Python int."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device),
                "index": 0}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "index": 0}


def _quant(x: torch.Tensor):
    """``x [..., hd]`` -> ``(int8 [..., hd], float32 scale [...])``, the
    reference's ``_quant`` to the bit.  The scale ``max|x| / 127`` (at
    least 1e-8) and the division run in x's own dtype, as the weakly
    typed constants leave them in JAX; only the stored scale is float32.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The clamp
    to [-128, 127] before the cast is XLA's saturating convert: in bf16,
    ``max|x| / scale`` lands on 127.5 for about one magnitude in six,
    which rounds to 128; XLA stores 127, while ``.to(torch.int8)`` would
    wrap it to -128 on the CPU (and is undefined on the card), flipping
    the sign of the row's largest element.  The constants are tensors
    filled on x's device (no copy from the host, which would wait for the
    card): PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds other than ``max|x| / 127`` does."""
    scale = torch.maximum(x.abs().amax(dim=-1) / x.new_full((), 127.0),
                          x.new_full((), 1e-8))
    q = torch.round(x / scale[..., None]).clamp_(-128, 127)
    return q.to(torch.int8), scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def cache_update(layer_cache, k_new, v_new, index: int):
    """Write ``[B,KV,S,hd]`` at position ``index`` IN PLACE (the reference
    returns an updated copy); an int8 cache takes the :func:`_quant`
    values and scales of ``k_new`` and ``v_new``.  Returns
    ``layer_cache``."""
    S = k_new.shape[2]
    at = slice(index, index + S)
    if layer_cache["k"].dtype == torch.int8:
        for name, x in (("k", k_new), ("v", v_new)):
            q, scale = _quant(x)
            layer_cache[name][:, :, at] = q
            layer_cache[f"{name}_scale"][:, :, at] = scale
        return layer_cache
    layer_cache["k"][:, :, at] = k_new
    layer_cache["v"][:, :, at] = v_new
    return layer_cache


def cache_kv(layer_cache, dtype):
    """The whole cache's K and V in ``dtype`` (an int8 cache dequantized)."""
    if layer_cache["k"].dtype == torch.int8:
        return (_dequant(layer_cache["k"], layer_cache["k_scale"], dtype),
                _dequant(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


# ---------------------------------------------------------------------------
# Full attention layer
# ---------------------------------------------------------------------------

def attention(p, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              positions, causal: bool = True, window: int = 0,
              rotary_fraction: float = 1.0, rope_theta: float = 10_000.0,
              use_rope: bool = True, attn_cap: float = 0.0,
              impl: str = "chunked", chunk: int = 1024, kv=None,
              k_positions=None, layer_cache: Optional[Dict[str, Any]] = None,
              cache_index: int = 0):
    """One attention sublayer.

    - self-attention without a cache (layer_cache=None): keys are this
      call's positions (the encoder, and training)
    - cached decode/prefill: writes at cache_index in place and attends
      over the whole cache; an int8 cache through
      :func:`_sdpa_chunked_quant`, on every device
    - cross-attention: ``kv=(k_mem, v_mem)`` ``[B,KV,Sk,hd]`` precomputed
      from the encoder's memory (:func:`precompute_cross_kv`), keys at
      ``k_positions`` (default ``arange(Sk)``); no cache is written
    Returns (output [B,S,D], the layer cache, or None for cross-attention).
    """
    B, S, _ = x.shape
    G = n_heads // n_kv_heads
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, n_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rotary_fraction, rope_theta)
    if kv is not None:                       # cross-attention memory
        k, v = kv
        k_pos = (k_positions if k_positions is not None
                 else torch.arange(k.shape[2], device=x.device))
        layer_cache = None
    else:
        k = matmul(x, p["wk"])
        v = matmul(x, p["wv"])
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
        k = k.reshape(B, S, n_kv_heads, head_dim)
        if use_rope:
            k = apply_rope(k, positions, rotary_fraction, rope_theta)
        k = k.transpose(1, 2)                                # [B,KV,S,hd]
        v = v.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
        if layer_cache is not None:
            cache_update(layer_cache, k, v, cache_index)
            if layer_cache["k"].dtype == torch.int8:
                # dequantized a chunk at a time inside the online softmax:
                # no copy of the whole cache in bf16
                qg = q.reshape(B, S, n_kv_heads, G, head_dim).permute(
                    0, 2, 3, 1, 4)
                out = _sdpa_chunked_quant(
                    qg, layer_cache["k"], layer_cache["k_scale"],
                    layer_cache["v"], layer_cache["v_scale"], positions,
                    torch.arange(layer_cache["k"].shape[2],
                                 device=x.device),
                    causal=causal, window=window, attn_cap=attn_cap,
                    scale=1.0 / np.sqrt(head_dim))
                out = out.permute(0, 3, 1, 2, 4).reshape(
                    B, S, n_heads * head_dim)
                return matmul(out, p["wo"]), layer_cache
            k, v = cache_kv(layer_cache, x.dtype)
            k_pos = torch.arange(k.shape[2], device=x.device)
        else:
            k_pos = positions

    qg = q.reshape(B, S, n_kv_heads, G, head_dim).permute(0, 2, 3, 1, 4)
    scale = 1.0 / np.sqrt(head_dim)
    kw = dict(causal=causal, window=window, attn_cap=attn_cap, scale=scale)
    if x.device.type != "cpu":
        # the card runs the kernel, never a plain one (an int8 cache has
        # returned above: the reference has no TPU kernel for it either)
        impl = "pallas"
    if impl != "ref":
        kw.update(chunk=chunk)   # the backward's chunk on the kernel's path
    out = _IMPLS[impl](qg, k, v, positions, k_pos, **kw)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, n_heads * head_dim)
    return matmul(out, p["wo"]), layer_cache


def precompute_cross_kv(p, memory: torch.Tensor, n_kv_heads: int,
                        head_dim: int):
    """Encoder memory ``[B, S, D]`` -> ``(k, v)`` in ``[B, KV, S, hd]`` for
    the decoder's cross-attention (no bias, no RoPE)."""
    B, S, _ = memory.shape
    k = matmul(memory, p["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = matmul(memory, p["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return k.transpose(1, 2), v.transpose(1, 2)
