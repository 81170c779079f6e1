"""Public op: flash attention in the model's ``[B, KV, G, S, hd]`` layout
(the ``attn_impl="pallas"`` path of :mod:`repro_torch.models.attention`),
dispatched by device.

A CUDA tensor goes to the hand-written Hopper kernel
(:func:`.kernel.flash_attention_cuda`); a CPU tensor goes to the plain
PyTorch version (:mod:`.ref`).  There is no switch between the two: the
tensors' device decides, so the card never runs the plain version.  A
``meta`` tensor (the dry run's trace) gets a ``meta`` output through the
two products of a dense attention, ``q k^T`` and ``p v``, so that
``FlopCounterMode`` counts ``4 * H * Sq * Sk * hd``, as it counts
scaled-dot-product attention (no mask skipped).
"""
from __future__ import annotations

import torch

from . import ref
from .kernel import check_inputs, flash_attention_cuda


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                         g: int, scale: float, causal: bool, window: int,
                         attn_cap: float) -> torch.Tensor:
    """``q [H, Sq, hd]``, ``k``/``v [HK, Sk, hd]`` with ``H = HK * g``
    -> ``[H, Sq, hd]`` in q's dtype."""
    kw = dict(g=int(g), scale=float(scale), causal=bool(causal),
              window=int(window), attn_cap=float(attn_cap))
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_pos, k_pos, **kw)
    if q.device.type == "meta":
        return _meta_products(q, k, v, int(g))
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention for device {q.device}")
    check_inputs(q, k, v, q_pos, k_pos, g)
    return ref.flash_attention_flat(q, k, v, q_pos, k_pos, **kw)


def _meta_products(q, k, v, g: int) -> torch.Tensor:
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    s = q.reshape(HK, g * Sq, hd) @ k.transpose(1, 2)
    return (s @ v).reshape(H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal,
                        window, attn_cap, scale) -> tuple:
    """The training forward: ``q [B, KV, G, Sq, hd]``, ``k``/``v [B, KV,
    Sk, hd]`` -> ``(out [B, KV, G, Sq, hd], lse [B, KV, G, Sq] f32)``, the
    rows' log-sum-exp that the recompute backward reads.  On a CUDA tensor
    the kernel writes both (``tc`` or ``simt``, never ``decode``); on the
    CPU the plain version computes them."""
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[2]
    flat = (q.reshape(B * KV * G, Sq, hd).contiguous(),
            k.reshape(B * KV, Sk, hd).contiguous(),
            v.reshape(B * KV, Sk, hd).contiguous(), q_pos, k_pos)
    kw = dict(g=G, scale=float(scale), causal=bool(causal),
              window=int(window), attn_cap=float(attn_cap))
    if q.is_cuda:
        out, lse = flash_attention_cuda(*flat, **kw, lse=True)
    elif q.device.type == "cpu":
        check_inputs(*flat, G)
        out, lse = ref.flash_attention_flat_lse(*flat, **kw)
    else:
        raise ValueError(f"no flash_attention_lse for device {q.device}")
    return out.reshape(B, KV, G, Sq, hd), lse.reshape(B, KV, G, Sq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal,
                    window, attn_cap, scale) -> torch.Tensor:
    """``q [B, KV, G, Sq, hd]``, ``k``/``v [B, KV, Sk, hd]`` ->
    ``[B, KV, G, Sq, hd]``."""
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[2]
    out = flash_attention_flat(
        q.reshape(B * KV * G, Sq, hd).contiguous(),
        k.reshape(B * KV, Sk, hd).contiguous(),
        v.reshape(B * KV, Sk, hd).contiguous(), q_pos, k_pos, g=G,
        scale=scale, causal=causal, window=window, attn_cap=attn_cap)
    return out.reshape(B, KV, G, Sq, hd)
