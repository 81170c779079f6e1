"""Plain PyTorch version of ``flash_attention_flat``: the yardstick of the
Hopper kernel.

Same flat layout as the kernel (``q [H, Sq, hd]``, ``k``/``v [HK, Sk,
hd]``, q head ``h`` reads kv head ``h // g``).  It materialises every
score in float32 and masks the way the TPU kernel masks:
``where(ok, s, NEG_INF)`` with the finite ``NEG_INF = -2**20``, keys at
``k_pos >= 2**29`` invalid, causal ``q_pos >= k_pos``, window ``q_pos -
k_pos < window``, softcap ``tanh(s / cap) * cap`` before the mask.  The
softmax and the product with ``v`` run in float32; the output is cast to
q's dtype.

A row with no visible key gets the mean of ``v`` over the ``Sk`` keys
passed in, never NaN: every score of such a row is ``NEG_INF``, so the
softmax is uniform.  That is the TPU kernel's answer whenever its kv tile
divides ``Sk`` (with a ragged tile it also counts its own zero padding).

The CPU path of :func:`..ops.flash_attention` runs this; on a card the
path runs the kernel, and the tests and ``chip_smoke.py`` call this
directly to hold the kernel against it.
"""
from __future__ import annotations

import torch

from .kernel import NEG_INF, POS_LIMIT


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                         g: int, scale: float, causal: bool, window: int,
                         attn_cap: float) -> torch.Tensor:
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    qg = q.reshape(HK, g, Sq, hd).float()
    s = torch.einsum("kgqd,kcd->kgqc", qg, k.float()) * scale
    if attn_cap > 0.0:
        s = torch.tanh(s * (1.0 / attn_cap)) * attn_cap
    qp = q_pos.to(device=q.device, dtype=torch.float32)
    kp = k_pos.to(device=q.device, dtype=torch.float32)
    ok = (kp < POS_LIMIT)[None, :].expand(Sq, Sk)
    if causal:
        ok = ok & (qp[:, None] >= kp[None, :])
    if window > 0:
        ok = ok & ((qp[:, None] - kp[None, :]) < window)
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("kgqc,kcd->kgqd", w, v.float())
    return out.to(q.dtype).reshape(H, Sq, hd)
