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

:func:`flash_attention_flat_lse` also returns each row's f32
log-sum-exp ``[H, Sq]`` over its visible keys: the second output of the
kernel's training launches (``tc`` and ``simt``).  A row with no visible
key gets ``NEG_INF + log(Sk)``, the log-sum-exp of its ``Sk`` masked
scores, consistent with the uniform softmax above.

The CPU path of :func:`..ops.flash_attention` runs this; on a card the
path runs the kernel, and the tests and ``chip_smoke.py`` call this
directly to hold the kernel against it.  It launches no copy from the
host, so a CUDA graph can capture it.

:func:`split_partials` and :func:`combine_partials` mirror the decode
route's split-K arithmetic (``csrc/flash_attention_decode.cu``) in plain
PyTorch; no path on the card runs them, the CPU tests hold their
combination against :func:`flash_attention_flat`.
"""
from __future__ import annotations

import torch

from .kernel import NEG_INF, POS_LIMIT, split_chunk


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                         g: int, scale: float, causal: bool, window: int,
                         attn_cap: float) -> torch.Tensor:
    s = _scores(q, k, q_pos, k_pos, g, scale, causal, window, attn_cap)
    return _attend(torch.softmax(s, dim=-1), v, q)


def flash_attention_flat_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_pos: torch.Tensor,
                             k_pos: torch.Tensor, *, g: int, scale: float,
                             causal: bool, window: int,
                             attn_cap: float) -> tuple:
    """``(out, lse)``: :func:`flash_attention_flat`'s output and the
    rows' f32 log-sum-exp ``[H, Sq]``."""
    s = _scores(q, k, q_pos, k_pos, g, scale, causal, window, attn_cap)
    lse = torch.logsumexp(s, dim=-1).reshape(q.shape[0], q.shape[1])
    return _attend(torch.softmax(s, dim=-1), v, q), lse


def _scores(q, k, q_pos, k_pos, g: int, scale: float, causal: bool,
            window: int, attn_cap: float) -> torch.Tensor:
    """Masked f32 scores ``[HK, g, Sq, Sk]``."""
    H, Sq, hd = q.shape
    HK = k.shape[0]
    qg = q.reshape(HK, g, Sq, hd).float()
    s = torch.einsum("kgqd,kcd->kgqc", qg, k.float()) * scale
    if attn_cap > 0.0:
        s = torch.tanh(s * (1.0 / attn_cap)) * attn_cap
    return s.masked_fill(~_visible(q_pos, k_pos, causal, window, q.device),
                         NEG_INF)


def _attend(w: torch.Tensor, v: torch.Tensor, q: torch.Tensor):
    """The softmax weights ``w [HK, g, Sq, Sk]`` times v, in q's dtype and
    flat layout."""
    out = torch.einsum("kgqc,kcd->kgqd", w, v.float())
    return out.to(q.dtype).reshape(q.shape)


def _visible(q_pos, k_pos, causal: bool, window: int, device):
    """``ok [Sq, Sk]``: key valid, causal, inside the window."""
    qp = q_pos.to(device=device, dtype=torch.float32)
    kp = k_pos.to(device=device, dtype=torch.float32)
    ok = (kp < POS_LIMIT)[None, :].expand(qp.shape[0], kp.shape[0])
    if causal:
        ok = ok & (qp[:, None] >= kp[None, :])
    if window > 0:
        ok = ok & ((qp[:, None] - kp[None, :]) < window)
    return ok


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *, g: int,
                   scale: float, causal: bool, window: int, attn_cap: float,
                   splits: int) -> tuple:
    """The decode route's first launch: keys cut into splits of
    :func:`.kernel.split_chunk` keys; for every (kv head, split, row r of
    the ``g * Sq`` packed rows) the split's ``m`` (natural log), ``l`` and
    unnormalised ``acc [hd]``, all f32.  A row that sees no key of a split
    gets ``m = -inf``, ``l = 0``, ``acc = 0``.  Returns ``(m, l, acc)``
    shaped ``[HK, splits, R]``, ``[HK, splits, R]``, ``[HK, splits, R,
    hd]``."""
    H, Sq, hd = q.shape
    HK, Sk, _ = k.shape
    chunk, n = split_chunk(Sk, splits)
    qr = q.reshape(HK, g * Sq, hd).float()
    s = torch.einsum("krd,kcd->krc", qr, k.float()) * scale
    if attn_cap > 0.0:
        s = torch.tanh(s * (1.0 / attn_cap)) * attn_cap
    ok = _visible(q_pos, k_pos, causal, window, q.device).repeat(g, 1)
    s = s.masked_fill(~ok, float("-inf"))
    ms, ls, accs = [], [], []
    for i in range(n):
        x = s[..., i * chunk:(i + 1) * chunk]
        m = x.amax(dim=-1)
        p = torch.exp(x - torch.where(m == float("-inf"), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("krc,kcd->krd", p,
                                 v[:, i * chunk:(i + 1) * chunk].float()))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     v: torch.Tensor, *, Sq: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The decode route's second launch: rescale every split by
    ``exp(m_i - m)``, sum and divide; a row whose total ``l`` is 0 gets
    the mean of v over the ``Sk`` keys.  Returns ``[HK * g, Sq, hd]`` in
    ``dtype``."""
    HK, _, R, hd = acc.shape
    live = l > 0
    top = torch.where(live, m, float("-inf")).amax(dim=1)
    top = torch.where(top == float("-inf"), 0.0, top)
    w = torch.where(live, torch.exp(m - top[:, None]), 0.0)
    total = (l * w).sum(dim=1)
    out = (acc * w[..., None]).sum(dim=1) / \
        total.clamp_min(1e-30)[..., None]
    out = torch.where((total > 0)[..., None], out,
                      v.float().mean(dim=1)[:, None, :])
    return out.to(dtype).reshape(HK * (R // Sq), Sq, hd)
