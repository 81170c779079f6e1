"""Shared neural-net building blocks (PyTorch; parameters in mappings).

The port of ``repro/models/layers.py``.  Functions take their weights as
a mapping (``p["wq"]``), so an ``nn.ParameterDict`` and a plain dict both
serve.  Weights are laid out ``[in, out]`` (``x @ W``) as in the
reference, so carrying them across is a plain copy.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "int8": torch.int8}[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

class KeyGen:
    """The explicit random source of initialisation: one
    ``torch.Generator`` on the device the weights are drawn on, seeded
    once; every ``kg()`` returns it for the next draw."""

    def __init__(self, seed: int, device="cpu"):
        self.generator = torch.Generator(device=torch.device(device))
        self.generator.manual_seed(int(seed))

    def __call__(self) -> torch.Generator:
        return self.generator


# what make_param and make_const pass each tensor through (on_draw)
_DRAW_HOOKS: List[Callable[[torch.Tensor], torch.Tensor]] = []


@contextlib.contextmanager
def on_draw(hook: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, every tensor :func:`make_param` and
    :func:`make_const` make (drawn, a constant, or in ``mode="empty"``
    only allocated) is passed through ``hook`` and its result returned in
    its place, in the order the model makes them: a rank of a mesh keeps
    its shard of each weight as it is drawn
    (:meth:`repro_torch.launch.steps.CellProgram.materialize`), so no
    whole model is held at once."""
    _DRAW_HOOKS.append(hook)
    try:
        yield
    finally:
        _DRAW_HOOKS.pop()


def _made(t: torch.Tensor) -> torch.Tensor:
    return _DRAW_HOOKS[-1](t) if _DRAW_HOOKS else t


def make_param(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
               scale: float = 1.0, mode: str = "normal",
               device=None) -> torch.Tensor:
    """A weight: float32 normals drawn from ``gen`` on its device, scaled
    by ``scale / sqrt(fan_in)`` and cast to ``dtype``.  ``mode="empty"``
    allocates on ``device`` without drawing (weights about to be copied
    in)."""
    device = gen.device if gen is not None else device
    if mode == "empty":
        return _made(torch.empty(shape, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) > 1 else max(1, shape[0])
    std = scale / np.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return _made(x.mul_(std).to(dtype))


def make_const(shape, value: float, dtype, mode: str = "normal",
               device=None) -> torch.Tensor:
    """A constant leaf (a bias, a gate's opening value): made in float32
    and cast to ``dtype``; ``mode="empty"`` only allocates it."""
    if mode == "empty":
        return _made(torch.empty(shape, dtype=dtype, device=device))
    return _made(torch.full(shape, value, dtype=torch.float32,
                            device=device).to(dtype))


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class _Sigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))``, each step rounded in ``x``'s dtype, as XLA
    expands ``jax.nn.sigmoid`` (in bf16 ``torch.sigmoid`` rounds once and
    reads one ulp off for about a third of the inputs); the backward is
    ``s * (1 - s)``, as jax's, which stays finite where ``exp(-x)``
    overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` to the bit (see :class:`_Sigmoid`)."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` takes ``log1p(exp(x))`` and reads
    an ulp off in bf16)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping."""
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial rotation supported for glm4)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rotary_fraction: float, theta: float,
               device=None):
    """Inverse frequencies computed in float64 numpy and only then cast to
    float32, as the reference does: with theta = 500000 a float32
    ``theta ** x`` drifts at large positions.  The tensor is made once per
    device and shape and shared: a fresh host-to-device copy per call
    would stall the host on every layer of every decode step."""
    return _rope_freqs(int(head_dim), float(rotary_fraction), float(theta),
                       torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _rope_freqs(head_dim: int, rotary_fraction: float, theta: float,
                device: torch.device):
    rot_dim = int(head_dim * rotary_fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2) / rot_dim))
    return rot_dim, torch.as_tensor(inv, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               rotary_fraction: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    head_dim = x.shape[-1]
    rot_dim, inv = rope_freqs(head_dim, rotary_fraction, theta, x.device)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    ang = positions[..., :, None, None].float() * inv   # [.., S, 1, rd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Products and the gated MLP (llama-family)
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands first promoted to a common dtype, as
    jnp promotes (torch refuses mixed dtypes).  The models hold their
    weights in the activations' dtype, so on their paths it casts
    nothing."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def init_mlp(kg: KeyGen, d_model: int, d_ff: int, dtype,
             mode: str = "normal", device=None) -> Dict[str, torch.Tensor]:
    gen = kg() if kg is not None else None
    return {
        "wi_gate": make_param(gen, (d_model, d_ff), dtype, mode=mode,
                              device=device),
        "wi_up": make_param(gen, (d_model, d_ff), dtype, mode=mode,
                            device=device),
        "wo": make_param(gen, (d_ff, d_model), dtype, mode=mode,
                         device=device),
    }


def apply_mlp(p, x: torch.Tensor, act: str = "silu",
              par=None) -> torch.Tensor:
    """The gated MLP.  With ``par`` (a rank's
    :class:`~repro_torch.parallel.collectives.Spmd`) the weights are its
    model-axis shards, ``wi_*`` split by columns and ``wo`` by rows, and
    the rows' partial products are all-reduced over the model axis."""
    h = act_fn(act)(matmul(x, p["wi_gate"])) * matmul(x, p["wi_up"])
    y = matmul(h, p["wo"])
    return y if par is None else par.reduce(y, "mlp/wo")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(kg: KeyGen, vocab: int, d_model: int, dtype, tie: bool,
               mode: str = "normal",
               device=None) -> Dict[str, torch.Tensor]:
    gen = kg() if kg is not None else None
    p = {"embedding": make_param(gen, (vocab, d_model), dtype, scale=1.0,
                                 mode=mode, device=device)}
    if not tie:
        p["lm_head"] = make_param(gen, (d_model, vocab), dtype, mode=mode,
                                  device=device)
    return p


def embed_tokens(p, tokens: torch.Tensor, scale_embed: bool, d_model: int,
                 dtype: torch.dtype, par=None) -> torch.Tensor:
    """The tokens' rows of the table.  With ``par`` over a model axis of
    more than one device the table is this rank's slice of the
    vocabulary: a token outside it reads zeros, and the all-reduce over
    the model axis adds the one rank's row to zeros (exact)."""
    table = p["embedding"]
    if par is None or par.tp == 1:
        x = table[tokens].to(dtype)
    else:
        local = tokens - par.tp_index * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)].to(dtype)
        x = par.reduce(torch.where(mine[..., None], x, 0),
                       "embed/embedding")
    if scale_embed:
        x = x * torch.tensor(np.sqrt(d_model), dtype=dtype)
    return x


def unembed(p, x: torch.Tensor, logit_cap: float = 0.0,
            n_valid: int = 0, par=None) -> torch.Tensor:
    """Logits in float32.  The product runs in the activation dtype and
    only its result is widened, as in the reference; padded-vocab columns
    get -1e9 so they never win a softmax or an argmax.  With ``par`` the
    head is this rank's slice of the vocabulary over the model axis, and
    so are the logits (the ``logits`` hint)."""
    if "lm_head" in p:
        logits = matmul(x, p["lm_head"])
    else:
        logits = x @ p["embedding"].to(x.dtype).T
    logits = softcap(logits.float(), logit_cap)
    V = logits.shape[-1]
    lo = 0 if par is None else par.tp_index * V
    if n_valid and n_valid < lo + V:
        mask = torch.where(torch.arange(lo, lo + V, device=logits.device)
                           < n_valid, 0.0, -1e9)
        logits = logits + mask
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Stable CE over logits.  [B,S,V] x [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss.mean()
