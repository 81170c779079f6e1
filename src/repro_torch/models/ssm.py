"""Mamba (selective state-space) block, used by jamba and available to any
hybrid stack: a chunked scan for a prompt, an O(1)-state decode step.

The port of ``repro/models/ssm.py``.  The reference runs the block as XLA
(its ``lax.associative_scan`` within a chunk, a ``lax.scan`` over the
chunks), so it stays plain PyTorch on both devices; a hand-written scan
kernel is later speed work.  Two differences of form, neither of maths:

- **Within a chunk** the state runs as a loop over the chunk's steps,
  ``h = dA_t * h + dBx_t``, where the reference scans the chunk
  associatively and then folds in the carried state.  The sums are taken
  in another order (equal up to float32 rounding; the tests state the
  tolerance).  The last chunk is simply shorter: the reference pads it
  with ``dA = 1`` and ``dBx = 0``, steps that leave ``h`` exactly as it
  was.
- **Nothing the size of the sequence times the state is built.** The
  reference makes ``dA``, ``dBx`` and the states ``[B, L, d_in, N]``
  over the whole sequence; the port makes ``dA`` and ``dBx`` one chunk at
  a time and contracts each step's state with ``C`` at once, so the peak
  is two chunk-sized tensors (at jamba's width and 13 prompts of 2,048
  tokens: 1.74 GB each at chunk 256, against ~14 GB each).

``silu`` and ``softplus`` take jax.nn's formulas
(:mod:`repro_torch.models.layers`), so bf16 rounds where the reference's
op-by-op run does.  ``unroll`` (the reference's accounting switch) is
accepted and ignored.  On ``meta`` tensors (the dry run's trace) the step
loop runs as one product of the same FLOPs: ``L`` steps of bookkeeping
on shapes would take minutes at a 32k prompt.

On a mesh (``par``, a rank's
:class:`~repro_torch.parallel.collectives.Spmd`, with a model axis of
more than one device) the inner channels ``d_in`` are split over the
model axis, as the specs place them: the rank holds ``[x_r | z_r]`` of
``in_proj`` (:func:`~repro_torch.parallel.sharding.param_blocks`), its
channels of ``conv_w``, ``conv_b``, ``dt_proj_w/b``, ``a_log``,
``d_skip``, its rows of ``x_proj`` and ``out_proj``, and its channels of
the state.  ``x_proj`` is row-parallel: its partial product is summed
over the ranks in float32 and rounded once (``mamba/x_proj``), as one
card's product rounds once, before ``dt``, ``B`` and ``C`` are split
from it (``softplus`` and ``exp`` would amplify a second rounding);
``out_proj``'s partial result is all-reduced as the attention's ``wo``
is (``mamba/out_proj``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import KeyGen, make_const, make_param, matmul, silu, softplus


def init_mamba(kg: Optional[KeyGen], d_model: int, dtype, d_state: int = 16,
               d_conv: int = 4, expand: int = 2, dt_rank: int = 0,
               vec_dtype=torch.float32, mode: str = "normal",
               device=None) -> Dict[str, torch.Tensor]:
    """The block's weights, drawn in the reference's order; ``dt_proj_b``
    (softplus^-1(0.01)), ``a_log`` (S4D-real) and ``d_skip`` (float32 in
    the reference) in ``vec_dtype``, ``conv_b`` in ``dtype``."""
    d_in = expand * d_model
    dt_rank = dt_rank or -(-d_model // 16)
    gen = kg() if kg is not None else None
    kw = dict(mode=mode, device=device)
    if mode == "empty":
        a_log = torch.empty(d_in, d_state, dtype=vec_dtype, device=device)
    else:
        a = torch.arange(1, d_state + 1, dtype=torch.float32,
                         device=device).repeat(d_in, 1)
        a_log = torch.log(a).to(vec_dtype)
    return {
        "in_proj": make_param(gen, (d_model, 2 * d_in), dtype, **kw),
        "conv_w": make_param(gen, (d_conv, d_in), dtype, scale=1.0, **kw),
        "conv_b": make_const((d_in,), 0.0, dtype, mode, device),
        "x_proj": make_param(gen, (d_in, dt_rank + 2 * d_state), dtype, **kw),
        "dt_proj_w": make_param(gen, (dt_rank, d_in), dtype, **kw),
        "dt_proj_b": make_const((d_in,), -4.6, vec_dtype, mode, device),
        "a_log": a_log,
        "d_skip": make_const((d_in,), 1.0, vec_dtype, mode, device),
        "out_proj": make_param(gen, (d_in, d_model), dtype, **kw),
    }


def causal_conv(hist: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """The causal depthwise convolution: ``hist [B, d_conv - 1 + S, d_in]``
    (the cached or zero history, then the tokens) against ``w [d_conv,
    d_in]`` -> ``[B, S, d_in]``, summed over the window in float32 (the
    reference's ``einsum("bswd,wd->bsd")`` of the stacked windows, without
    the stacked copy) and returned in the promoted dtype of the two."""
    out = hist[:, :S].float() * w[0].float()
    for i in range(1, w.shape[0]):
        out = out + hist[:, i:i + S].float() * w[i].float()
    return out.to(torch.promote_types(hist.dtype, w.dtype))


def _x_proj(x: torch.Tensor, w: torch.Tensor, par) -> torch.Tensor:
    """``x @ x_proj``; on a mesh the rank's rows' partial product, summed
    over the model axis in float32 and rounded once."""
    if par is None or par.tp == 1:
        return matmul(x, w)
    return par.reduce(matmul(x.float(), w.float()), "mamba/x_proj").to(
        torch.promote_types(x.dtype, w.dtype))


def _selective_ssm(p, x: torch.Tensor, h0: torch.Tensor, chunk: int,
                   unroll: bool = False,
                   par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d_in] post-conv, h0: [B, d_in, N] float32.  Returns
    (y [B, L, d_in] float32, h_final)."""
    B, L, d_in = x.shape
    d_state = p["a_log"].shape[1]
    dt_rank = p["x_proj"].shape[1] - 2 * d_state
    proj = _x_proj(x, p["x_proj"], par)
    dt = softplus(matmul(proj[..., :dt_rank], p["dt_proj_w"])
                    + p["dt_proj_b"]).float()                  # [B,L,d_in]
    Bm = proj[..., dt_rank:dt_rank + d_state].float()
    Cm = proj[..., dt_rank + d_state:].float()
    A = -torch.exp(p["a_log"])                                 # [d_in, N]
    xf = x.float()
    if x.device.type == "meta":
        # every step's h @ C as one product (2 B d_in N FLOPs a step)
        y = (xf.new_empty(B, L, d_in, d_state) @ Cm[..., None])[..., 0]
        return y + xf * p["d_skip"], torch.empty_like(h0)
    h = h0
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        dA = torch.exp(dt[:, sl, :, None] * A)                 # [B,l,d_in,N]
        dBx = (dt[:, sl] * xf[:, sl])[..., None] * Bm[:, sl, None, :]
        for t in range(dA.shape[1]):
            h = torch.addcmul(dBx[:, t], dA[:, t], h)
            ys.append((h @ Cm[:, c0 + t, :, None])[..., 0])
    y = torch.stack(ys, dim=1)
    y = y + xf * p["d_skip"]
    return y, h


def apply_mamba(p, x: torch.Tensor, *, chunk: int = 256, unroll: bool = False,
                state: Optional[Dict[str, torch.Tensor]] = None, par=None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: [B, S, D].  state (decode): {"conv": [B,d_conv-1,d_in],
    "ssm": [B,d_in,N]}, both float32.  Returns (y [B,S,D], new_state or
    None).  ``par``: a rank of a mesh, on its channels (``d_in`` its
    share; the module's docstring)."""
    B, S, D = x.shape
    d_in = p["in_proj"].shape[1] // 2
    d_conv = p["conv_w"].shape[0]
    d_state = p["a_log"].shape[1]

    xz = matmul(x, p["in_proj"])
    xs, z = xz[..., :d_in], xz[..., d_in:]

    # causal depthwise conv over the sequence
    if state is not None:
        hist = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    else:
        hist = F.pad(xs, (0, 0, d_conv - 1, 0))
    xc = silu(causal_conv(hist, p["conv_w"], S) + p["conv_b"])

    h0 = (state["ssm"] if state is not None
          else torch.zeros(B, d_in, d_state, dtype=torch.float32,
                           device=x.device))
    y, h_final = _selective_ssm(p, xc, h0, chunk, unroll, par)
    y = (y * silu(z.float())).to(x.dtype)
    out = matmul(y, p["out_proj"])
    if par is not None:
        out = par.reduce(out, "mamba/out_proj")

    new_state = None
    if state is not None:
        new_state = {"conv": hist[:, -(d_conv - 1):].float(),
                     "ssm": h_final}
    return out, new_state


def init_mamba_state(batch: int, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, device=None,
                     tp: int = 1) -> Dict[str, torch.Tensor]:
    """The zero state of ``batch`` sequences: a rank's ``d_in / tp``
    channels of it on a model axis of ``tp`` devices."""
    d_in = expand * d_model // tp
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros(batch, d_conv - 1, d_in, **f32),
            "ssm": torch.zeros(batch, d_in, d_state, **f32)}
