"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan).  d_ff=0 in the assignment: the
feed-forward capacity lives in the blocks' own up-projections.

The port of ``repro/models/xlstm.py``.  The reference runs both blocks as
XLA (no Pallas kernel), so they stay plain PyTorch on both devices: each
``lax.scan`` is a Python loop over tensors (a hand-written recurrence
kernel is later speed work).  ``hint=`` (a sharding constraint in the
reference) is accepted and ignored.  What must match the reference, and
how:

- the mLSTM forms: ``L = min(chunk, S)``; the chunkwise form only where
  ``S % L == 0`` and ``S > 1``, the sequential one otherwise (decode);
- q and k divided by ``sqrt(hd)`` after the cast to float32; the gate
  preactivations taken from the ``u @ w`` product in the activations'
  dtype and only then cast; the stabilizer's running maximum
  (``torch.cummax``, the reference's ``lax.cummax``); the initial ``m``
  -30; the denominator floored at ``exp(-m)``;
- the output norm ``rsqrt(mean(h**2) + 1e-6) * (1 + out_norm)`` in
  float32 (``1 + out_norm`` in the norm's own dtype, as jnp's weak
  scalar keeps it), gated by ``silu(z)`` and cast to ``x.dtype``;
- sLSTM's input and recurrent products in float32 (on the card with TF32
  off); its initial ``n`` 1, floored at 1e-6; its ``r_*`` full
  ``d_in x d_in`` matrices (the block's ``n_heads`` is unused);
- mLSTM's ``silu`` and ``log_sigmoid`` in jax.nn's formulas
  (:mod:`repro_torch.models.layers`), which torch's fused ones round
  otherwise in bf16.

sLSTM stacks ``w_z|w_i|w_f|w_o`` and ``r_z|r_i|r_f|r_o`` into one
``[d_in, 4 d_in]`` product each (one launch a step for the recurrence);
the bias is added after the recurrent product, in the reference's order.
Its time loop is one autograd node (:class:`_SLSTMScan`) whose backward
steps back through time by hand; it runs entirely in float32, where
torch's fused ``sigmoid``/``logsigmoid`` are within an ulp of jax.nn's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

import torch.nn.functional as F

from .layers import KeyGen, log_sigmoid, make_const, make_param, matmul, silu

GATES = "zifo"
N_FLOOR = 1e-6              # sLSTM's normalizer floor


def _running_max(a: torch.Tensor) -> torch.Tensor:
    """The mLSTM stabilizer's running maximum over the chunk's steps (the
    reference's ``lax.cummax``)."""
    return torch.cummax(a, dim=-1).values


# ---------------------------------------------------------------------------
# mLSTM: per-head matrix memory C [hd, hd], exponential gating; computed in
# chunkwise-parallel form (intra-chunk attention-like + inter-chunk recurrence)
# ---------------------------------------------------------------------------

def init_mlstm(kg: Optional[KeyGen], d_model: int, n_heads: int, dtype,
               proj_factor: float = 2.0, vec_dtype=torch.float32,
               mode: str = "normal", device=None) -> Dict[str, torch.Tensor]:
    """The block's weights, drawn in the reference's order; the gate biases
    and ``out_norm`` (float32 in the reference) in ``vec_dtype``."""
    d_in = int(proj_factor * d_model)
    assert d_in % n_heads == 0
    gen = kg() if kg is not None else None
    kw = dict(mode=mode, device=device)
    return {
        "up_proj": make_param(gen, (d_model, 2 * d_in), dtype, **kw),
        "wq": make_param(gen, (d_in, d_in), dtype, **kw),
        "wk": make_param(gen, (d_in, d_in), dtype, **kw),
        "wv": make_param(gen, (d_in, d_in), dtype, **kw),
        "w_i": make_param(gen, (d_in, n_heads), dtype, **kw),   # input gate
        "w_f": make_param(gen, (d_in, n_heads), dtype, **kw),   # forget gate
        "b_i": make_const((n_heads,), 0.0, vec_dtype, mode, device),
        "b_f": make_const((n_heads,), 3.0, vec_dtype, mode, device),
        "out_norm": make_const((d_in,), 0.0, vec_dtype, mode, device),
        "down_proj": make_param(gen, (d_in, d_model), dtype, **kw),
    }


def _mlstm_sequential(q, k, v, log_i, log_f, C, n, m):
    """Step recurrence (exact reference + the decode path).  q/k/v
    ``[B, H, S, hd]``, the gates ``[B, H, S]``; returns (h ``[B, H, S,
    hd]``, (C, n, m))."""
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        li, lf = log_i[..., t], log_f[..., t]
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        f_ = torch.exp(lfm - m_new)
        i_ = torch.exp(li - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def _mlstm_chunkwise(q, k, v, log_i, log_f, C, n, m, chunk: int):
    """Chunkwise-parallel mLSTM (the xLSTM paper's training form): the
    matrix memory recurs only across chunk boundaries, within a chunk
    everything is a batched (attention-like) product.  The same maths as
    the sequential recurrence."""
    B, H, S, hd = q.shape
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        qt, kt, vt = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        li, lf = log_i[..., sl], log_f[..., sl]
        b = torch.cumsum(lf, dim=-1)                  # inclusive forget-cumlog
        # per-step stabilizer: max(inter, best intra source)
        a_run = _running_max(li - b)
        m_j = torch.maximum(m[..., None] + b, b + a_run)          # [B,H,L]
        # inter-chunk: q_j . C_prev, decayed by exp(b_j + m - m_j)
        w_inter = torch.exp(b + m[..., None] - m_j)
        num = torch.einsum("bhld,bhde->bhle", qt, C) * w_inter[..., None]
        den = torch.einsum("bhld,bhd->bhl", qt, n) * w_inter
        # intra-chunk: D_jk = exp(b_j - b_k + i_k - m_j) for k <= j
        expo = b[..., :, None] - b[..., None, :] + li[..., None, :] \
            - m_j[..., :, None]
        D = torch.where(mask, torch.exp(expo), 0.0)               # [B,H,L,L]
        s = torch.einsum("bhld,bhkd->bhlk", qt, kt) * D
        num = num + torch.einsum("bhlk,bhke->bhle", s, vt)
        den = den + s.sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None])
        # carry to the next chunk (stabilized at m_last)
        bL = b[..., -1:]                                          # [B,H,1]
        m_new = torch.maximum(m + bL[..., 0],
                              (bL - b + li).max(dim=-1).values)
        w_old = torch.exp(m + bL[..., 0] - m_new)
        w_src = torch.exp(bL - b + li - m_new[..., None])         # [B,H,L]
        C = C * w_old[..., None, None] + torch.einsum(
            "bhl,bhld,bhle->bhde", w_src, kt, vt)
        n = n * w_old[..., None] + torch.einsum("bhl,bhld->bhd", w_src, kt)
        m = m_new
    return torch.cat(hs, dim=2), (C, n, m)


def mlstm_form(S: int, chunk: int) -> str:
    """The form :func:`apply_mlstm` takes for ``S`` tokens: ``"chunkwise"``
    or ``"sequential"`` (decode, and lengths no chunk divides)."""
    if S > 1 and S % min(chunk, S) == 0:
        return "chunkwise"
    return "sequential"


def apply_mlstm(p, x: torch.Tensor, *, n_heads: int, chunk: int = 64,
                state: Optional[Dict[str, torch.Tensor]] = None, hint=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """mLSTM block: chunkwise-parallel for S>1, sequential for decode.
    ``x [B, S, D]``; ``state`` (decode) ``{C [B,H,hd,hd], n [B,H,hd],
    m [B,H]}``.  Returns (y [B, S, D], the new state or None)."""
    B, S, D = x.shape
    d_in = p["wq"].shape[0]
    hd = d_in // n_heads

    up = matmul(x, p["up_proj"])
    u, z = up[..., :d_in], up[..., d_in:]

    def heads(t):
        return t.reshape(B, S, n_heads, hd).transpose(1, 2)

    sqrt_hd = float(np.sqrt(np.float32(hd)))
    q = heads(matmul(u, p["wq"])).float() / sqrt_hd
    k = heads(matmul(u, p["wk"])).float() / sqrt_hd
    v = heads(matmul(u, p["wv"])).float()
    # gates: [B, H, S]
    log_i = matmul(u, p["w_i"]).float().transpose(1, 2) + p["b_i"][:, None]
    log_f = log_sigmoid(matmul(u, p["w_f"]).float().transpose(1, 2)
                         + p["b_f"][:, None])

    if state is not None:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    else:
        C0, n0, m0 = _mlstm_zeros(B, n_heads, hd, x.device)

    if mlstm_form(S, chunk) == "chunkwise":
        hbh, (C, n, m) = _mlstm_chunkwise(q, k, v, log_i, log_f, C0, n0, m0,
                                          chunk)
    else:
        hbh, (C, n, m) = _mlstm_sequential(q, k, v, log_i, log_f, C0, n0,
                                           m0)

    # group-norm-ish output normalization per head, then gate + down-project
    hn = hbh.transpose(1, 2)                                  # [B,S,H,hd]
    hn = hn * torch.rsqrt(torch.mean(hn * hn, dim=-1, keepdim=True) + 1e-6)
    h = hn.reshape(B, S, d_in) * (1.0 + p["out_norm"])
    h = (h * silu(z.float())).to(x.dtype)
    out = matmul(h, p["down_proj"])
    new_state = {"C": C, "n": n, "m": m} if state is not None else None
    return out, new_state


def init_mlstm_state(batch: int, d_model: int, n_heads: int,
                     proj_factor: float = 2.0,
                     device=None) -> Dict[str, torch.Tensor]:
    d_in = int(proj_factor * d_model)
    C, n, m = _mlstm_zeros(batch, n_heads, d_in // n_heads, device)
    return {"C": C, "n": n, "m": m}


def _mlstm_zeros(batch: int, n_heads: int, hd: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(batch, n_heads, hd, hd, **f32),
            torch.zeros(batch, n_heads, hd, **f32),
            torch.full((batch, n_heads), -30.0, **f32))


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with exponential gating, sequential by construction
# ---------------------------------------------------------------------------

def init_slstm(kg: Optional[KeyGen], d_model: int, n_heads: int, dtype,
               proj_factor: float = 2.0, vec_dtype=torch.float32,
               mode: str = "normal", device=None) -> Dict[str, torch.Tensor]:
    """The block's weights, drawn in the reference's order (``n_heads`` is
    unused there too); the biases in ``vec_dtype``."""
    d_in = int(proj_factor * d_model)
    gen = kg() if kg is not None else None
    kw = dict(mode=mode, device=device)
    p = {"up_proj": make_param(gen, (d_model, d_in), dtype, **kw)}
    for g in GATES:
        p[f"w_{g}"] = make_param(gen, (d_in, d_in), dtype, **kw)
    for g in GATES:
        p[f"r_{g}"] = make_param(gen, (d_in, d_in), dtype, scale=0.5, **kw)
    for g in GATES:
        p[f"b_{g}"] = make_const((d_in,), 3.0 if g == "f" else 0.0,
                                 vec_dtype, mode, device)
    p["down_proj"] = make_param(gen, (d_in, d_model), dtype, **kw)
    return p


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over a sequence, one autograd node: ``pre [S,
    B, 4 d_in]`` (the input contributions of every step, time-major,
    gates ``z|i|f|o``), the stacked recurrent matrix ``R [d_in, 4 d_in]``,
    the bias ``[4 d_in]`` and the state ``c, n, m, h [B, d_in]`` ->
    ``(h of every step [S, B, d_in], c, n, m)``, all float32.

    The forward is the reference's step (``g = (pre_t + h @ R) + b``, the
    exponential gates stabilized by ``m``, ``n`` floored at
    ``N_FLOOR``); the backward is its derivative taken by hand, stepping
    back through time with what the forward kept, as autograd would
    derive it (``torch.maximum`` and the floor split a tie evenly, as
    ``jnp.maximum`` does) but in a third of the launches, and ``dR`` as
    one product over every step.  An eager step costs ~17 launches
    either way, and autograd's own bookkeeping was most of a training
    step's time."""

    @staticmethod
    def forward(ctx, pre, R, bias, c, n, m, h):
        d = R.shape[0]
        want = any(ctx.needs_input_grad)
        keep = {k: [] for k in ("g", "z", "o", "i", "f", "c", "n", "m")}
        init = (c, n, m, h)
        hs = []
        for pre_t in pre.unbind(0):
            g = torch.addmm(pre_t, h, R) + bias
            gz, gi, gf, go = g.split(d, dim=-1)
            z = torch.tanh(gz)
            lfm = F.logsigmoid(gf) + m
            o = torch.sigmoid(go)
            m = torch.maximum(lfm, gi)
            i_ = torch.exp(gi - m)
            f_ = torch.exp(lfm - m)
            c = f_ * c + i_ * z
            n = torch.clamp_min(f_ * n + i_, N_FLOOR)
            h = o * (c / n)
            hs.append(h)
            if want:
                for k, v in zip(keep, (g, z, o, i_, f_, c, n, m)):
                    keep[k].append(v)
        H = torch.stack(hs)
        if want:
            ctx.save_for_backward(R, *init, H,
                                  *(torch.stack(v) for v in keep.values()))
            ctx.floor = N_FLOOR
        return H, c, n, m

    @staticmethod
    def backward(ctx, dH, dc, dn, dm):
        R, c0, n0, m0, h0, H, G, Z, O, I, Fg, C, N, M = ctx.saved_tensors
        S, d = H.shape[0], R.shape[0]
        zeros = torch.zeros_like(c0)
        dH = torch.zeros_like(H) if dH is None else dH
        dc = zeros if dc is None else dc
        dn = zeros if dn is None else dn
        dm = zeros if dm is None else dm
        prev = (lambda X, x0: torch.cat([x0[None], X[:-1]]))
        C_p, N_p, M_p = prev(C, c0), prev(N, n0), prev(M, m0)
        gi, gf = G[..., d:2 * d], G[..., 2 * d:3 * d]
        # what the loop reads, for every step at once
        lfm = F.logsigmoid(gf) + M_p
        wl = (lfm > gi).float() + 0.5 * (lfm == gi).float()
        wi = 1.0 - wl
        n_pre = Fg * N_p + I
        wn = (n_pre > ctx.floor).float() + 0.5 * (n_pre == ctx.floor).float()
        ON, CN = O / N, C / N
        OCN2 = ON * CN
        CNo = CN * O * (1.0 - O)                # d h / d go
        IZ = I * (1.0 - Z * Z)                  # d c / d gz
        sgf = torch.sigmoid(-gf)                # d logsigmoid(gf) / d gf
        DG = torch.empty_like(G)
        dh = torch.zeros_like(c0)
        RT = R.t()
        # every step's slices made at once (one view each per step costs
        # more than the step's arithmetic)
        per_step = [X.unbind(0) for X in (
            dH, ON, OCN2, wn, N_p, C_p, Z, I, Fg, wl, wi, IZ, sgf, CNo, DG,
            DG[..., :d], DG[..., d:2 * d], DG[..., 2 * d:3 * d],
            DG[..., 3 * d:])]
        for (dH_t, ON_t, OCN2_t, wn_t, Np_t, Cp_t, Z_t, I_t, F_t, wl_t, wi_t,
             IZ_t, sgf_t, CNo_t, DG_t, dgz, dgi_out, dgf, dgo) in \
                reversed(list(zip(*per_step))):
            dh_t = dH_t + dh
            dc = torch.addcmul(dc, dh_t, ON_t)
            dn_pre = torch.addcmul(dn, dh_t, OCN2_t, value=-1.0) * wn_t
            df = torch.addcmul(dn_pre * Np_t, dc, Cp_t)
            di = torch.addcmul(dn_pre, dc, Z_t)
            dgi = di * I_t
            dlfm = df * F_t
            dmn = dm - dgi - dlfm
            dlfm = torch.addcmul(dlfm, dmn, wl_t)
            torch.addcmul(dgi, dmn, wi_t, out=dgi_out)
            torch.mul(dc, IZ_t, out=dgz)
            torch.mul(dlfm, sgf_t, out=dgf)
            torch.mul(dh_t, CNo_t, out=dgo)
            dn = dn_pre * F_t
            dc = dc * F_t
            dm = dlfm
            dh = DG_t @ RT
        H_p = prev(H, h0)
        dR = H_p.reshape(-1, d).t() @ DG.reshape(-1, 4 * d)
        return DG, dR, DG.sum((0, 1)), dc, dn, dm, dh


def apply_slstm(p, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None, hint=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """sLSTM block.  ``x [B, S, D]``; ``state`` (decode) ``{c, n, m, h}``,
    each ``[B, d_in]`` float32.  Returns (y [B, S, D], the new state or
    None)."""
    B, S, D = x.shape
    d_in = p["w_z"].shape[0]
    u = matmul(x, p["up_proj"]).float()
    # the input contributions of every step, time-major, the four gates
    # side by side
    pre = u.transpose(0, 1) @ torch.cat([p[f"w_{g}"].float() for g in GATES],
                                        dim=1)
    R = torch.cat([p[f"r_{g}"].float() for g in GATES], dim=1)
    bias = torch.cat([p[f"b_{g}"] for g in GATES]).float()

    if state is not None:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    else:
        c, n, m, h = _slstm_zeros(B, d_in, x.device)
    H, c, n, m = _SLSTMScan.apply(pre, R, bias, c, n, m, h)
    out = matmul(H.transpose(0, 1).to(x.dtype), p["down_proj"])
    new_state = ({"c": c, "n": n, "m": m, "h": H[-1]} if state is not None
                 else None)
    return out, new_state


def init_slstm_state(batch: int, d_model: int, proj_factor: float = 2.0,
                     device=None) -> Dict[str, torch.Tensor]:
    c, n, m, h = _slstm_zeros(batch, int(proj_factor * d_model), device)
    return {"c": c, "n": n, "m": m, "h": h}


def _slstm_zeros(batch: int, d_in: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(batch, d_in, **f32), torch.ones(batch, d_in, **f32),
            torch.zeros(batch, d_in, **f32), torch.zeros(batch, d_in, **f32))
