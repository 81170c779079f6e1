"""The port's Mamba block (``repro_torch.models.ssm``) on the CPU against
the reference's ``repro.models.ssm``.

Weights come from the reference's ``init_mamba`` with the 1-D leaves
(``conv_b``, ``dt_proj_b``, ``d_skip``) moved off their constants, inputs
and states from numpy, carried across as numpy arrays.

The scan sums in another order.  Within a chunk the reference scans
associatively (a tree of ``a2 * b1 + b2`` combines), then folds in the
carried state with the cumulative product of ``dA``; the port steps
``h = dA_t * h + dBx_t``.  Both are the same sums of products of numbers
below 1, rounded at other places, and the padded tail of the last chunk
(the reference's ``dA = 1``, ``dBx = 0``) leaves ``h`` exactly as it was.
So:

- float32: outputs within 1e-5 of the reference output's largest
  magnitude, states within 1e-5 of theirs (the readings are 1e-7 to
  3e-7);
- bfloat16: outputs within 1e-2 of the largest magnitude, about one bf16
  ulp (the port rounds where XLA does: the convolution summed in float32
  and rounded once, ``silu`` and ``softplus`` in jax.nn's formulas, each
  step rounded; the readings are 0 to 9e-8), the conv state (bf16 values
  kept in float32) and the SSM state within 1e-5 of theirs;
- the port's chunked scan against a plain loop over every step: 1e-5;
- gradients (``jax.vjp``) of ``sum(y * dy)`` and the state cotangents:
  every leaf, ``x`` and the initial state within 1e-4 in relative norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.layers import KeyGen as JaxKeyGen
from repro_torch.models import ssm as PS
from repro_torch.models.layers import KeyGen

D = 32                             # d_in 64, d_state 16, d_conv 4, dt_rank 2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-5)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(dtype="float32", seed=0):
    p = JS.init_mamba(JaxKeyGen(jax.random.PRNGKey(seed)), D, JDT[dtype])
    rng = np.random.default_rng(seed + 1)
    p = {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
         if v.ndim == 1 else v for k, v in p.items()}
    tp = {k: torch.from_numpy(_np(v).copy()).to(
        TDT[dtype] if v.dtype == JDT[dtype] else torch.float32)
        for k, v in p.items()}
    return p, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(seed=3):
    ref = JS.init_mamba_state(2, D)
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.5 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in ref.items()}


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    limit = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"max abs err {err} > {limit}"


def _run(p, tp, x, dtype, state, chunk):
    js = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    ts = None if state is None else {k: torch.from_numpy(v.copy())
                                     for k, v in state.items()}
    yj, sj = JS.apply_mamba(p, jnp.asarray(x, JDT[dtype]), chunk=chunk,
                            state=js)
    yt, st = PS.apply_mamba(tp, torch.from_numpy(x).to(TDT[dtype]),
                            chunk=chunk, state=ts)
    return (yj, sj), (yt, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,given", [
    (16, 8, False),      # a multiple of the chunk: two chunks
    (16, 8, True),
    (8, 8, True),        # equal to the chunk
    (5, 8, True),        # below the chunk: one padded chunk
    (20, 8, True),       # not a multiple: the last chunk padded
    (1, 8, True),        # decode from a state
    (2, 8, True),        # fewer tokens than the conv's history
])
def test_apply_mamba_matches_reference(S, chunk, given, dtype):
    p, tp = _params(dtype)
    (yj, sj), (yt, st) = _run(p, tp, _x((2, S, D)), dtype,
                              _state() if given else None, chunk)
    out_tol, state_tol = TOL[dtype]
    assert yt.dtype == TDT[dtype]
    _close(yt, yj, out_tol)
    if not given:
        assert st is None and sj is None
        return
    assert sorted(st) == ["conv", "ssm"]
    for k in sj:
        assert st[k].dtype == torch.float32 and st[k].shape == sj[k].shape
        _close(st[k], sj[k], state_tol)


def test_prompt_then_decode_equals_longer_prompt():
    """Prefill 11 tokens then decode 5 from the returned state (the conv
    history carried in the state) against prefilling all 16, in the port
    alone (float32)."""
    _, tp = _params()
    x = torch.from_numpy(_x((2, 16, D), seed=8))
    s0 = PS.init_mamba_state(2, D)
    full, sf = PS.apply_mamba(tp, x, chunk=4, state=s0)
    y, st = PS.apply_mamba(tp, x[:, :11], chunk=4, state=s0)
    outs = [y]
    for t in range(11, 16):
        y, st = PS.apply_mamba(tp, x[:, t:t + 1], chunk=4, state=st)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full, 1e-5)
    for k in sf:
        _close(st[k], sf[k], 1e-5)


def test_conv_state_round_trip():
    """The conv state holds the last ``d_conv - 1`` conv inputs (the
    in-projection's first half) as float32, and decoding from it equals
    running the longer sequence: for bf16 activations the state keeps
    their bf16 values exactly."""
    p, tp = _params("bfloat16")
    x = torch.from_numpy(_x((2, 9, D), seed=4)).bfloat16()
    _, st = PS.apply_mamba(tp, x, chunk=4,
                           state=PS.init_mamba_state(2, D))
    d_in = tp["in_proj"].shape[1] // 2
    want = (x @ tp["in_proj"])[:, -3:, :d_in]
    assert st["conv"].dtype == torch.float32
    assert torch.equal(st["conv"], want.float())
    assert torch.equal(st["conv"].bfloat16().float(), st["conv"])


def test_chunked_scan_equals_a_step_loop():
    """``_selective_ssm`` at chunks of 1, 3 and 7 against a plain loop over
    every step, from a non-zero state (float32)."""
    _, tp = _params()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 13, 2 * D))
                         .astype(np.float32))
    h0 = torch.from_numpy(_state()["ssm"])
    d_state = tp["a_log"].shape[1]
    r = tp["x_proj"].shape[1] - 2 * d_state
    proj = x @ tp["x_proj"]
    dt = torch.nn.functional.softplus(proj[..., :r] @ tp["dt_proj_w"]
                                      + tp["dt_proj_b"])
    Bm, Cm = proj[..., r:r + d_state], proj[..., r + d_state:]
    A = -torch.exp(tp["a_log"])
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    want = torch.stack(ys, 1) + x * tp["d_skip"]
    for chunk in (1, 3, 7, 13):
        y, hf = PS._selective_ssm(tp, x, h0, chunk)
        _close(y, want, 1e-5)
        _close(hf, h, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_shapes_and_key_order(dtype):
    want = JS.init_mamba(JaxKeyGen(jax.random.PRNGKey(0)), D, JDT[dtype])
    got = PS.init_mamba(KeyGen(0), D, TDT[dtype])
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == str(v.dtype), k
    for k in ("conv_b", "dt_proj_b", "d_skip"):
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    np.testing.assert_allclose(_np(got["a_log"]), _np(want["a_log"]),
                               rtol=1e-7, atol=0)
    assert got["x_proj"].shape == (2 * D, 2 + 2 * 16)      # dt_rank 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 4), (1, 8)])
def test_gradients_match_jax_vjp(S, chunk):
    """Every gradient (each weight and bias, ``x``, the initial state) of
    ``sum(y * dy)`` plus the returned state against random cotangents."""
    p, tp = _params()
    x = _x((2, S, D), seed=6)
    st = _state()
    dy = _x(x.shape, seed=7)
    rng = np.random.default_rng(9)
    ds = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in st.items()}

    def ref(params, xx, state):
        return JS.apply_mamba(params, xx, chunk=chunk, state=state)

    _, vjp = jax.vjp(ref, p, jnp.asarray(x),
                     {k: jnp.asarray(v) for k, v in st.items()})
    gp, gx, gs = vjp((jnp.asarray(dy), {k: jnp.asarray(v)
                                        for k, v in ds.items()}))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in st.items()}
    y, new = PS.apply_mamba(tp, tx, chunk=chunk, state=ts)
    loss = (y * torch.from_numpy(dy)).sum()
    for k, v in new.items():
        loss = loss + (v * torch.from_numpy(ds[k])).sum()
    loss.backward()
    errs = {k: _rel(tp[k].grad.numpy(), gp[k]) for k in tp}
    errs["x"] = _rel(tx.grad.numpy(), gx)
    errs.update({f"state.{k}": _rel(ts[k].grad.numpy(), gs[k]) for k in ts})
    assert max(errs.values()) <= 1e-4, errs
    assert len(errs) == len(tp) + 3
    assert np.linalg.norm(np.asarray(gp["a_log"])) > 0
