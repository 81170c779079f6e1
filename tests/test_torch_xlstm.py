"""The port's xLSTM blocks (``repro_torch.models.xlstm``) on the CPU against
the reference's ``repro.models.xlstm``.

Weights come from the reference's ``init_mlstm``/``init_slstm`` with the
1-D leaves (gate biases, ``out_norm``) moved off their constants, inputs
and states from numpy, carried across as numpy arrays.  Tolerances:

- float32: outputs within 1e-5 of the reference output's largest
  magnitude (``_F32``), states within 1e-5 of theirs: the products, the
  forget-gate cumsum and the chunk's three-operand einsum sum in another
  order (the readings are 1e-7 to 1.4e-6, a few ulps);
- bfloat16: outputs within 1e-2 of the largest magnitude (``_BF16``),
  about one bf16 ulp: both blocks compute in float32 from the bf16
  products and round once at the end (``silu`` and the gates in jax.nn's
  formulas); the readings are 0 to 2.4e-7; states (float32 in both)
  within 1e-5;
- the port's chunkwise form against its sequential form: 1e-5 (the same
  maths in another order);
- gradients (``jax.vjp``) of ``sum(y * dy)`` and the state cotangents:
  every leaf, ``x`` and the initial state within 1e-4 in relative norm
  (the backward sums over the sequence in another order); in the
  one-token decode from a state whose ``m`` is about -30, 1e-2: there the
  floor ``exp(-m)`` binds in 7 of the 8 heads and the gradients of
  ``wq``, ``wk``, ``w_i`` and ``b_i`` are sums of terms that cancel to
  ~1e-3 of their size, so a float32 evaluation of either library lies
  1.1e-3 to 4.5e-3 (relative norm) from a float64 one of the same
  function; the other leaves agree to 5e-7 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro.models.layers import KeyGen as JaxKeyGen
from repro_torch.models import xlstm as PX
from repro_torch.models.layers import KeyGen

_F32, _BF16, _STATE, _GRAD = 1e-5, 1e-2, 1e-5, 1e-4
D, H = 32, 4                       # d_in 64, heads of 16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(kind, dtype="float32", seed=0):
    """The reference's weights in ``dtype`` (its 1-D leaves float32,
    nudged) as (jax tree, port dict)."""
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    p = init(JaxKeyGen(jax.random.PRNGKey(seed)), D, H, JDT[dtype])
    rng = np.random.default_rng(seed + 1)
    p = {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
         if v.ndim == 1 else v for k, v in p.items()}
    tp = {k: torch.from_numpy(_np(v).copy()).to(
        TDT[dtype] if v.dtype == JDT[dtype] else torch.float32)
        for k, v in p.items()}
    return p, tp


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _state(kind, seed=3):
    """A non-zero state for 2 sequences (sLSTM's ``n`` kept above 1, as
    from its init it always is)."""
    ref = (JX.init_mlstm_state(2, D, H) if kind == "mlstm"
           else JX.init_slstm_state(2, D))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in ref.items():
        a = np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
        if kind == "slstm" and k == "n":
            a = 1.0 + np.abs(a)
        out[k] = a.astype(np.float32)
    return out


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    limit = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"max abs err {err} > {limit}"


def _run(kind, p, tp, x, dtype, state, **kw):
    jfn = JX.apply_mlstm if kind == "mlstm" else JX.apply_slstm
    tfn = PX.apply_mlstm if kind == "mlstm" else PX.apply_slstm
    if kind == "mlstm":
        kw.setdefault("n_heads", H)
    js = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    ts = None if state is None else {k: torch.from_numpy(v.copy())
                                     for k, v in state.items()}
    yj, sj = jfn(p, jnp.asarray(x, JDT[dtype]), state=js, **kw)
    yt, st = tfn(tp, torch.from_numpy(x).to(TDT[dtype]), state=ts, **kw)
    return (yj, sj), (yt, st)


def _check(ref, got, dtype):
    (yj, sj), (yt, st) = ref, got
    assert yt.dtype == TDT[dtype]
    _close(yt, yj, _F32 if dtype == "float32" else _BF16)
    if sj is None:
        assert st is None
        return
    assert sorted(st) == sorted(sj)
    for k in sj:
        assert st[k].dtype == torch.float32
        _close(st[k], sj[k], _STATE)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

MLSTM_CASES = [  # (S, chunk, from a given state)
    (16, 8, False),      # a multiple of the chunk: two chunks
    (16, 8, True),
    (5, 8, True),        # shorter than the chunk: one chunk of 5
    (12, 8, True),       # not a multiple: the sequential fallback
    (1, 8, True),        # decode from a non-zero state
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,given", MLSTM_CASES)
def test_apply_mlstm_matches_reference(S, chunk, given, dtype):
    p, tp = _params("mlstm", dtype)
    x = _x((2, S, D))
    state = _state("mlstm") if given else None
    _check(*_run("mlstm", p, tp, x, dtype, state, chunk=chunk), dtype)


@pytest.mark.parametrize("S,chunk,form", [(16, 8, "chunkwise"),
                                          (5, 8, "chunkwise"),
                                          (12, 8, "sequential"),
                                          (1, 8, "sequential"),
                                          (1, 1, "sequential")])
def test_mlstm_form(S, chunk, form):
    assert PX.mlstm_form(S, chunk) == form


def test_chunkwise_equals_sequential():
    """The port's two forms on the same gates and state (24 steps, chunks
    of 8 against the step recurrence)."""
    rng = np.random.default_rng(4)
    B, S, hd = 2, 24, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, hd))
                                .astype(np.float32)) for _ in range(3))
    log_i = torch.from_numpy(rng.standard_normal((B, H, S))
                             .astype(np.float32))
    log_f = torch.nn.functional.logsigmoid(torch.from_numpy(
        rng.standard_normal((B, H, S)).astype(np.float32) + 2.0))
    st = {k_: torch.from_numpy(a) for k_, a in _state("mlstm").items()}
    h1, s1 = PX._mlstm_chunkwise(q, k, v, log_i, log_f, st["C"], st["n"],
                                 st["m"], 8)
    h2, s2 = PX._mlstm_sequential(q, k, v, log_i, log_f, st["C"], st["n"],
                                  st["m"])
    _close(h1, h2, 1e-5)
    # the stabilizers differ by construction; the states they scale agree
    for (C1, n1, m1), (C2, n2, m2) in [(s1, s2)]:
        _close(C1 * torch.exp(m1)[..., None, None],
               C2 * torch.exp(m2)[..., None, None], 1e-5)
        _close(n1 * torch.exp(m1)[..., None], n2 * torch.exp(m2)[..., None],
               1e-5)


def test_mlstm_prompt_then_decode_equals_longer_prompt():
    """Prefill 12 tokens then decode 4 from the returned state against
    prefilling all 16, in the port alone (float32)."""
    _, tp = _params("mlstm")
    x = torch.from_numpy(_x((2, 16, D), seed=8))
    s0 = PX.init_mlstm_state(2, D, H)
    full, _ = PX.apply_mlstm(tp, x, n_heads=H, chunk=4, state=s0)
    y, st = PX.apply_mlstm(tp, x[:, :12], n_heads=H, chunk=4, state=s0)
    outs = [y]
    for t in range(12, 16):
        y, st = PX.apply_mlstm(tp, x[:, t:t + 1], n_heads=H, chunk=4,
                               state=st)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full, 1e-5)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,given", [(16, False), (16, True), (1, True),
                                     (7, True)])
def test_apply_slstm_matches_reference(S, given, dtype):
    p, tp = _params("slstm", dtype)
    x = _x((2, S, D), seed=2)
    state = _state("slstm") if given else None
    _check(*_run("slstm", p, tp, x, dtype, state), dtype)


def test_slstm_n_floor_binds_as_in_the_reference():
    """From a state whose ``n`` is 0 and ``m`` 30 (below any state the
    init reaches), the input gate is ~exp(-30) and the floor at 1e-6
    sets ``n``: both sides floor it."""
    p, tp = _params("slstm")
    st = _state("slstm")
    st["n"] = np.zeros_like(st["n"])
    st["m"] = np.full_like(st["m"], 30.0)
    ref, got = _run("slstm", p, tp, _x((2, 3, D), seed=5), "float32", st)
    _check(ref, got, "float32")
    assert float(got[1]["n"].min()) == np.float32(1e-6)


# ---------------------------------------------------------------------------
# init and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_shapes_and_key_order(kind, dtype):
    jinit = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    tinit = PX.init_mlstm if kind == "mlstm" else PX.init_slstm
    want = jinit(JaxKeyGen(jax.random.PRNGKey(0)), D, H, JDT[dtype])
    got = tinit(KeyGen(0), D, H, TDT[dtype])
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == str(v.dtype), k
        if v.ndim == 1:                         # the constants, exactly
            np.testing.assert_array_equal(_np(got[k]), _np(v))
    mats = [k for k, v in want.items() if v.ndim == 2]
    for k in mats:                              # scale 1 (r_*: 0.5)
        scale = 0.5 if k.startswith("r_") else 1.0
        std = float(got[k].float().std()) * np.sqrt(got[k].shape[0])
        assert abs(std - scale) < 0.25 * scale, (k, std)
    again = tinit(KeyGen(0), D, H, TDT[dtype])
    assert all(torch.equal(again[k], got[k]) for k in got)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind,S,chunk,tol", [("mlstm", 16, 8, _GRAD),
                                              ("mlstm", 12, 8, _GRAD),
                                              ("mlstm", 1, 8, 1e-2),
                                              ("slstm", 10, None, _GRAD)])
def test_gradients_match_jax_vjp(kind, S, chunk, tol):
    """Every gradient (each weight and bias, ``x``, the initial state) of
    ``sum(y * dy)`` plus the returned state against random cotangents."""
    p, tp = _params(kind)
    x = _x((2, S, D), seed=6)
    st = _state(kind)
    dy = _x(x.shape, seed=7)
    rng = np.random.default_rng(9)
    ds = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in st.items()}
    kw = dict(n_heads=H, chunk=chunk) if kind == "mlstm" else {}
    jfn = JX.apply_mlstm if kind == "mlstm" else JX.apply_slstm
    tfn = PX.apply_mlstm if kind == "mlstm" else PX.apply_slstm

    def ref(params, xx, state):
        return jfn(params, xx, state=state, **kw)

    _, vjp = jax.vjp(ref, p, jnp.asarray(x),
                     {k: jnp.asarray(v) for k, v in st.items()})
    gp, gx, gs = vjp((jnp.asarray(dy), {k: jnp.asarray(v)
                                        for k, v in ds.items()}))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in st.items()}
    y, new = tfn(tp, tx, state=ts, **kw)
    loss = (y * torch.from_numpy(dy)).sum()
    for k, v in new.items():
        loss = loss + (v * torch.from_numpy(ds[k])).sum()
    loss.backward()
    errs = {k: _rel(tp[k].grad.numpy(), gp[k]) for k in tp}
    errs["x"] = _rel(tx.grad.numpy(), gx)
    errs.update({f"state.{k}": _rel(ts[k].grad.numpy(), gs[k]) for k in ts})
    assert max(errs.values()) <= tol, errs
    assert len(errs) == len(tp) + 1 + len(ts)


@pytest.mark.parametrize("floor_binds", [False, True])
def test_slstm_scan_backward_is_its_derivative(floor_binds):
    """The sLSTM time loop's hand-written backward (``_SLSTMScan``) against
    finite differences in float64 (``torch.autograd.gradcheck``): every
    input and the final state's cotangents, from an ordinary state and
    from one the normalizer floor binds from."""
    rng = np.random.default_rng(11)
    S, B, d = 5, 2, 3

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(shift + scale * rng.standard_normal(shape)) \
            .requires_grad_()

    pre, R, bias = t(S, B, 4 * d), t(d, 4 * d, scale=0.5), t(4 * d)
    c, h = t(B, d, scale=0.3), t(B, d, scale=0.3)
    if floor_binds:           # n held at 0 (a step of it would straddle
        n = torch.zeros(B, d, dtype=torch.float64)       # the floor's kink)
        m = torch.full((B, d), 30.0, dtype=torch.float64, requires_grad=True)
    else:
        n, m = t(B, d, scale=0.2, shift=1.5), t(B, d, scale=0.3)
    assert torch.autograd.gradcheck(PX._SLSTMScan.apply,
                                    (pre, R, bias, c, n, m, h))
