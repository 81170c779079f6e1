"""The port's int8 KV cache on the CPU against the JAX reference.

``_quant``, ``_dequant``, ``cache_update``, ``_sdpa_chunked_quant``,
``init_kv_cache``/``Model.init_cache`` and whole serves with
``kv_dtype="int8"``.  Inputs are made with numpy from a seed; model
weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``.  Tolerances:

- ``_quant``: bit for bit (the int8 values and the float32 scales)
  against the reference's un-jitted ``_quant``, on every bf16 magnitude
  from 0x3a80 to 0x4480 of either sign and on random keys in bf16 and
  f32.  Under bf16, ``max|x| / scale`` is 127.5 for 420 of those
  magnitudes; it rounds to 128, which XLA's convert saturates to 127 and
  an unclamped ``.to(torch.int8)`` wraps to -128 (the negative control
  shows the wrap);
- ``_dequant`` and ``cache_update``: bit for bit;
- ``_sdpa_chunked_quant`` in float32: within 1e-5 of the reference (the
  same f32 arithmetic in another library, sums in another order); in
  bf16 within ``SDPA_BF16_TOL``: the output is f32 rounded once to bf16,
  so a last-bit difference before the rounding may move it by one bf16
  ulp (2**-7 relative), against the jitted reference;
- a serve (prefill, then four teacher-forced decode steps) with an int8
  cache: float32 logits within 1e-3 and bf16 within 5e-2, as the bf16
  cache's parity states them (``tests/test_torch_models.py``); jamba's
  bf16 within 0.2, as ``tests/test_torch_hybrid_models.py`` states and
  measures its limit: the jitted reference fuses bf16 chains that the
  port (and the reference's op-by-op run) round step by step
  (ROADMAP Queue 3).  A last-bit difference in a key before ``_quant``
  can move a rounding of ``x / scale`` across .5, so one int8 value
  differs by one step (``max|x| / 127``); the limits hold that too;
- int8 against bf16 logits of the same weights: correlation above 0.99,
  the reference's own criterion (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as pt_attn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.optim import adamw
from test_torch_moe_models import GAP_EPS, _check_flips, routing  # noqa: F401

ARCHS = ["llama3_8b", "qwen15_32b", "gemma2_9b", "jamba_v01_52b",
         "seamless_m4t_medium"]
SERVE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
JAMBA_BF16_TOL = 0.2
SDPA_F32_TOL = 1e-5
SDPA_BF16_TOL = 1e-2
# the bf16 magnitudes that hold the 127.5 rows (0.0009765625 to 1024)
MAG_BITS = np.arange(0x3A80, 0x4481, dtype=np.uint32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_rows(sign: float, hd: int = 8, seed: int = 0) -> np.ndarray:
    """One row a bf16 magnitude of ``MAG_BITS``: that magnitude with
    ``sign`` at column 3, the others uniform within 0.9 of it (f32 values
    that round to bf16 on the way in)."""
    mag = (MAG_BITS << 16).view(np.float32)
    rng = np.random.default_rng(seed)
    rows = (rng.uniform(-0.9, 0.9, (len(mag), hd)) * mag[:, None]
            ).astype(np.float32)
    rows[:, 3] = sign * mag
    return rows


def _both(rows: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor in ``dtype``."""
    xj = jnp.asarray(rows).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(rows).to(getattr(torch, dtype))
    assert np.array_equal(_np(xj), _np(xt))
    return xj, xt


def _ref_quant(xj):
    with jax.disable_jit():
        q, s = jax_attn._quant(xj)
    return np.asarray(q), np.asarray(s)


# ---------------------------------------------------------------------------
# _quant / _dequant / cache_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_quant_every_bf16_magnitude_bit_for_bit(sign):
    xj, xt = _both(_bf16_rows(sign), "bfloat16")
    qj, sj = _ref_quant(xj)
    qt, st = pt_attn._quant(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    # the rows whose largest element lands on 127.5: it saturates
    ratio = (xt[:, 3].abs() / (xt.abs().amax(-1) / 127.0)).float()
    half = (ratio == 127.5).numpy()
    assert half.sum() == 420
    assert (qt.numpy()[half, 3] == (127 if sign > 0 else -128)).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 3, 17, 16), (1, 4, 5, 128)])
def test_quant_random_keys_bit_for_bit(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[
        ..., None]).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero row: the 1e-8 floor
    xj, xt = _both(x, dtype)
    qj, sj = _ref_quant(xj)
    qt, st = pt_attn._quant(xt)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)


def test_unclamped_cast_differs_from_the_reference():
    """The negative control: ``torch.round(...).to(torch.int8)`` without
    the clamp wraps the positive 127.5 rows' 128 to -128."""
    xj, xt = _both(_bf16_rows(1.0), "bfloat16")
    qj, _ = _ref_quant(xj)
    scale = torch.maximum(xt.abs().amax(-1) / 127.0,
                          torch.tensor(1e-8, dtype=torch.bfloat16))
    wrapped = torch.round(xt / scale[..., None]).to(torch.int8).numpy()
    differ = (wrapped != qj).any(-1)
    assert differ.sum() == 420
    assert (wrapped[differ, 3] == -128).all() and (qj[differ, 3] == 127).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequant_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    q = rng.integers(-128, 128, (2, 3, 7, 16)).astype(np.int8)
    s = rng.uniform(1e-4, 0.3, (2, 3, 7)).astype(np.float32)
    want = jax_attn._dequant(jnp.asarray(q), jnp.asarray(s),
                             jnp.dtype(dtype))
    got = pt_attn._dequant(torch.from_numpy(q), torch.from_numpy(s),
                           getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("index,S", [(0, 6), (5, 3), (9, 1)])
def test_cache_update_in_place_bit_for_bit(dtype, index, S):
    B, KV, L, hd = 2, 3, 10, 16
    jc = jax_attn.init_kv_cache(B, KV, L, hd, "int8", 1)
    jc = {k: v[0] for k, v in jc.items() if k != "index"}
    tc = pt_attn.init_kv_cache(B, KV, L, hd, "int8", 1)
    tc = {k: v[0] for k, v in tc.items() if k != "index"}
    rng = np.random.default_rng(index)
    for start, n in ((0, index), (index, S)):
        if n == 0:
            continue
        k = (rng.standard_normal((B, KV, n, hd)) * 3).astype(np.float32)
        v = rng.standard_normal((B, KV, n, hd)).astype(np.float32)
        (kj, kt), (vj, vt) = _both(k, dtype), _both(v, dtype)
        jc = jax_attn.cache_update(jc, kj, vj, jnp.asarray(start, jnp.int32))
        views = {name: t for name, t in tc.items()}
        assert pt_attn.cache_update(tc, kt, vt, start) is tc
        for name, t in tc.items():
            assert t is views[name]                # written in place
            np.testing.assert_array_equal(_np(t), _np(jc[name]))
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == \
        torch.float32
    # the reference's cache_kv dequantizes the whole cache
    for got, want in zip(pt_attn.cache_kv(tc, getattr(torch, dtype)),
                         jax_attn.cache_kv(jc, jnp.dtype(dtype))):
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# _sdpa_chunked_quant
# ---------------------------------------------------------------------------

def _quant_inputs(B, KV, G, Sq, Sk, hd, dtype, seed):
    """q ``[B,KV,G,Sq,hd]`` at positions ``Sk - Sq .. Sk - 1`` (a prefill
    or decode at the end of the keys) and an int8 cache made by the
    reference's ``_quant`` from random keys and values."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, Sq, hd)).astype(np.float32) * 2
    k = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32) * 2
    v = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    with jax.disable_jit():
        k8, ks = jax_attn._quant(jnp.asarray(k))
        v8, vs = jax_attn._quant(jnp.asarray(v))
    qj = jnp.asarray(q).astype(jnp.dtype(dtype))
    qt = torch.from_numpy(q).to(getattr(torch, dtype))
    cache = [np.array(a) for a in (k8, ks, v8, vs)]
    q_pos = np.arange(Sk - Sq, Sk)
    return qj, qt, cache, q_pos, np.arange(Sk)


SDPA_CASES = {
    # B, KV, G, Sq, Sk, hd, causal, window, cap, chunk, q_block
    "mha_prefill": (2, 2, 1, 11, 11, 16, True, 0, 0.0, 4, 4),
    "gqa_prefill_window": (1, 2, 3, 9, 14, 16, True, 5, 0.0, 6, 2),
    "gqa_softcap": (2, 1, 4, 7, 13, 32, True, 0, 20.0, 5, 3),
    "decode": (3, 2, 2, 1, 19, 16, True, 0, 0.0, 8, 4),
    "decode_window_softcap": (2, 2, 2, 1, 21, 16, True, 6, 30.0, 16, 1),
    "noncausal": (1, 2, 2, 6, 10, 8, False, 0, 0.0, 3, 4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_chunked_quant_matches_reference(case, dtype):
    B, KV, G, Sq, Sk, hd, causal, window, cap, chunk, q_block = \
        SDPA_CASES[case]
    assert q_block < Sq or Sq == 1       # the row loop runs
    assert chunk < Sk and Sk % chunk     # several chunks, the last padded
    qj, qt, cache, q_pos, k_pos = _quant_inputs(B, KV, G, Sq, Sk, hd, dtype,
                                                len(case))
    kw = dict(causal=causal, window=window, attn_cap=cap,
              scale=1.0 / np.sqrt(hd), chunk=chunk)
    want = jax.jit(lambda *a: jax_attn._sdpa_chunked_quant(*a, **kw))(
        qj, *(jnp.asarray(a) for a in cache), jnp.asarray(q_pos),
        jnp.asarray(k_pos))
    got = pt_attn._sdpa_chunked_quant(
        qt, *(torch.from_numpy(a) for a in cache), torch.from_numpy(q_pos),
        torch.from_numpy(k_pos), q_block=q_block, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = SDPA_F32_TOL if dtype == "float32" else SDPA_BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_query_blocks_change_no_value():
    """Each row's softmax is independent: any block size gives the
    unblocked result."""
    qj, qt, cache, q_pos, k_pos = _quant_inputs(2, 2, 2, 13, 13, 16,
                                                "float32", 7)
    args = [torch.from_numpy(a) for a in cache]
    kw = dict(causal=True, window=0, attn_cap=0.0, scale=0.25, chunk=5)
    whole = pt_attn._sdpa_chunked_quant(qt, *args, torch.from_numpy(q_pos),
                                        torch.from_numpy(k_pos), q_block=13,
                                        **kw)
    for q_block in (1, 4, 6):
        got = pt_attn._sdpa_chunked_quant(
            qt, *args, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
            q_block=q_block, **kw)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the cache of a whole model, and serves against the reference
# ---------------------------------------------------------------------------

def _configs(arch, dtype="float32"):
    over = dict(dtype=dtype, attn_chunk=8, kv_dtype="int8")
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jcfg, cfg = _configs(arch)
    B, L = 2, 24
    want = jax.eval_shape(lambda: jax_build(jcfg).init_cache(B, L))
    got = Model(cfg, device="cpu", init=False).init_cache(B, L)
    assert got["index"] == 0 and set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    n_int8 = 0
    for name, entry in want["layers"].items():
        assert set(got["layers"][name]) == set(entry), name
        for key, spec in entry.items():
            t = got["layers"][name][key]
            assert tuple(t.shape) == spec.shape, (name, key)
            assert str(t.dtype).split(".")[1] == str(spec.dtype), (name, key)
            assert not t.any()
            n_int8 += t.dtype == torch.int8
    assert n_int8 == 2 * sum(s.kind == "attn" for s in cfg.unit)
    for key in ("cross_k", "cross_v"):
        if key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert got[key].dtype == torch.float32  # cfg.dtype, not int8


def _frames(cfg, B, seed=6):
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def _serve_pairs(arch, dtype, B=2, S=12, steps=4):
    """Prefill and ``steps`` decode steps with an int8 cache, the port
    against the jitted reference, teacher-forced with the reference's
    greedy tokens; returns ``[(port logits, reference logits)]`` and the
    two caches."""
    jcfg, cfg = _configs(arch, dtype)
    jm = jax_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    pm = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg,
                           device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    fe = _frames(cfg, B)
    L = S + steps + cfg.frontend_len
    extra = () if fe is None else (jnp.asarray(fe),)
    lj, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompt),
                                 jm.init_cache(B, L), *extra)
    with torch.inference_mode():
        lt, tc = pm.prefill(torch.from_numpy(prompt), pm.init_cache(B, L),
                            None if fe is None else torch.from_numpy(fe))
    pairs = [(_np(lt), _np(lj))]
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(lj, axis=-1), np.int32)[:, None]
        lj, jc = decode(params, jnp.asarray(nxt), jc)
        with torch.inference_mode():
            lt, tc = pm.decode_step(torch.from_numpy(nxt.copy()), tc)
        pairs.append((_np(lt), _np(lj)))
    return pairs, tc, jc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_serve_matches_reference(arch, dtype, routing):
    pairs, tc, jc = _serve_pairs(arch, dtype)
    tol = SERVE_TOL[dtype]
    if arch == "jamba_v01_52b":
        _check_flips(routing, GAP_EPS[dtype])
        if dtype == "bfloat16":
            tol = JAMBA_BF16_TOL
    for got, want in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the int8 cache after the steps.  float32: the scales within 1e-5,
    # every value within one step.  bf16: the keys themselves differ by a
    # few bf16 roundings (each moves the scale by 2**-8 of it), so the
    # dequantized values agree within the logits' limit of their row's
    # largest magnitude (readings: up to 5 steps of 127, 3.9%)
    for name, entry in tc["layers"].items():
        if "k_scale" not in entry:
            continue
        for key in ("k", "v"):
            q, s = entry[key], entry[f"{key}_scale"]
            qj = np.asarray(jc["layers"][name][key])
            sj = np.asarray(jc["layers"][name][f"{key}_scale"])
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            if dtype == "float32":
                np.testing.assert_allclose(s.numpy(), sj, rtol=1e-5)
                assert np.abs(q.numpy().astype(int) - qj).max() <= 1
            else:
                got = q.numpy() * s.numpy()[..., None]
                want = qj * sj[..., None]
                step = np.maximum(127 * sj[..., None], 1e-30)
                err = (np.abs(got - want) / step).max()
                assert err <= tol, (name, key, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_close_to_bf16(dtype):
    """``tests/test_models.py::test_int8_kv_cache_close_to_bf16`` for the
    port: the prefill logits of one model with each cache."""
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True),
                              dtype=dtype)
    m16 = Model(dataclasses.replace(cfg, kv_dtype="bfloat16"), device="cpu",
                seed=1)
    m8 = Model(dataclasses.replace(cfg, kv_dtype="int8"), device="cpu",
               seed=1)
    B, S = 2, 12
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    with torch.inference_mode():
        l16, _ = m16.prefill(tok, m16.init_cache(B, S))
        l8, _ = m8.prefill(tok, m8.init_cache(B, S))
    corr = np.corrcoef(_np(l16).ravel(), _np(l8).ravel())[0, 1]
    assert corr > 0.99
    assert not np.array_equal(_np(l16), _np(l8))     # int8 really ran


def test_int8_layers_never_reach_the_flash_op(monkeypatch):
    """With ``attn_impl="pallas"`` (the kernel's path) an int8 cache still
    attends through ``_sdpa_chunked_quant``: no flash call, no whole-cache
    dequantization; the bf16 cache of the same model does call it."""
    calls = {"flash": 0, "quant": 0, "cache_kv": 0}
    flash, quant, cache_kv = (fa_ops.flash_attention,
                              pt_attn._sdpa_chunked_quant, pt_attn.cache_kv)

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa_ops, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(pt_attn, "_sdpa_chunked_quant",
                        counted("quant", quant))
    monkeypatch.setattr(pt_attn, "cache_kv", counted("cache_kv", cache_kv))
    base = dataclasses.replace(get_config("qwen15_32b", smoke=True),
                               attn_impl="pallas")
    for kv_dtype in ("int8", "bfloat16"):
        m = Model(dataclasses.replace(base, kv_dtype=kv_dtype), device="cpu")
        tok = torch.zeros(2, 5, dtype=torch.int64)
        with torch.inference_mode():
            _, cache = m.prefill(tok, m.init_cache(2, 7))
            m.decode_step(tok[:, :1], cache)
        if kv_dtype == "int8":
            assert calls == {"flash": 0, "quant": 2 * base.n_layers,
                             "cache_kv": 0}
    assert calls["flash"] == calls["cache_kv"] == 2 * base.n_layers


def test_train_model_takes_an_int8_config():
    """Training holds no cache: the int8 config builds and takes one
    AdamW step (``launch.steps.make_train_step``) as the bf16 one does,
    to the same loss and the same masters."""
    cfg = get_config("qwen15_32b", smoke=True)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)) for k in
             ("tokens", "labels")}
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    runs = []
    for kv_dtype in ("int8", "bfloat16"):
        m = TrainModel(dataclasses.replace(cfg, kv_dtype=kv_dtype),
                       device="cpu", seed=0)
        params = m.param_dict()
        before = {k: p.detach().clone() for k, p in params.items()}
        step = make_train_step(m, opt_cfg)
        params, _, info = step(params, adamw.init_state(opt_cfg, params),
                               batch)
        assert np.isfinite(float(info["loss"]))
        assert sum(not torch.equal(before[k], p)
                   for k, p in params.items()) == len(params)
        runs.append((float(info["loss"]), params))
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k
