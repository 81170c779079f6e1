"""The port's model stack on the CPU against the JAX reference.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; inputs are made with numpy.  Tolerances:

- layers in float32: 1e-5 (the same arithmetic in another library);
- ``Model.prefill`` and decode steps in float32 compute: logits within
  1e-3, because the KV cache is bf16 in both and a one-ulp difference in
  a cached k or v moves the logits by up to ~1e-4; greedy tokens agree
  wherever the reference's top-2 gap exceeds that tolerance;
- in bf16 compute: logits within 5e-2 (bf16 rounds at other places in
  the two libraries); tokens are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.models.convert import params_from_numpy


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_softcap():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32) * 3
    w = rng.standard_normal(32, dtype=np.float32) * 0.1
    np.testing.assert_allclose(
        _np(pt_layers.rms_norm(_t(x), _t(w), 1e-6)),
        _np(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-5, atol=1e-5)
    for cap in (0.0, 5.0):
        np.testing.assert_allclose(
            _np(pt_layers.softcap(_t(x), cap)),
            _np(jax_layers.softcap(jnp.asarray(x), cap)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction,theta", [(1.0, 10_000.0),
                                            (1.0, 500_000.0),
                                            (0.5, 10_000.0)])
def test_apply_rope(fraction, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.asarray([[0, 1, 2, 3, 100, 5000, 131071]] * 2)
    got = pt_layers.apply_rope(_t(x), _t(pos), fraction, theta)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction,
                                 theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    rot, inv = pt_layers.rope_freqs(16, fraction, theta)
    rot_j, inv_j = jax_layers.rope_freqs(16, fraction, theta)
    assert rot == rot_j and np.array_equal(_np(inv), _np(inv_j))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16), dtype=np.float32)
    p = {n: rng.standard_normal(s, dtype=np.float32) * 0.2 for n, s in
         (("wi_gate", (16, 24)), ("wi_up", (16, 24)), ("wo", (24, 16)))}
    got = pt_layers.apply_mlp({n: _t(a) for n, a in p.items()}, _t(x), act)
    want = jax_layers.apply_mlp({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tied,cap", [(False, 0.0), (True, 30.0)])
def test_unembed_masks_padded_vocab(tied, cap):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 16), dtype=np.float32)
    p = {"embedding": rng.standard_normal((256, 16), dtype=np.float32)}
    if not tied:
        p["lm_head"] = rng.standard_normal((16, 256), dtype=np.float32)
    got = pt_layers.unembed({n: _t(a) for n, a in p.items()}, _t(x), cap,
                            200)
    want = jax_layers.unembed({n: jnp.asarray(a) for n, a in p.items()},
                              jnp.asarray(x), cap, 200)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    assert (_np(got)[..., 200:] < -1e8).all()


def test_cross_entropy():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 40), dtype=np.float32) * 4
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    got = pt_layers.cross_entropy(_t(logits), _t(labels))
    want = jax_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# attention with a cache: prefill, then decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("window,cap,bias", [(0, 0.0, False), (6, 20.0, True)])
def test_attention_prefill_then_decode(impl, window, cap, bias):
    rng = np.random.default_rng(4)
    D, H, KV, hd, B, S, L = 32, 4, 2, 8, 2, 10, 14
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                      ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    if bias:
        for n, w in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[n] = (rng.standard_normal(w) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, S + 2, D), dtype=np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, window=window,
              attn_cap=cap, rope_theta=500_000.0, chunk=4)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    jc = jax_attn.init_kv_cache(B, KV, L, hd, "bfloat16", 1)
    jc = {"k": jc["k"][0], "v": jc["v"][0]}
    tc = pt_attn.init_kv_cache(B, KV, L, hd, "bfloat16", 1)
    tc = {"k": tc["k"][0], "v": tc["v"][0]}
    # prefill S positions, then two single-token decode steps
    for start, n in ((0, S), (S, 1), (S + 1, 1)):
        pos = np.arange(start, start + n)
        yj, jc = jax_attn.attention(
            jp, jnp.asarray(x[:, start:start + n]), positions=jnp.asarray(pos),
            impl="chunked" if impl == "pallas" else impl, layer_cache=jc,
            cache_index=jnp.asarray(start, jnp.int32), **kw)
        yt, tc2 = pt_attn.attention(
            tp, _t(x[:, start:start + n]), positions=_t(pos), impl=impl,
            layer_cache=tc, cache_index=start, **kw)
        assert tc2 is tc                    # updated in place
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(_np(tc["k"]), _np(jc["k"]))
        np.testing.assert_array_equal(_np(tc["v"]), _np(jc["v"]))


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_attention_without_cache(impl):
    rng = np.random.default_rng(7)
    D, H, KV, hd, B, S = 32, 4, 1, 16, 2, 9
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                      ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, window=4, chunk=4,
              rotary_fraction=0.5)
    yj, cj = jax_attn.attention({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), positions=jnp.arange(S),
                                impl="chunked" if impl == "pallas" else impl,
                                **kw)
    yt, ct = pt_attn.attention({n: _t(a) for n, a in p.items()}, _t(x),
                               positions=torch.arange(S), impl=impl, **kw)
    assert cj is None and ct is None
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_attention_off_the_cpu_always_reaches_the_kernel(impl, monkeypatch):
    """Off the CPU every ``impl`` goes to the kernel's op, never to a
    plain version: on a meta tensor (the op gives a meta result there,
    for the dry run's trace) the plain versions are made to raise and the
    op is reached once."""
    D, H, KV, hd, B, S = 32, 4, 1, 16, 2, 9
    p = {n: torch.zeros(s, device="meta")
         for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                      ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    calls, op = [], pt_attn.fa_ops.flash_attention

    def spy(q, *a, **kw):
        calls.append(q.device)
        return op(q, *a, **kw)

    def plain(*a, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(pt_attn.fa_ops, "flash_attention", spy)
    for name in ("ref", "chunked"):
        monkeypatch.setitem(pt_attn._IMPLS, name, plain)
    y, _ = pt_attn.attention(p, torch.zeros(B, S, D, device="meta"),
                             positions=torch.arange(S, device="meta"),
                             impl=impl, n_heads=H, n_kv_heads=KV,
                             head_dim=hd)
    assert calls == [torch.device("meta")]
    assert y.device.type == "meta" and tuple(y.shape) == (B, S, D)


# ---------------------------------------------------------------------------
# Model.prefill + decode steps on the dense archs' smoke configs
# ---------------------------------------------------------------------------

ARCHS = ["llama3_8b", "gemma2_9b", "glm4_9b", "qwen15_32b"]


def _pair(arch, dtype, impl):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype,
                               attn_chunk=8)
    pcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                               attn_chunk=8, attn_impl=impl)
    jm = jax_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    pm = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg,
                           device="cpu")
    return jm, params, pm, pcfg


def _run_both(arch, dtype, impl, B=2, S=12, steps=4):
    jm, params, pm, cfg = _pair(arch, dtype, impl)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, S + steps)
    tc = pm.init_cache(B, S + steps)
    lj, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompt), jc)
    with torch.inference_mode():
        lt, tc = pm.prefill(_t(prompt), tc)
    pairs = [(_np(lt), _np(lj))]
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        # teacher-forced with the reference's greedy token, so one near-tie
        # cannot send the two runs down different continuations
        nxt = np.asarray(jnp.argmax(lj, axis=-1), np.int32)[:, None]
        lj, jc = decode(params, jnp.asarray(nxt), jc)
        with torch.inference_mode():
            lt, tc = pm.decode_step(_t(nxt), tc)
        pairs.append((_np(lt), _np(lj)))
    return pairs


@pytest.mark.parametrize("impl", ["chunked", "pallas", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_f32_matches_jax(arch, impl):
    tol = 1e-3
    for got, want in _run_both(arch, "float32", impl):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bf16_matches_jax(arch):
    for got, want in _run_both(arch, "bfloat16", "chunked"):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_weights_held_in_compute_dtype():
    _, params, pm, _ = _pair("qwen15_32b", "bfloat16", "chunked")
    layer = pm.units[0]["layer0"]
    assert layer.attn["wq"].dtype == torch.bfloat16
    # unit leaves are stacked in the reference, so its cast reaches them
    assert layer.attn["bq"].dtype == layer.ln1.dtype == torch.bfloat16
    assert pm.final_norm.dtype == torch.float32
    assert pm.embed["embedding"].dtype == torch.bfloat16
    want = np.asarray(params["units"]["layer0"]["attn"]["wq"][1])
    np.testing.assert_array_equal(
        _np(pm.units[1]["layer0"].attn["wq"]),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))
    assert not any(p.requires_grad for p in pm.parameters())


def test_random_init_is_seeded_and_scaled():
    cfg = get_config("llama3-8b", smoke=True)
    a, b = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    c = build_model(cfg, device="cpu", seed=1)
    wa = a.units[0]["layer0"].mlp["wo"].float()
    assert torch.equal(wa, b.units[0]["layer0"].mlp["wo"].float())
    assert not torch.equal(wa, c.units[0]["layer0"].mlp["wo"].float())
    assert abs(float(wa.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params + \
        (2 * cfg.n_layers + 1) * cfg.d_model


def test_params_from_numpy_refuses_mismatch():
    _, params, _, cfg = _pair("llama3_8b", "float32", "chunked")
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(bad, cfg, device="cpu")
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(short, cfg, device="cpu")


# ---------------------------------------------------------------------------
# a KV dtype the port does not know
# ---------------------------------------------------------------------------

def test_unknown_kv_dtype_raises():
    """A KV dtype neither bf16 nor int8 is no config at all
    (``ValueError``), for the model and for the cache alike."""
    cfg = get_config("llama3-8b", smoke=True)
    fp8 = dataclasses.replace(cfg, kv_dtype="fp8")
    with pytest.raises(ValueError, match="fp8"):
        Model(fp8, device="cpu")
    with pytest.raises(ValueError, match="fp8"):
        pt_attn.init_kv_cache(1, 1, 4, 8, "fp8", 1)
