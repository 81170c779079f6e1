"""The encoder-decoder and frontend archs, seamless-m4t-medium (a non-causal
encoder over frame embeddings, decoder layers with cross-attention) and
paligemma-3b (a vision prefix before the text, MQA at one kv head),
through the port's models on the CPU against the reference, at their
smoke configs.

Weights come from the reference's ``init_params`` (norms moved off zero
by seeded noise) and are carried across with ``params_from_numpy``;
tokens and frontend embeddings are numpy draws from a seed.  Tolerances:

- the attention layer's forms (cross-attention with Sq != Sk,
  non-causal self-attention, ``precompute_cross_kv``) and the encoder in
  float32: 1e-5 (the same arithmetic in another library);
- serving in float32: logits within 1e-3 (the decoder's KV cache is bf16
  in both, so a last-bit difference in a cached k or v moves a logit by
  up to ~1e-4; ``tests/test_torch_models.py``'s limit); in bfloat16:
  5e-2 (bf16 rounds at other places in the two libraries);
- the port's decode against the port's prefill: 1e-3 in float32, 6e-2 in
  bfloat16 (``tests/test_models.py``'s self-parity limit);
- ``train_loss`` and every gradient: float32 1e-5 (loss) and 1e-5
  (relative norm ``||g_port - g_ref|| / ||g_ref||``), bfloat16 5e-3 and
  5e-2 (``tests/test_torch_train_loss.py``'s limits);
- the serve against the reference launcher's flow in float32: the same
  admitted set and every greedy token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import PageAllocator as JaxPageAllocator
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as pt_attn
from repro_torch.models.convert import (load_params, named_to_numpy,
                                        opt_state_from_numpy,
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy,
                                        ref_key)
from repro_torch.models.transformer import Model, TrainModel, run_encoder

ARCHS = ["seamless_m4t_medium", "paligemma_3b"]
SERVE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
SELF_TOL = {"float32": 1e-3, "bfloat16": 6e-2}
TRAIN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-3, 5e-2)}
LAYER_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, **over):
    over.setdefault("attn_chunk", 8)
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _nudged(tree, cfg, seed):
    """Every 1-D leaf (stacked: ``[n_units, d]``) moved off its constant,
    so a missed cast or a norm the port makes itself shows."""
    rng = np.random.default_rng(seed + 1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == cfg.n_units):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(nudge, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, seed=0):
    """The reference model of a smoke config, its nudged tree (numpy) and
    its jitted prefill, decode step and loss-and-gradient, shared by the
    module's tests."""
    jcfg, cfg = _configs(arch, dtype=dtype)
    jm = jax_build(jcfg)
    tree = _nudged(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(seed))), cfg, seed)
    return dict(jm=jm, cfg=cfg, tree=tree,
                params=jax.tree_util.tree_map(jnp.asarray, tree),
                prefill=jax.jit(jm.prefill), decode=jax.jit(jm.decode_step),
                grad=jax.jit(jax.value_and_grad(jm.train_loss)))


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def _attn_params(rng, D, H, KV, hd):
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                         ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}


# ---------------------------------------------------------------------------
# the attention layer's forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("Sq,Sk,KV", [(7, 19, 2), (20, 9, 1), (1, 13, 4)])
def test_cross_attention_matches_reference(impl, Sq, Sk, KV):
    """``kv=`` with Sq != Sk (a prefill longer or shorter than the memory,
    a decode row): no RoPE on q, keys at ``arange(Sk)``, non-causal, no
    cache back; the reference's default chunk (1,024) on the CPU."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    D, H, hd, B = 32, 4, 8, 2
    p = _attn_params(rng, D, H, KV, hd)
    x = rng.standard_normal((B, Sq, D), dtype=np.float32)
    mem = rng.standard_normal((B, Sk, D), dtype=np.float32)
    pos = np.arange(Sq) + 5
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, causal=False,
              use_rope=False)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jkv = jax_attn.precompute_cross_kv(jp, jnp.asarray(mem), KV, hd)
    tkv = pt_attn.precompute_cross_kv(tp, torch.from_numpy(mem), KV, hd)
    yj, cj = jax_attn.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                impl="chunked" if impl == "pallas" else impl,
                                kv=jkv, **kw)
    yt, ct = pt_attn.attention(tp, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), impl=impl,
                               kv=tkv, **kw)
    assert cj is None and ct is None
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_noncausal_self_attention_matches_reference(impl):
    """The encoder's form: ``causal=False`` with RoPE, keys at this call's
    positions, 3 chunks of 8 (the last ragged) on the chunked path."""
    rng = np.random.default_rng(11)
    D, H, KV, hd, B, S = 32, 4, 2, 8, 2, 21
    p = _attn_params(rng, D, H, KV, hd)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, causal=False, chunk=8)
    yj, _ = jax_attn.attention({n: jnp.asarray(a) for n, a in p.items()},
                               jnp.asarray(x), positions=jnp.arange(S),
                               impl="chunked" if impl == "pallas" else impl,
                               **kw)
    yt, _ = pt_attn.attention({n: torch.from_numpy(a) for n, a in p.items()},
                              torch.from_numpy(x), positions=torch.arange(S),
                              impl=impl, **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    causal, _ = pt_attn.attention(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
        positions=torch.arange(S), impl=impl, **dict(kw, causal=True))
    assert float((causal - yt).abs().max()) > 1e-2   # the flag is read


def test_precompute_cross_kv_matches_reference():
    rng = np.random.default_rng(12)
    D, H, KV, hd, B, S = 32, 4, 2, 8, 3, 11
    p = _attn_params(rng, D, H, KV, hd)
    mem = rng.standard_normal((B, S, D), dtype=np.float32)
    want = jax_attn.precompute_cross_kv(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(mem), KV, hd)
    got = pt_attn.precompute_cross_kv(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(mem),
        KV, hd)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, KV, S, hd)
        np.testing.assert_allclose(_np(g), _np(w), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)


def test_encoder_matches_reference():
    """The encoder stack (2 layers, non-causal, RoPE over the frames, then
    ``enc_norm``) against ``Model._run_encoder`` on the projected
    frames."""
    ref = _reference("seamless_m4t_medium", "float32")
    cfg, jm, params = ref["cfg"], ref["jm"], ref["params"]
    pm = params_from_numpy(ref["tree"], cfg, device="cpu")
    mem = np.random.default_rng(3).standard_normal(
        (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    want = jax.jit(jm._run_encoder)(params, jnp.asarray(mem))
    with torch.inference_mode():
        got = run_encoder(cfg, pm.encoder, pm.enc_norm, torch.from_numpy(mem))
    np.testing.assert_allclose(_np(got), _np(want), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


# ---------------------------------------------------------------------------
# serving: prefill then decode, against the reference
# ---------------------------------------------------------------------------

def _serve_pairs(arch, dtype, impl, B=2, S=12, steps=4):
    ref = _reference(arch, dtype)
    cfg = dataclasses.replace(ref["cfg"], attn_impl=impl)
    pm = params_from_numpy(ref["tree"], cfg, device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    fe = _frames(cfg, B, 6)
    L = S + steps + cfg.frontend_len
    lj, jc = ref["prefill"](ref["params"], jnp.asarray(prompt),
                            ref["jm"].init_cache(B, L), jnp.asarray(fe))
    with torch.inference_mode():
        lt, tc = pm.prefill(torch.from_numpy(prompt), pm.init_cache(B, L),
                            torch.from_numpy(fe))
    assert tc["index"] == int(jc["index"])       # the prefix counted
    pairs = [(_np(lt), _np(lj))]
    for _ in range(steps):
        # teacher-forced with the reference's greedy token
        nxt = np.asarray(jnp.argmax(lj, axis=-1), np.int32)[:, None]
        lj, jc = ref["decode"](ref["params"], jnp.asarray(nxt), jc)
        with torch.inference_mode():
            lt, tc = pm.decode_step(torch.from_numpy(nxt.copy()), tc)
        pairs.append((_np(lt), _np(lj)))
    if cfg.enc_dec:       # the cross K/V the prefill wrote, in cfg.dtype
        for key in ("cross_k", "cross_v"):
            assert tc[key].dtype == pm.dtype
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                       rtol=SERVE_TOL[dtype],
                                       atol=SERVE_TOL[dtype])
    return pairs


@pytest.mark.parametrize("impl", ["chunked", "pallas", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_f32_matches_reference(arch, impl):
    tol = SERVE_TOL["float32"]
    for got, want in _serve_pairs(arch, "float32", impl):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_bf16_matches_reference(arch):
    tol = SERVE_TOL["bfloat16"]
    for got, want in _serve_pairs(arch, "bfloat16", "chunked"):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_self_parity(arch, dtype):
    """The port's prefill over ``S + i`` tokens against a prefill of ``S``
    then ``i`` decode steps, the same frames throughout."""
    _, cfg = _configs(arch, dtype=dtype)
    m = Model(cfg, device="cpu", seed=1)
    B, S, extra = 2, 12, 4
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + extra)))
    fe = torch.from_numpy(_frames(cfg, B, 2))
    L = S + extra + cfg.frontend_len
    tol = SELF_TOL[dtype]
    with torch.inference_mode():
        last, cache = m.prefill(tok[:, :S], m.init_cache(B, L), fe)
        for i in range(extra):
            ref, _ = m.prefill(tok[:, :S + i], m.init_cache(B, L), fe)
            np.testing.assert_allclose(_np(last), _np(ref), rtol=tol,
                                       atol=tol)
            last, cache = m.decode_step(tok[:, S + i:S + i + 1], cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    """The decoder's bf16 KV pair stacked over the units and, for an
    encoder-decoder, ``cross_k``/``cross_v [n_units, B, KV,
    frontend_len, hd]`` in the compute dtype."""
    jcfg, cfg = _configs(arch)
    want = jax_build(jcfg).init_cache(2, 16)
    got = Model(cfg, device="cpu", init=False).init_cache(2, 16)
    assert sorted(got) == sorted(want)
    for key in ("cross_k", "cross_v"):
        if key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[1] == str(want[key].dtype)
    for name, c in want["layers"].items():
        for k, v in c.items():
            assert tuple(got["layers"][name][k].shape) == v.shape


# ---------------------------------------------------------------------------
# training: train_loss and every gradient
# ---------------------------------------------------------------------------

def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "frontend_embeds": _frames(cfg, 2, seed + 1)}


def _port_loss_grads(tree, cfg, batch, remat=True):
    m = params_from_numpy(tree, cfg, device="cpu", train=True)
    loss = m.train_loss(batch, remat=remat)
    loss.backward()
    return float(loss.detach()), named_to_numpy(
        {n: p.grad for n, p in m.named_parameters()}, m)


def _rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype):
    """Every gradient, the encoder's, the cross-attention's and
    ``frontend_proj``'s included; paligemma's loss covers its 24 text
    positions only, not the 8 of its prefix."""
    ref = _reference(arch, dtype)
    cfg, batch = ref["cfg"], _batch(ref["cfg"])
    want_loss, want = ref["grad"](ref["params"],
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    want = jax.tree_util.tree_map(np.asarray, want)
    loss, grads = _port_loss_grads(ref["tree"], cfg, batch)
    loss_tol, grad_tol = TRAIN_TOL[dtype]
    assert abs(loss - float(want_loss)) <= loss_tol
    errs = jax.tree_util.tree_map(_rel, grads, want)
    flat = [(jax.tree_util.keystr(k), e)
            for k, e in jax.tree_util.tree_leaves_with_path(errs)]
    assert len(flat) == len(jax.tree_util.tree_leaves(want))
    names = " ".join(k for k, _ in flat)
    assert "frontend_proj" in names
    assert ("encoder" in names and "cross" in names) == cfg.enc_dec
    bad = {k: e for k, e in flat if not e <= grad_tol}
    assert not bad, f"gradients off by more than {grad_tol}: {bad}"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    ref = _reference(arch, "bfloat16")
    batch = _batch(ref["cfg"], seed=3)
    a_loss, a = _port_loss_grads(ref["tree"], ref["cfg"], batch, remat=True)
    b_loss, b = _port_loss_grads(ref["tree"], ref["cfg"], batch, remat=False)
    assert a_loss == b_loss
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_init_matches_serving_model_of_the_seed(arch):
    """``TrainModel.init_params`` draws in ``Model``'s order (units with
    their cross groups, the encoder, ``frontend_proj``): a serving model
    of the same seed holds the masters cast; the final norm and
    ``enc_norm`` stay float32."""
    cfg = get_config(arch, smoke=True)
    t = TrainModel(cfg, device="cpu", seed=4)
    s = Model(cfg, device="cpu", seed=4)
    got = dict(s.named_parameters())
    assert sorted(got) == sorted(n for n, _ in t.named_parameters())
    for name, p in t.named_parameters():
        want = p.detach() if name in ("final_norm", "enc_norm") else \
            p.detach().to(torch.bfloat16)
        assert got[name].dtype == want.dtype and torch.equal(got[name],
                                                             want), name
        assert p.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_build(arch):
    """The published configs, on the meta device (no memory): the
    parameter count is ``n_params`` plus the norms, the padded vocab rows
    and ``frontend_proj`` (which ``n_params`` leaves out)."""
    cfg = get_config(arch)
    for cls in (Model, TrainModel):
        m = cls(cfg, device="meta", init=False)
        n = sum(p.numel() for p in m.parameters())
        norms = (3 if cfg.enc_dec else 2) * cfg.n_layers + 1 + (
            2 * cfg.n_enc_layers + 1 if cfg.enc_dec else 0)
        pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model
        assert n == cfg.n_params + (norms + cfg.frontend_dim) * cfg.d_model \
            + pad


# ---------------------------------------------------------------------------
# the converters, the launcher and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_new_keys_both_ways(arch):
    """With 3 encoder layers beside 2 units, so the encoder's stacked axis
    is its own: every key there and back, the AdamW state too; a wrong
    stack, a wrong shape and a missing key raise."""
    jcfg, cfg = _configs(arch, dtype="float32")
    if cfg.enc_dec:
        jcfg = dataclasses.replace(jcfg, n_enc_layers=3)
        cfg = dataclasses.replace(cfg, n_enc_layers=3)
    tree = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    m = params_from_numpy(tree, cfg, device="cpu", train=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(m), tree)
    opt = {"m": tree, "v": tree, "step": np.asarray(3, np.int32)}
    state = opt_state_from_numpy(opt, m)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           opt_state_to_numpy(state, m), opt)
    new = ["frontend_proj"] + (
        ["enc_norm", "encoder.2.layer0.attn.wq", "encoder.0.layer0.ln2",
         "units.1.layer0.ln_cross", "units.1.layer0.cross.wo"]
        if cfg.enc_dec else [])
    for name in new:
        assert name in state["m"], name
        key, idx = ref_key(name)
        want = tree
        for part in key.split("."):
            want = want[part]
        np.testing.assert_array_equal(_np(dict(m.named_parameters())[name]),
                                      want[idx] if idx >= 0 else want)

    def edited(fn):
        t = jax.tree_util.tree_map(lambda a: a, tree)
        fn(t)
        return t

    with pytest.raises(ValueError, match="frontend_proj"):
        params_from_numpy(edited(lambda t: t.update(
            frontend_proj=t["frontend_proj"][1:])), cfg, device="cpu")
    with pytest.raises(KeyError, match="frontend_proj"):
        load_params(Model(cfg, device="cpu", init=False),
                    edited(lambda t: t.pop("frontend_proj")))
    if cfg.enc_dec:
        enc = tree["encoder"]["layer0"]
        with pytest.raises(ValueError, match="encoder.layer0.ln1"):
            params_from_numpy(edited(lambda t: t["encoder"]["layer0"].update(
                ln1=enc["ln1"][:2])), cfg, device="cpu")
        with pytest.raises(ValueError, match="cross.wk"):
            params_from_numpy(edited(lambda t: t["units"]["layer0"][
                "cross"].update(wk=t["units"]["layer0"]["cross"]["wk"][
                    :, :, :8])), cfg, device="cpu")
        for drop in (lambda t: t.pop("enc_norm"),
                     lambda t: t["units"]["layer0"].pop("ln_cross"),
                     lambda t: t["encoder"]["layer0"]["mlp"].pop("wo")):
            with pytest.raises(KeyError):
                load_params(Model(cfg, device="cpu", init=False),
                            edited(drop))
        with pytest.raises(KeyError, match="enc_norm"):
            opt_state_from_numpy({"m": edited(lambda t: t.pop("enc_norm"))},
                                 m)


def _jax_launcher(arch, requests=16, steps=8, prompt_len=16, page_size=16,
                  n_pages=64):
    """The reference launcher's main() (``repro/launch/serve.py``) in
    float32: the cache of ``total + frontend_len`` and the ``0.02 *
    ones`` embeddings; returns the admitted set and the greedy tokens."""
    ref = _reference(arch, "float32")
    cfg, jm, params = ref["cfg"], ref["jm"], ref["params"]
    rng = np.random.default_rng(0)
    pages_per_req = -(-(prompt_len + steps) // page_size)
    reqs = np.full((requests, pages_per_req), -1, np.int32)
    cursor = 0
    for i in range(requests):
        reqs[i] = np.arange(cursor, cursor + pages_per_req) % n_pages
        cursor += rng.integers(1, pages_per_req + 1)
    admitted = np.nonzero(JaxPageAllocator(n_pages).admit(reqs))[0]
    B = len(admitted)
    tokens = rng.integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    cache = jm.init_cache(B, prompt_len + steps + cfg.frontend_len)
    fe = 0.02 * np.ones((B, cfg.frontend_len, cfg.frontend_dim), np.float32)
    logits, cache = ref["prefill"](params, jnp.asarray(tokens), cache,
                                   jnp.asarray(fe))
    out = []
    for _ in range(steps):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(nxt))
        logits, cache = ref["decode"](params, nxt, cache)
    return admitted, tokens, np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_launcher(arch):
    ref = _reference(arch, "float32")
    cfg = dataclasses.replace(ref["cfg"], attn_impl="pallas")
    admitted, prompts, gen = _jax_launcher(arch)
    model = params_from_numpy(ref["tree"], cfg, device="cpu")
    res = serve_mod.serve(cfg, requests=16, steps=8, prompt_len=16,
                          page_size=16, n_pages=64, device="cpu", model=model)
    assert len(admitted) > 0
    np.testing.assert_array_equal(res.admitted, admitted)
    np.testing.assert_array_equal(res.prompts, prompts)
    np.testing.assert_array_equal(res.generated, gen)
    assert res.logits_finite
    # make_prefill_step hands the embeddings through to the model
    B = len(admitted)
    fe = torch.full((B, cfg.frontend_len, cfg.frontend_dim), 0.02)
    step = make_prefill_step(model)
    with torch.inference_mode():
        a, ca = step(torch.from_numpy(prompts), model.init_cache(B, 40), fe)
        b, cb = model.prefill(torch.from_numpy(prompts),
                              model.init_cache(B, 40), fe)
    assert torch.equal(a, b) and ca["index"] == cb["index"]


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_arch_without_embeddings_raises(arch):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    tok = torch.zeros(1, 4, dtype=torch.int64)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="frontend embeddings"):
        m.prefill(tok, m.init_cache(1, 8 + cfg.frontend_len))
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="frontend_embeds"):
        m.prefill(tok, m.init_cache(1, 8 + cfg.frontend_len),
                  torch.zeros(1, cfg.frontend_len, cfg.frontend_dim + 1))
    t = TrainModel(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="frontend embeddings"):
        t.train_loss({"tokens": tok, "labels": tok})


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b"])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    admitted = int(out[0].split()[1].split("/")[0])
    assert out[0].startswith("admitted ") and admitted > 0
    assert out[1].startswith(f"generated ({admitted}, 8) tokens")
