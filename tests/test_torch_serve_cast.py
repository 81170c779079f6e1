"""The serving ``Model`` holds the numbers the reference serves with.

The reference's ``prefill``/``decode_step`` cast every floating leaf of
two or more dimensions to the compute dtype (``_cast_params``).  Unit
leaves are stacked over the units, so norms and QKV biases are cast
too; only ``final_norm`` stays float32.  A reference tree whose norms
and biases are moved off zero (random init leaves them zero, which any
dtype holds exactly) must arrive in the port equal to ``_cast_params``
of it, bit for bit and dtype for dtype; and qwen1.5's bf16 serve must
reach the flash op in bf16 (a float32 bias would widen q and k).  The
encoder-decoder's encoder leaves are stacked too (over ``n_enc_layers``)
and ``frontend_proj`` has two dimensions, so both are cast; ``enc_norm``
stays float32 beside the final norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.transformer import _cast_params
from repro_torch.configs import get_config
from repro_torch.models import attention as pt_attn
from repro_torch.models.convert import params_from_numpy, ref_key


def _nudged_tree(arch, cfg, seed=0):
    tree = jax_build(dataclasses.replace(jax_config(arch, smoke=True),
                                         dtype="bfloat16")).init_params(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def nudge(a):        # norms and biases off zero (1-D, or stacked 1-D)
        a = np.asarray(a)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == cfg.n_units):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(nudge, tree)


def _leaf(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ["qwen15_32b", "llama3_8b",
                                  "granite_moe_3b_a800m",
                                  "seamless_m4t_medium", "paligemma_3b"])
def test_serving_model_holds_cast_params(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    tree = _nudged_tree(arch, cfg)
    want = _cast_params(tree, jnp.bfloat16)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg,
                              device="cpu")
    names = dict(model.named_parameters())
    stacked = [(cfg.n_units, "units"), (cfg.n_enc_layers, "encoder")]
    assert len(names) == len(jax.tree_util.tree_leaves(tree)) + sum(
        (n - 1) * len(jax.tree_util.tree_leaves(tree[key]))
        for n, key in stacked if key in tree)
    for name, p in names.items():
        key, unit = ref_key(name)
        w = _leaf(want, key)
        w = w[unit] if unit >= 0 else w
        assert str(p.dtype).split(".")[1] == str(w.dtype), name
        assert np.array_equal(p.detach().float().numpy(),
                              np.asarray(w.astype(jnp.float32))), name
    assert model.final_norm.dtype == torch.float32
    if cfg.enc_dec:
        assert model.enc_norm.dtype == torch.float32
        assert model.encoder[0]["layer0"].ln1.dtype == torch.bfloat16
        assert model.units[0]["layer0"].ln_cross.dtype == torch.bfloat16
    if cfg.frontend != "none":
        assert model.frontend_proj.dtype == torch.bfloat16
    if cfg.qkv_bias:
        assert float(model.units[0]["layer0"].attn["bq"].float().abs()
                     .sum()) > 0


def test_qwen15_bf16_serve_reaches_flash_in_bf16(monkeypatch):
    arch = "qwen15_32b"
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16",
                              attn_impl="pallas")
    tree = jax.tree_util.tree_map(np.asarray, _nudged_tree(arch, cfg))
    model = params_from_numpy(tree, cfg, device="cpu")
    seen = []
    op = pt_attn.fa_ops.flash_attention

    def recording(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return op(q, k, v, *a, **kw)

    monkeypatch.setattr(pt_attn.fa_ops, "flash_attention", recording)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    with torch.inference_mode():
        logits, cache = model.prefill(tok, model.init_cache(2, 10))
        model.decode_step(tok[:, :1], cache)
    assert len(seen) == 2 * cfg.n_layers
    assert all(d == (torch.bfloat16,) * 3 for d in seen), seen


def test_nudged_qwen15_bf16_logits_match_reference():
    """Prefill and a decode step of the nudged tree against the reference
    in bf16, within the dense archs' bf16 limit (5e-2)."""
    arch = "qwen15_32b"
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="bfloat16",
                               attn_chunk=8)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16",
                              attn_chunk=8)
    tree = _nudged_tree(arch, cfg)
    jm = jax_build(jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg,
                              device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (2, 12)).astype(np.int32)
    lj, jc = jax.jit(jm.prefill)(tree, jnp.asarray(prompt),
                                 jm.init_cache(2, 14))
    nxt = np.array(jnp.argmax(lj, axis=-1), np.int32)[:, None]
    lj2, _ = jax.jit(jm.decode_step)(tree, jnp.asarray(nxt), jc)
    with torch.inference_mode():
        lt, tc = model.prefill(torch.from_numpy(prompt),
                               model.init_cache(2, 14))
        lt2, _ = model.decode_step(torch.from_numpy(nxt), tc)
    for got, want in ((lt, lj), (lt2, lj2)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=5e-2,
                                   atol=5e-2)
