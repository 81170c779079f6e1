"""The port's ``TrainModel.train_loss`` on the CPU against the reference's
``jax.value_and_grad(model.train_loss)``.

The four dense archs' smoke configs (llama3-8b, gemma2-9b with windows
and softcaps, glm4-9b with partial rotary, qwen1.5-32b with QKV bias) in
float32 and bfloat16 compute, from the reference's ``init_params`` with
every norm and bias (and, stacked, every unit leaf of one dimension)
moved off zero by seeded noise, carried across with
``params_from_numpy(..., train=True)``; 24-key chunks of 8 so the
chunked attention runs three chunks.  Tolerances:

- float32: the loss within 1e-5, every gradient within 1e-5 in relative
  norm (``||g_port - g_ref|| / ||g_ref||``; readings ~1.5e-6);
- bfloat16: the loss within 5e-3, every gradient within 5e-2 relative
  norm (bf16 rounds at other places in the two libraries; readings up to
  1.1e-3 and 1.8e-2).

Remat on and off give the same loss and gradients bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models.convert import named_to_numpy, params_from_numpy

ARCHS = ["llama3_8b", "gemma2_9b", "glm4_9b", "qwen15_32b"]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-3, 5e-2)}   # loss, grad


def _setup(arch: str, dtype: str, seed: int = 0):
    over = dict(dtype=dtype, attn_chunk=8)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    model = jax_build(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def nudge(a):        # norms and biases off zero (1-D, or stacked 1-D)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == cfg.n_units):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map(nudge, params)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    return model, params, cfg, batch


def _port_loss_grads(params, cfg, batch, remat=True):
    m = params_from_numpy(params, cfg, device="cpu", train=True)
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
    model, params, cfg, batch = _setup(arch, dtype)
    want_loss, want = jax.value_and_grad(model.train_loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.tree_util.tree_map(np.asarray, want)
    loss, grads = _port_loss_grads(params, cfg, batch)
    loss_tol, grad_tol = TOL[dtype]
    assert abs(loss - float(want_loss)) <= loss_tol
    errs = jax.tree_util.tree_map(_rel, grads, want)
    flat = jax.tree_util.tree_leaves_with_path(errs)
    assert len(flat) == len(jax.tree_util.tree_leaves(want))
    bad = {jax.tree_util.keystr(k): e for k, e in flat if not e <= grad_tol}
    assert not bad, f"gradients off by more than {grad_tol}: {bad}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_equals_no_remat(dtype):
    _, params, cfg, batch = _setup("gemma2_9b", dtype, seed=3)
    a_loss, a = _port_loss_grads(params, cfg, batch, remat=True)
    b_loss, b = _port_loss_grads(params, cfg, batch, remat=False)
    assert a_loss == b_loss
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_masters_stay_float32_and_serving_model_is_unchanged():
    """The training model's masters are float32 leaves with gradients; a
    serving model from the same tree keeps its bf16 frozen weights."""
    _, params, cfg, _ = _setup("qwen15_32b", "bfloat16")
    m = params_from_numpy(params, cfg, device="cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in m.parameters())
    s = params_from_numpy(params, cfg, device="cpu")
    assert s.units[0]["layer0"].attn["wq"].dtype == torch.bfloat16
    assert not any(p.requires_grad for p in s.parameters())
