"""The port's training attention on the CPU against the JAX reference.

``repro_torch.models.attention.FlashAttention`` (the port of the
reference's ``_make_flash`` custom VJP: forward with the row log-sum-exp,
recompute backward) against ``jax.grad`` of the reference's
``_sdpa_chunked`` and ``_sdpa_ref``, over the cases of
``tests/test_models.py::test_attention_impls_agree`` (causal or not, a
window, a softcap) with GQA groups of 1 and 4 and key chunks that divide
``Sk`` and that do not.  Inputs and the output cotangent are made with
numpy from a seed.  Tolerance: float32, 1e-5 (rtol and atol) against the
reference's chunked version, whose arithmetic the port repeats; 5e-5
against ``_sdpa_ref``, which sums the softmax in another order (the
reference's own test holds its two versions' gradients to 5e-4).  The
log-sum-exp is held to the reference scores' ``logsumexp``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as pt_attn

CASES = [  # causal, window, softcap
    (True, 0, 0.0), (True, 7, 0.0), (True, 0, 30.0), (False, 0, 0.0),
    (False, 7, 30.0)]
SCALE = 0.25
TOL = 1e-5
REF_TOL = 5e-5


def _inputs(G: int, seed: int = 0, B: int = 2, KV: int = 2, S: int = 24,
            hd: int = 16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, S, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, S, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, S, hd), dtype=np.float32)
    do = rng.standard_normal((B, KV, G, S, hd), dtype=np.float32)
    return q, k, v, do, np.arange(S, dtype=np.float32)


def _jax_lse(q, k, pos, causal, window, cap):
    s = jnp.einsum("bkgqd,bkcd->bkgqc", q, k) * SCALE
    s = jax_layers.softcap(s, cap)
    s = s + jax_attn._fmask_bias(pos, pos, causal, window)
    return jax.nn.logsumexp(s, axis=-1)


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, pos, causal, window, cap, chunk):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    p = torch.from_numpy(pos)
    out = pt_attn.FlashAttention.apply(qt, kt, vt, p, p, causal, window, cap,
                                       SCALE, chunk)
    out.backward(torch.from_numpy(do))
    _, lse = pt_attn._chunked_forward(
        qt.detach(), kt.detach(), vt.detach(), p, p, causal=causal,
        window=window, attn_cap=cap, scale=SCALE, chunk=chunk)
    return (out.detach().numpy(), lse.numpy(),
            [t.grad.numpy() for t in (qt, kt, vt)])


@pytest.mark.parametrize("chunk", [8, 5], ids=["chunk_divides", "ragged"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal,window,cap", CASES)
def test_flash_function_matches_reference(causal, window, cap, G, chunk):
    q, k, v, do, pos = _inputs(G)
    kw = dict(causal=causal, window=window, attn_cap=cap, scale=SCALE)
    jp = jnp.asarray(pos)
    out, lse, grads = _port(q, k, v, do, pos, causal, window, cap, chunk)

    want_out, want = _jax_grads(
        lambda a, b, c: jax_attn._sdpa_chunked(a, b, c, jp, jp, chunk=chunk,
                                               **kw), q, k, v, do)
    np.testing.assert_allclose(out, want_out, rtol=TOL, atol=TOL)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lse, np.asarray(_jax_lse(q, k, jp, causal, window, cap)),
        rtol=TOL, atol=TOL)

    ref_out, ref_grads = _jax_grads(
        lambda a, b, c: jax_attn._sdpa_ref(a, b, c, jp, jp, **kw), q, k, v,
        do)
    np.testing.assert_allclose(out, ref_out, rtol=REF_TOL, atol=REF_TOL)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=REF_TOL, atol=REF_TOL)


@pytest.mark.parametrize("causal,window,cap", CASES[:3])
def test_kernel_path_lse_matches_reference(causal, window, cap):
    """``ops.flash_attention_lse`` (the kernel's training call; on the CPU
    its plain version) gives the reference's output and log-sum-exp, and
    the Function's backward from that lse the reference's gradients."""
    q, k, v, do, pos = _inputs(4, seed=1)
    kw = dict(causal=causal, window=window, attn_cap=cap, scale=SCALE)
    p = torch.from_numpy(pos)
    out, lse = fa_ops.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), p, p,
        **kw)
    jp = jnp.asarray(pos)
    want_out, want = _jax_grads(
        lambda a, b, c: jax_attn._sdpa_chunked(a, b, c, jp, jp, chunk=8,
                                               **kw), q, k, v, do)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(_jax_lse(q, k, jp, causal, window, cap)),
        rtol=TOL, atol=TOL)
    grads = pt_attn._flash_backward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), p, p,
        out, lse, torch.from_numpy(do), chunk=8, **kw)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_serving_forward_unchanged():
    """Without gradients the chunked path gives the Function's forward:
    the serving call and the training call share one forward."""
    q, k, v, _, pos = _inputs(4, seed=2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    kw = dict(causal=True, window=0, attn_cap=0.0, scale=SCALE)
    with torch.no_grad():
        a = pt_attn._sdpa_chunked(*t, p, p, chunk=8, **kw)
    b, _ = pt_attn._chunked_forward(*t, p, p, chunk=8, **kw)
    assert torch.equal(a, b)
