"""The port's flash attention on the CPU against the JAX reference.

The same numpy inputs go through the reference's Pallas kernel
(``flash_attention_flat`` in interpret mode, ``tq = tk = 16``) and
through the port's plain version and its device-dispatching op (a CPU
tensor runs the plain version; the Hopper kernel is held against it on
the card in ``tests/test_torch_cuda.py``).  The model's own attention
implementations (``_sdpa_ref`` and the chunked forward) are held against
the reference's too.

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 (rtol = atol), the
reference's own kernel-test tolerances; the port computes the softmax
and the product with v in float32, the reference kernel rounds p to the
input dtype first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_flat as jax_flat
from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_flat, ref)
from repro_torch.models import attention as pt_attn

FA_CASES = [
    # (B, KV, G, Sq, Sk, hd, causal, window, cap, dtype): the reference's
    # tests/test_kernels.py cases, plus llama3's head_dim and group
    (1, 1, 1, 16, 16, 8, True, 0, 0.0, "float32"),
    (2, 2, 2, 32, 32, 16, True, 0, 0.0, "float32"),
    (1, 2, 4, 24, 40, 8, True, 0, 0.0, "float32"),    # gqa + ragged tiles
    (1, 1, 1, 16, 48, 8, False, 0, 0.0, "float32"),   # cross-attn style
    (2, 1, 2, 32, 32, 8, True, 9, 0.0, "float32"),    # sliding window
    (1, 2, 1, 32, 32, 8, True, 0, 30.0, "float32"),   # softcap (gemma2)
    (1, 1, 2, 16, 16, 8, True, 0, 0.0, "bfloat16"),   # bf16 inputs
    (1, 1, 1, 1, 40, 8, True, 0, 0.0, "float32"),     # decode: Sq=1
    (1, 2, 4, 32, 40, 128, True, 0, 0.0, "float32"),  # llama3: hd 128, G 4
    (1, 2, 4, 32, 40, 128, True, 0, 0.0, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(case, seed=0):
    B, KV, G, Sq, Sk, hd, causal, window, cap, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, Sk, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, Sk, hd), dtype=np.float32)
    qp = np.arange(Sq) + (Sk - Sq if causal and Sq == 1 else 0)
    kp = np.arange(Sk)
    kw = dict(causal=causal, window=window, attn_cap=cap,
              scale=1.0 / np.sqrt(hd))
    return q, k, v, qp, kp, kw


def _jax(x, dt):
    return jnp.asarray(x).astype(JAX_DT[dt])


def _torch(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DT[dt])


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


def _jax_kernel(q, k, v, qp, kp, kw, dt, tk=16):
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[2]
    out = jax_flat(_jax(q.reshape(B * KV * G, Sq, hd), dt),
                   _jax(k.reshape(B * KV, Sk, hd), dt),
                   _jax(v.reshape(B * KV, Sk, hd), dt),
                   jnp.asarray(qp), jnp.asarray(kp), g=G, tq=16, tk=tk,
                   interpret=True, **kw)
    return _np(out).reshape(B, KV, G, Sq, hd)


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flat_matches_jax_kernel(case):
    q, k, v, qp, kp, kw = _inputs(case)
    B, KV, G, Sq, Sk, hd, *_, dt = case
    want = _jax_kernel(q, k, v, qp, kp, kw, dt)
    got = ref.flash_attention_flat(
        _torch(q.reshape(B * KV * G, Sq, hd), dt),
        _torch(k.reshape(B * KV, Sk, hd), dt),
        _torch(v.reshape(B * KV, Sk, hd), dt),
        torch.from_numpy(qp), torch.from_numpy(kp), g=G, **kw)
    assert got.dtype == TORCH_DT[dt] and got.shape == (B * KV * G, Sq, hd)
    np.testing.assert_allclose(_np(got).reshape(want.shape), want,
                               rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("case", FA_CASES)
def test_op_on_cpu_matches_jax_kernel(case):
    q, k, v, qp, kp, kw = _inputs(case, seed=1)
    dt = case[-1]
    want = _jax_kernel(q, k, v, qp, kp, kw, dt)
    before = flash_attention_cuda.launches
    got = flash_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                          torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    assert flash_attention_cuda.launches == before   # the CPU never launches
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("impl", ["ref", "chunked"])
@pytest.mark.parametrize("case", FA_CASES)
def test_model_sdpa_matches_jax(case, impl):
    q, k, v, qp, kp, kw = _inputs(case, seed=2)
    dt = case[-1]
    extra = dict(chunk=16) if impl == "chunked" else {}
    want = jax_attn._IMPLS[impl](_jax(q, dt), _jax(k, dt), _jax(v, dt),
                                 jnp.asarray(qp), jnp.asarray(kp), **kw,
                                 **extra)
    got = pt_attn._IMPLS[impl](_torch(q, dt), _torch(k, dt), _torch(v, dt),
                               torch.from_numpy(qp), torch.from_numpy(kp),
                               **kw, **extra)
    assert got.dtype == TORCH_DT[dt]
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dt],
                               atol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_row_with_no_visible_key_is_mean_of_v(dt):
    """Row 0 sits before every key under the causal mask.  With a kv tile
    that divides Sk (8 | 24) the reference kernel gives the mean of v;
    the port gives it whatever the tile."""
    case = (1, 2, 2, 8, 24, 8, True, 0, 0.0, dt)
    q, k, v, qp, kp, kw = _inputs(case, seed=3)
    qp = qp.astype(np.float32)
    qp[0] = -1.0
    want = _jax_kernel(q, k, v, qp, kp, kw, dt, tk=8)
    vq = _np(_torch(v, dt))
    np.testing.assert_allclose(want[:, :, :, 0],
                               np.broadcast_to(vq.mean(axis=2)[:, :, None],
                                               want[:, :, :, 0].shape),
                               rtol=TOL[dt], atol=TOL[dt])
    got = flash_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                          torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dt], atol=TOL[dt])


def test_refused_inputs_raise():
    q = torch.zeros(4, 8, 16)
    k = torch.zeros(2, 8, 16)
    pos = torch.arange(8)
    kw = dict(scale=0.25, causal=True, window=0, attn_cap=0.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_flat(q.half(), k.half(), k.half(), pos, pos, g=2,
                             **kw)
    with pytest.raises(TypeError, match="q is"):
        flash_attention_flat(q, k.bfloat16(), k, pos, pos, g=2, **kw)
    with pytest.raises(ValueError, match="H == HK"):
        flash_attention_flat(torch.zeros(5, 8, 16), k, k, pos, pos, g=2,
                             **kw)
    with pytest.raises(ValueError, match="H == HK"):
        flash_attention_flat(q, k, k, pos, pos, g=3, **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_flat(torch.zeros(4, 8, 12), torch.zeros(2, 8, 12),
                             torch.zeros(2, 8, 12), pos, pos, g=2, **kw)
    with pytest.raises(ValueError, match="q_pos"):
        flash_attention_flat(q, k, k, pos[:4], pos, g=2, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, k, pos, pos, g=2, **kw)
