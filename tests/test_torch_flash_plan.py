"""The flash op's route plan and the decode route's split-K arithmetic, on
the CPU.

``plan`` decides, from the shape and dtype alone, which Hopper kernel a
call takes (``decode``, ``tc`` or ``simt``) and how many key splits the
decode route launches; these tests need no card.  ``ref.split_partials``
and ``ref.combine_partials`` mirror the decode route's two launches in
plain PyTorch: combining the partials must give the unsplit plain version
within 1e-6 in float32 (the two differ only in the order of f32 sums),
with empty splits and rows that see no key at all; the JAX reference's
kernel (interpret mode) is held against it once too, at 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_flat as jax_flat
from repro_torch.kernels.flash_attention import kernel, ref

H100_SMS = 132


@pytest.mark.parametrize("dtype,hd,rows,route", [
    (torch.bfloat16, 128, 4, "decode"),       # a llama3 decode step
    (torch.float32, 128, 4, "decode"),
    (torch.bfloat16, 8, 16, "decode"),        # 16 rows: still decode
    (torch.float32, 40, 1, "decode"),         # any head_dim
    (torch.bfloat16, 128, 8192, "tc"),        # the serve cell's prefill
    (torch.bfloat16, 256, 17, "tc"),          # gemma2's head_dim
    (torch.bfloat16, 64, 140, "tc"),
    (torch.float32, 128, 8192, "simt"),       # f32 never takes wgmma
    (torch.bfloat16, 96, 64, "simt"),         # no tc instance for 96
    (torch.bfloat16, 16, 64, "simt"),
])
def test_plan_route(dtype, hd, rows, route):
    assert kernel.plan(dtype, hd, rows, 2080, 104, H100_SMS)[0] == route


def test_plan_decode_splits_at_the_serve_cell():
    # 13 requests x 8 kv heads, a 2080-slot cache, 132 SMs: one split per
    # kv head (104 CTAs), no combine
    route, splits = kernel.plan(torch.bfloat16, 128, 4, 2080, 104, H100_SMS)
    assert (route, splits) == ("decode", 1)
    assert kernel.split_chunk(2080, splits) == (2112, 1)


# (16 and 8 splits of 2080 keys round to whole 64-key quanta: 11 and 7)
@pytest.mark.parametrize("Sk,HK,want", [(2080, 8, 11), (2080, 16, 7),
                                        (300, 2, 2), (40, 1, 1),
                                        (32768, 8, 16), (2080, 200, 1),
                                        (1 << 20, 200, 16)])
def test_plan_decode_splits_fill_the_sms_once(Sk, HK, want):
    assert kernel.plan(torch.bfloat16, 128, 4, Sk, HK, H100_SMS)[1] == want


@pytest.mark.parametrize("Sk", [1, 40, 127, 128, 300, 2080, 4096, 32768,
                                1 << 20])
@pytest.mark.parametrize("HK", [1, 8, 104, 1024])
def test_plan_decode_splits_cover_the_cache(Sk, HK):
    _, splits = kernel.plan(torch.float32, 64, 4, Sk, HK, H100_SMS)
    chunk, n = kernel.split_chunk(Sk, splits)
    assert n == splits >= 1
    assert chunk % kernel.SPLIT_QUANTUM == 0
    assert (n - 1) * chunk < Sk <= n * chunk      # no split is empty of keys
    assert chunk <= kernel.MAX_SPLIT_KEYS
    if splits > 1 and Sk <= kernel.MAX_SPLIT_KEYS * H100_SMS // HK:
        assert Sk / splits >= 128                 # at least 128 keys a split
        assert HK * splits <= H100_SMS            # at most one CTA per SM


@pytest.mark.parametrize("forced", [1, 2, 9, 33])
def test_plan_forced_splits_land_exactly(forced):
    assert kernel.plan(torch.bfloat16, 128, 4, 2080, 2, H100_SMS,
                       splits=forced) == ("decode", forced)


@pytest.mark.parametrize("dtype,hd,splits,needs", [
    (torch.bfloat16, 128, 1, False),          # the serve cell's decode
    (torch.bfloat16, 64, 1, False),
    (torch.bfloat16, 256, 1, False),
    (torch.bfloat16, 128, 2, True),           # a combine reads it
    (torch.bfloat16, 40, 1, True),            # the SIMT split kernel
    (torch.float32, 128, 1, True),
])
def test_decode_workspace_only_where_it_is_read(dtype, hd, splits, needs):
    # one split of the mma kernel writes the output itself
    assert kernel.needs_workspace(dtype, hd, splits) is needs


@pytest.mark.parametrize("Sk", [1, 63, 64, 65, 2080, 5000])
def test_split_chunk_is_a_fixed_point(Sk):
    for want in range(1, 80):
        chunk, n = kernel.split_chunk(Sk, want)
        assert n <= want and kernel.split_chunk(Sk, n) == (chunk, n)


def _inputs(HK, g, Sq, Sk, hd, q_at, seed=0, empty_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HK * g, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((HK, Sk, hd), dtype=np.float32)
    v = rng.standard_normal((HK, Sk, hd), dtype=np.float32)
    qp = np.arange(Sq, dtype=np.float32) + q_at
    if empty_row:
        qp[0] = -1.0
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(qp), torch.arange(Sk, dtype=torch.float32))


SPLIT_CASES = [
    # (HK, g, Sq, Sk, hd, q_at, causal, window, cap, splits, empty_row)
    (2, 4, 1, 2080, 32, 2079.0, True, 0, 0.0, 7, False),    # serve-like
    (2, 4, 1, 2080, 32, 1500.0, True, 0, 0.0, 9, False),    # empty tails
    (2, 4, 1, 2080, 16, 1500.0, True, 0, 0.0, 33, False),
    (3, 2, 8, 300, 24, 100.0, True, 0, 0.0, 5, True),       # a row sees nothing
    (1, 1, 16, 500, 8, 0.0, False, 0, 0.0, 4, False),       # no mask at all
    (2, 2, 4, 400, 16, 350.0, True, 32, 50.0, 6, False),    # window + softcap
    (2, 4, 1, 200, 8, -5.0, True, 0, 0.0, 3, False),        # no row sees a key
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_and_combine_equal_the_plain_version(case):
    HK, g, Sq, Sk, hd, q_at, causal, window, cap, splits, empty_row = case
    q, k, v, qp, kp = _inputs(HK, g, Sq, Sk, hd, q_at, empty_row=empty_row)
    kw = dict(g=g, scale=1.0 / np.sqrt(hd), causal=causal, window=window,
              attn_cap=cap)
    m, l, acc = ref.split_partials(q, k, v, qp, kp, splits=splits, **kw)
    _, n = kernel.split_chunk(Sk, splits)
    assert m.shape == l.shape == (HK, n, g * Sq)
    assert acc.shape == (HK, n, g * Sq, hd)
    empty = l == 0
    assert bool((m[empty] == float("-inf")).all())
    assert bool((acc[empty] == 0).all())
    got = ref.combine_partials(m, l, acc, v, Sq=Sq, dtype=torch.float32)
    want = ref.flash_attention_flat(q, k, v, qp, kp, **kw)
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_split_partials_empty_tail_splits():
    # the row at 1500 of a 2080-key cache: splits past it see nothing
    q, k, v, qp, kp = _inputs(2, 4, 1, 2080, 16, 1500.0)
    m, l, acc = ref.split_partials(q, k, v, qp, kp, g=4, scale=0.25,
                                   causal=True, window=0, attn_cap=0.0,
                                   splits=9)
    chunk, _ = kernel.split_chunk(2080, 9)
    live = (torch.arange(9) * chunk <= 1500)[None, :, None]
    assert bool(((l > 0) == live.expand_as(l)).all())


def test_split_combine_matches_the_jax_kernel():
    q, k, v, qp, kp = _inputs(2, 4, 1, 256, 32, 200.0, seed=3)
    kw = dict(g=4, scale=1.0 / np.sqrt(32), causal=True, window=0,
              attn_cap=0.0)
    m, l, acc = ref.split_partials(q, k, v, qp, kp, splits=3, **kw)
    got = ref.combine_partials(m, l, acc, v, Sq=1, dtype=torch.float32)
    want = jax_flat(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                    jnp.asarray(v.numpy()), jnp.asarray(qp.numpy()),
                    jnp.asarray(kp.numpy()), tq=16, tk=16, interpret=True,
                    **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
