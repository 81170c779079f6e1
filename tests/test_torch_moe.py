"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against
the reference's ``repro.models.moe``.

Weights come from the reference's ``init_moe`` and inputs from numpy,
carried across as numpy arrays.  Tolerances:

- float32: outputs within 1e-6 of the reference output's largest
  magnitude (``_F32``; the expert products sum in another order, a few
  ulps of values up to ~17 here), the aux loss within 1e-6, routing
  (expert ids, capacity ranks, kept slots, counts) exact;
- bfloat16: outputs within 2e-2 of the largest magnitude (``_BF16``; bf16
  keeps 8 significant bits and the two libraries round the products and
  the combine at other places), on the tokens whose routing agrees; the
  router runs in float32 in both, and a token routed differently must
  have had a reference gap under ``GAP_EPS`` between neighbours of its
  k+1 largest probabilities (a near-tie that an ulp of a logit flips);
- gradients (``jax.vjp``): every leaf within 1e-5 in relative norm.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models import moe as JM
from repro.models.layers import KeyGen as JaxKeyGen
from repro_torch.models import layers as pt_layers
from repro_torch.models import moe as PM

_F32, _BF16 = 1e-6, 2e-2
GAP_EPS = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(D=16, E=5, F=24, seed=0):
    p = JM.init_moe(JaxKeyGen(jax.random.PRNGKey(seed)), D, E, F,
                    jnp.float32)
    return {k: np.array(v) for k, v in p.items()}


def _both(p, x, dtype):
    """The same numbers as the reference's and the port's inputs in
    ``dtype`` (the router stays float32 on both sides, as cast by the
    serving models it would be bf16: both promote it to float32)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jdt if k != "router" else jnp.float32)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(
        tdt if k != "router" else torch.float32) for k, v in p.items()}
    return jp, jnp.asarray(x).astype(jdt), tp, \
        torch.from_numpy(np.array(x)).to(tdt)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    limit = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"max abs err {err} > {limit}"


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# capacity, activations, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.05, 0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(cf):
    for N, E, K in itertools.product((1, 7, 64, 1000, 26624), (2, 5, 40,
                                                               128),
                                     (1, 2, 8)):
        assert PM._capacity(N, E, K, cf) == JM._capacity(N, E, K, cf)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_fn_matches_reference(act):
    x = _x((4, 33)) * 4
    got = pt_layers.act_fn(act)(torch.from_numpy(x))
    want = jax_layers.act_fn(act)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_init_moe_draws_in_the_reference_order():
    """router, wi_gate, wi_up, wo: each a float32 normal draw scaled by
    1/sqrt(fan_in) (the first axis), the router kept float32."""
    D, E, F = 8, 3, 12
    p = PM.init_moe(pt_layers.KeyGen(5), D, E, F, torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    for name, shape, dt in (("router", (D, E), torch.float32),
                            ("wi_gate", (E, D, F), torch.bfloat16),
                            ("wi_up", (E, D, F), torch.bfloat16),
                            ("wo", (E, F, D), torch.bfloat16)):
        want = torch.randn(shape, generator=gen).mul_(
            1.0 / np.sqrt(shape[0])).to(dt)
        assert p[name].dtype == dt and torch.equal(p[name], want), name


# ---------------------------------------------------------------------------
# routing: top-k order, capacity ranks, drops
# ---------------------------------------------------------------------------

def _route_oracle(ids: np.ndarray, E: int, C: int):
    """Ranks in token order, then k order, by a plain loop."""
    seen = np.zeros(E, np.int64)
    pos = np.zeros_like(ids)
    for n in range(ids.shape[0]):
        for k in range(ids.shape[1]):
            pos[n, k] = seen[ids[n, k]]
            seen[ids[n, k]] += 1
    return pos, pos < C, seen


@pytest.mark.parametrize("N,E,K,C,ties", [(64, 5, 2, 8, False),
                                          (200, 8, 2, 16, True),
                                          (300, 40, 8, 56, True),
                                          (50, 4, 4, 8, True)])
def test_route_matches_top_k_and_a_loop(N, E, K, C, ties):
    rng = np.random.default_rng(N + E)
    logits = rng.standard_normal((N, E)).astype(np.float32)
    if ties:                      # duplicated columns and whole tied rows
        logits[:, E - 1] = logits[:, 0]
        logits[:, 2] = logits[:, 1]
        logits[::7] = 0.0
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    r = PM.route(torch.from_numpy(probs.copy()), K, C)
    vals, ids = jax.lax.top_k(jnp.asarray(probs), K)
    vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(r.gate_vals.numpy(), np.asarray(vals),
                               rtol=1e-6, atol=1e-7)
    pos, keep, counts = _route_oracle(np.asarray(ids), E, C)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.counts.numpy(), counts)


# ---------------------------------------------------------------------------
# apply_moe / apply_moe_dense against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.05, 1.25, 8.0])
def test_apply_moe_f32(cf, groups):
    p, x = _params(), _x((2, 20, 16))
    jp, jx, tp, tx = _both(p, x, "float32")
    yj, aj = JM.apply_moe(jp, jx, top_k=2, capacity_factor=cf,
                          groups=groups)
    yt, at = PM.apply_moe(tp, tx, top_k=2, capacity_factor=cf,
                          groups=groups)
    _close(yt, yj, _F32)
    assert at.dtype == torch.float32 and at.shape == ()
    assert abs(float(at) - float(aj)) <= 1e-6


def test_groups_change_which_tokens_drop():
    """Capacity per group: at cf 0.5 the two groups drop other tokens than
    one group would, and the port follows the reference in both."""
    p, x = _params(), _x((2, 20, 16), seed=2)
    jp, jx, tp, tx = _both(p, x, "float32")
    outs = {}
    for g in (1, 2):
        yj, _ = JM.apply_moe(jp, jx, top_k=2, capacity_factor=0.5, groups=g)
        yt, _ = PM.apply_moe(tp, tx, top_k=2, capacity_factor=0.5, groups=g)
        _close(yt, yj, _F32)
        outs[g] = _np(yt)
    assert np.abs(outs[1] - outs[2]).max() > 1e-3


@pytest.mark.parametrize("top_k", [1, 2])
def test_ties_pick_the_lower_expert(top_k):
    """Tied experts (duplicated router columns) with different weights:
    the tie sits at the k-th place, so the output shows which one won."""
    p, x = _params(D=16, E=4), _x((1, 24, 16), seed=3)
    x[..., 0] = 5.0                   # a constant feature sets the order
    r = p["router"]
    r[0] = (0.0, 10.0, -10.0, 10.0) if top_k == 1 else \
        (20.0, 10.0, -10.0, 10.0)     # top-2: expert 0 leads, then the tie
    r[:, 3] = r[:, 1]                 # experts 1 and 3 tie for every token
    p["router"] = r
    assert not np.allclose(p["wi_gate"][1], p["wi_gate"][3])
    jp, jx, tp, tx = _both(p, x, "float32")
    probs = PM.router_probs(tx.reshape(-1, 16), tp["router"])
    assert torch.equal(probs[:, 1], probs[:, 3])
    ids = PM.route(probs, top_k, 64).expert_ids
    assert (ids[:, top_k - 1] == 1).all()
    for cf in (1.25, 8.0):
        yj, _ = JM.apply_moe(jp, jx, top_k=top_k, capacity_factor=cf)
        yt, _ = PM.apply_moe(tp, tx, top_k=top_k, capacity_factor=cf)
        _close(yt, yj, _F32)
    yj, _ = JM.apply_moe_dense(jp, jx, top_k=top_k)
    yt, _ = PM.apply_moe_dense(tp, tx, top_k=top_k)
    _close(yt, yj, _F32)


def test_capacity_drops_match_reference():
    """The reference's ``test_moe_capacity_drops_dont_nan`` input: 64
    tokens, 2 experts, top-2 at cf 0.05 (C = 8): most assignments drop
    and their tokens pass through as zeros."""
    key = jax.random.PRNGKey(0)
    p = {k: np.asarray(v) for k, v in JM.init_moe(
        JaxKeyGen(key), 8, 2, 16, jnp.float32).items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (1, 64, 8)))
    jp, jx, tp, tx = _both(p, x, "float32")
    yj, aj = JM.apply_moe(jp, jx, top_k=2, capacity_factor=0.05)
    yt, at = PM.apply_moe(tp, tx, top_k=2, capacity_factor=0.05)
    assert np.isfinite(_np(yt)).all()
    _close(yt, yj, _F32)
    assert abs(float(at) - float(aj)) <= 1e-6
    r = PM.route(PM.router_probs(tx.reshape(64, 8), tp["router"]), 2, 8)
    assert int(r.keep.sum()) == 16 and (_np(yt)[0, 8:] == 0).all()


@pytest.mark.parametrize("top_k", [1, 2, 5])
def test_apply_moe_dense_f32(top_k):
    p, x = _params(), _x((3, 1, 16), seed=4)
    jp, jx, tp, tx = _both(p, x, "float32")
    yj, aj = JM.apply_moe_dense(jp, jx, top_k=top_k)
    yt, at = PM.apply_moe_dense(tp, tx, top_k=top_k)
    _close(yt, yj, _F32)
    assert float(at) == float(aj) == 0.0


def _gap_at_k(probs: np.ndarray, k: int) -> np.ndarray:
    """The smallest gap between neighbours of each row's k+1 largest
    probabilities: a flip there changes the top-k set or its order."""
    s = np.sort(probs, axis=-1)[:, ::-1]
    return (s[:, :k] - s[:, 1:k + 1]).min(axis=-1)


@pytest.mark.parametrize("dense", [False, True])
def test_apply_moe_bf16(dense):
    """bf16 inputs and experts, the router float32: routing equal except
    at near-ties, outputs within ``_BF16`` on the tokens routed alike."""
    p = _params(D=32, E=8, F=48)
    x = _x((4, 1, 32) if dense else (2, 24, 32), seed=5)
    jp, jx, tp, tx = _both(p, x, "bfloat16")
    K = 2
    if dense:
        yj, _ = JM.apply_moe_dense(jp, jx, top_k=K)
        yt, _ = PM.apply_moe_dense(tp, tx, top_k=K)
    else:
        yj, _ = JM.apply_moe(jp, jx, top_k=K, capacity_factor=1.25)
        yt, _ = PM.apply_moe(tp, tx, top_k=K, capacity_factor=1.25)
    assert yt.dtype == torch.bfloat16
    D = x.shape[-1]
    pj = np.asarray(jax.nn.softmax(
        jx.reshape(-1, D).astype(jnp.float32) @ jp["router"], axis=-1))
    pt = PM.router_probs(tx.reshape(-1, D), tp["router"]).numpy()
    ids_j = np.asarray(jax.lax.top_k(jnp.asarray(pj), K)[1])
    ids_t = PM.topk_stable(torch.from_numpy(pt), K)[1].numpy()
    differ = (ids_j != ids_t).any(axis=1)
    assert (_gap_at_k(pj, K)[differ] < GAP_EPS).all()
    if differ.any():      # capacity ranks shift after a flipped token
        agree = np.arange(len(differ)) < np.argmax(differ)
    else:
        agree = np.ones(len(differ), bool)
    _close(_np(yt).reshape(-1, D)[agree], _np(yj).reshape(-1, D)[agree],
           _BF16)


# ---------------------------------------------------------------------------
# gradients against jax.vjp
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("path,cf,groups", [("capacity", 1.25, 1),
                                            ("capacity", 0.5, 1),
                                            ("capacity", 1.25, 2),
                                            ("dense", None, 1)])
def test_gradients_match_jax_vjp(path, cf, groups):
    """Every gradient (router, experts, x) of ``sum(y * dy) + 3 * aux``."""
    p = _params()
    x = _x((2, 1, 16) if path == "dense" else (2, 20, 16), seed=6)
    dy = _x(x.shape, seed=7)
    jp, jx, tp, tx = _both(p, x, "float32")

    def ref(params, xx):
        if path == "dense":
            return JM.apply_moe_dense(params, xx, top_k=2)
        return JM.apply_moe(params, xx, top_k=2, capacity_factor=cf,
                            groups=groups)

    _, vjp = jax.vjp(ref, jp, jx)
    gp, gx = vjp((jnp.asarray(dy), jnp.asarray(3.0, jnp.float32)))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx.requires_grad_()
    if path == "dense":
        y, aux = PM.apply_moe_dense(tp, tx, top_k=2)
    else:
        y, aux = PM.apply_moe(tp, tx, top_k=2, capacity_factor=cf,
                              groups=groups)
    ((y * torch.from_numpy(dy)).sum() + 3.0 * aux).backward()
    errs = {k: _rel(tp[k].grad.numpy(), gp[k]) for k in tp}
    errs["x"] = _rel(tx.grad.numpy(), gx)
    assert max(errs.values()) <= 1e-5, errs
    if path == "capacity":
        assert np.linalg.norm(np.asarray(gp["router"])) > 0
