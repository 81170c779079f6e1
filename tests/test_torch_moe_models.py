"""The MoE archs (granite-moe-3b-a800m, qwen3-moe-30b-a3b) through the
port's models on the CPU against the reference, at their smoke configs.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``.  Every MoE call's routing is recorded on both
sides (the reference's ``jax.lax.top_k`` through an ordered debug
callback, the port's ``moe.topk_stable``).  Tolerances:

- serving in float32: logits within 1e-3 (the bf16 KV cache turns a
  last-bit difference into a bf16 ulp, as for the dense archs);
- serving in bfloat16: logits within 5e-2 (bf16 rounds at other places
  in the two libraries);
- routing: the port takes the reference's choice of each call (its own
  gate values at those experts), and its own choice may differ only
  where the reference's smallest gap between neighbours of its k+1
  largest probabilities is under ``GAP_EPS``: 1e-5 in float32 (an ulp
  of a router logit), 2e-2 in bfloat16, where the router's input is
  itself a bf16 activation rounded at other places (the two sides'
  probabilities differ by up to ~6e-3 on these configs);
- ``train_loss`` and every gradient (the router's and the aux loss's
  included): float32 1e-5 (loss) and 1e-5 (relative norm), bfloat16
  5e-3 and 5e-2, as ``tests/test_torch_train_loss.py`` holds the dense
  archs;
- the ``Trainer``: 10 steps' losses within 1e-4 of the reference
  ``Trainer``'s, the final parameters within 1e-4 relative norm.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.models import build_model as jax_build
from repro.optim import adamw as jax_adamw
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.models import moe as pt_moe
from repro_torch.models.convert import (load_params, named_to_numpy,
                                        opt_state_from_numpy,
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b"]
GAP_EPS = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-3, 5e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, **over):
    over.setdefault("attn_chunk", 8)
    moe_over = over.pop("moe", None)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    if moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_over))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_over))
    return jcfg, cfg


def _tree(jm, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(seed)))


@pytest.fixture
def routing(monkeypatch):
    """Records every MoE call's ``(probs, expert ids)`` on each side, in
    order, and makes the port take the reference's choice of the same
    call (its own gate values at those ids), so that one near-tie cannot
    send the two runs apart: the reference runs each call first, the
    port then reads its record."""
    rec = {"ref": [], "port": []}
    top_k = jax.lax.top_k

    def ref_top_k(x, k):
        v, i = top_k(x, k)
        jax.debug.callback(lambda p, ii: rec["ref"].append(
            (np.asarray(p), np.asarray(ii))), x, i, ordered=True)
        return v, i

    stable = pt_moe.topk_stable

    def port_top_k(probs, k):
        _, own = stable(probs, k)
        rec["port"].append((probs.detach().numpy(), own.numpy()))
        jax.effects_barrier()
        ids = torch.from_numpy(rec["ref"][len(rec["port"]) - 1][1].copy())
        ids = ids.long()
        vals = probs.gather(-1, ids)
        return vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), ids

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(pt_moe, "topk_stable", port_top_k)
    return rec


def _check_flips(rec, eps: float) -> int:
    """The port's own top-k against the reference's, call by call: where
    they differ (in the set or the order) the reference's smallest gap
    between neighbours of its k+1 largest probabilities must be under
    ``eps``.  Returns
    the number of tokens whose choice differed."""
    assert len(rec["ref"]) == len(rec["port"]) > 0
    flips = 0
    for (pr, ir), (_, ip) in zip(rec["ref"], rec["port"]):
        differ = (ir != ip).any(axis=-1)
        k = ir.shape[-1]        # the order of the top k matters too
        s = np.sort(pr, axis=-1)[:, ::-1]
        gap = (s[:, :k] - s[:, 1:k + 1]).min(axis=-1)
        assert (gap[differ] < eps).all(), \
            f"routing differs where the reference's gap is {gap[differ]}"
        flips += int(differ.sum())
    return flips


# ---------------------------------------------------------------------------
# serving: prefill then decode, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, dtype, routing):
    jcfg, cfg = _configs(arch, dtype=dtype)
    jm = jax_build(jcfg)
    tree = _tree(jm)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = params_from_numpy(tree, cfg, device="cpu")
    B, S, steps = 2, 12, 4
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    jc, tc = jm.init_cache(B, S + steps), pm.init_cache(B, S + steps)
    lj, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompt), jc)
    with torch.inference_mode():
        lt, tc = pm.prefill(torch.from_numpy(prompt), tc)
    pairs = [(_np(lt), _np(lj))]
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(lj, axis=-1), np.int32)[:, None]
        lj, jc = decode(params, jnp.asarray(nxt), jc)
        with torch.inference_mode():
            lt, tc = pm.decode_step(torch.from_numpy(nxt.copy()), tc)
        pairs.append((_np(lt), _np(lj)))
    assert len(routing["port"]) == cfg.n_layers * (1 + steps)
    _check_flips(routing, GAP_EPS[dtype])
    tol = SERVE_TOL[dtype]
    for got, want in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 6e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_self_parity(arch, dtype, tol):
    """The port's prefill over ``k`` tokens against a prefill of ``S``
    then decode steps, with ``capacity_factor`` 8.0 so the prefill's
    capacity path drops nothing (``tests/test_models.py``'s parity; its
    6e-2 for bf16)."""
    _, cfg = _configs(arch, dtype=dtype, moe=dict(capacity_factor=8.0))
    m = Model(cfg, device="cpu", seed=1)
    B, S, extra = 2, 12, 4
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + extra)))
    with torch.inference_mode():
        last, cache = m.prefill(tok[:, :S], m.init_cache(B, S + extra))
        for i in range(extra):
            ref, _ = m.prefill(tok[:, :S + i], m.init_cache(B, S + extra))
            np.testing.assert_allclose(_np(last), _np(ref), rtol=tol,
                                       atol=tol)
            last, cache = m.decode_step(tok[:, S + i:S + i + 1], cache)


def test_prefill_takes_the_capacity_path_and_decode_the_dense_one():
    cfg = get_config("granite_moe_3b_a800m", smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    pt_moe.reset_counts()
    with torch.inference_mode():
        logits, cache = m.prefill(torch.zeros(2, 5, dtype=torch.int64),
                                  m.init_cache(2, 8))
        assert pt_moe.calls == {"capacity": cfg.n_layers, "dense": 0}
        m.decode_step(torch.zeros(2, 1, dtype=torch.int64), cache)
    assert pt_moe.calls == {"capacity": cfg.n_layers, "dense": cfg.n_layers}


# ---------------------------------------------------------------------------
# training: train_loss and every gradient, aux included
# ---------------------------------------------------------------------------

def _train_setup(arch, dtype, seed=0, **moe):
    jcfg, cfg = _configs(arch, dtype=dtype, moe=moe or None)
    jm = jax_build(jcfg)
    params = _tree(jm, seed)
    rng = np.random.default_rng(seed + 1)

    def nudge(a):        # norms off zero (1-D, or stacked 1-D)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == cfg.n_units):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map(nudge, params)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    return jm, params, cfg, {"tokens": toks, "labels": np.roll(toks, -1, 1)}


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


@pytest.mark.parametrize("dtype,aux_w", [("float32", 0.01),
                                         ("float32", 1.0),
                                         ("bfloat16", 0.01)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype, aux_w, routing):
    """Both without remat, so each side routes once a layer and the port
    takes the reference's choices (``routing``)."""
    jm, params, cfg, batch = _train_setup(arch, dtype,
                                          aux_loss_weight=aux_w)
    want_loss, want = jax.value_and_grad(
        functools.partial(jm.train_loss, remat=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.tree_util.tree_map(np.asarray, want)
    loss, grads = _port_loss_grads(params, cfg, batch, remat=False)
    assert len(routing["port"]) == cfg.n_layers
    _check_flips(routing, GAP_EPS[dtype])
    loss_tol, grad_tol = TRAIN_TOL[dtype]
    assert abs(loss - float(want_loss)) <= loss_tol
    errs = jax.tree_util.tree_map(_rel, grads, want)
    flat = jax.tree_util.tree_leaves_with_path(errs)
    assert len(flat) == len(jax.tree_util.tree_leaves(want))
    bad = {jax.tree_util.keystr(k): e for k, e in flat if not e <= grad_tol}
    assert not bad, f"gradients off by more than {grad_tol}: {bad}"
    assert np.linalg.norm(grads["units"]["layer0"]["moe"]["router"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_term_matches_reference(arch):
    """The loss with the aux term less the loss without it: the port's
    ``aux_loss_weight * sum(aux) / n_layers`` against the reference's."""
    diffs = {}
    for side in ("ref", "port"):
        losses = []
        for w in (0.0, 1.0):
            jm, params, cfg, batch = _train_setup(arch, "float32",
                                                  aux_loss_weight=w)
            if side == "ref":
                losses.append(float(jm.train_loss(
                    params, {k: jnp.asarray(v) for k, v in batch.items()})))
            else:
                losses.append(_port_loss_grads(params, cfg, batch)[0])
        diffs[side] = losses[1] - losses[0]
    assert 0.5 < diffs["ref"] < 4.0         # the layers' mean Switch aux
    assert abs(diffs["port"] - diffs["ref"]) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_equals_no_remat(dtype):
    _, params, cfg, batch = _train_setup("granite_moe_3b_a800m", dtype,
                                         seed=3)
    a_loss, a = _port_loss_grads(params, cfg, batch, remat=True)
    b_loss, b = _port_loss_grads(params, cfg, batch, remat=False)
    assert a_loss == b_loss
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_train_init_matches_serving_model_of_the_seed():
    """``TrainModel.init_params`` draws in ``Model``'s order, router
    included: a serving model of the same seed holds the masters cast."""
    cfg = get_config("granite_moe_3b_a800m", smoke=True)
    t = TrainModel(cfg, device="cpu", seed=4)
    s = Model(cfg, device="cpu", seed=4)
    got = dict(s.named_parameters())
    for name, p in t.named_parameters():
        want = p.detach() if name == "final_norm" else \
            p.detach().to(torch.bfloat16)
        assert got[name].dtype == want.dtype and torch.equal(got[name],
                                                             want), name
    assert t.units[1]["layer0"].moe["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the converters, the Trainer and the CLIs
# ---------------------------------------------------------------------------

def test_convert_carries_moe_leaves_both_ways():
    jcfg, cfg = _configs("qwen3_moe_30b_a3b", dtype="float32")
    tree = _tree(jax_build(jcfg))
    m = params_from_numpy(tree, cfg, device="cpu", train=True)
    back = params_to_numpy(m)
    assert sorted(back["units"]["layer0"]["moe"]) == ["router", "wi_gate",
                                                      "wi_up", "wo"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    opt = {"m": tree, "v": tree, "step": np.asarray(3, np.int32)}
    state = opt_state_from_numpy(opt, m)
    assert state["m"]["units.1.layer0.moe.wi_up"].shape == (8, 64, 96)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           opt_state_to_numpy(state, m), opt)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["units"]["layer0"]["moe"]["gate_bias"] = np.zeros((2, 8), np.float32)
    with pytest.raises(KeyError, match="gate_bias"):
        params_from_numpy(bad, cfg, device="cpu")
    short = jax.tree_util.tree_map(lambda a: a, tree)
    del short["units"]["layer0"]["moe"]["router"]
    with pytest.raises(KeyError, match="router"):
        load_params(Model(cfg, device="cpu", init=False), short)


def test_trainer_matches_reference_trainer(tmp_path):
    """granite-moe's smoke config in float32: 10 steps of the port's
    ``Trainer`` from the reference ``Trainer``'s initial weights."""
    jcfg, cfg = _configs("granite_moe_3b_a800m", dtype="float32",
                         attn_chunk=1024)
    ref = JaxTrainer(
        jax_build(jcfg),
        jax_adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10,
                              weight_decay=0.0),
        JaxDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4),
        JaxTrainerConfig(total_steps=10, ckpt_every=10,
                         ckpt_dir=str(tmp_path / "ref")))
    params_r, _, losses_r = ref.run()
    tree = jax.tree_util.tree_map(np.asarray, ref.init_state(0)[0])

    class Carried(TrainModel):
        def init_params(self, seed):
            load_params(self, tree)
            return self.param_dict()

    port = Trainer(
        Carried(cfg, device="cpu", init=False),
        adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10,
                          weight_decay=0.0),
        DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4),
        TrainerConfig(total_steps=10, ckpt_every=10,
                      ckpt_dir=str(tmp_path / "port")), device="cpu")
    _, _, losses = port.run()
    np.testing.assert_allclose(losses, losses_r, rtol=0, atol=1e-4)
    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _rel, params_to_numpy(port.model),
        jax.tree_util.tree_map(np.asarray, params_r)))
    assert max(errs) < 1e-4


def test_clis_run_granite_moe_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    serve_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                    "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    admitted = int(out[0].split()[1].split("/")[0])
    assert out[0].startswith("admitted ") and admitted > 0
    assert out[1].startswith(f"generated ({admitted}, 8) tokens")
    losses = train_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                             "--steps", "4", "--seq-len", "32",
                             "--global-batch", "2", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 4 and np.isfinite(losses).all()
