"""The recurrent archs, xlstm-125m (mLSTM + sLSTM units, ``ffn="none"``) and
jamba-v0.1-52b (Mamba beside attention, MoE on the odd layers), through
the port's models on the CPU against the reference, at their smoke
configs.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``.  Jamba's MoE calls are recorded on both sides
and the port takes the reference's choice of each call
(``test_torch_moe_models.routing``; its own may differ only at near-ties
under ``GAP_EPS``).  Tolerances:

- serving in float32: logits within 1e-3 (jamba's attention layer keeps
  a bf16 KV cache, which turns a last-bit difference into a bf16 ulp, as
  for the dense archs; xlstm's states are float32 and read ~1e-6);
- serving in bfloat16: logits within 5e-2 (bf16 rounds at other places in
  the two libraries, as for the dense and MoE archs); jamba's within 0.2:
  its eight layers (Mamba, attention, MoE and MLP) round in bf16 far
  more than the dense archs' two, and the reference's own jitted run
  (the one compared, where XLA's fusion drops roundings) and its
  op-by-op run of the same weights and tokens differ by up to 0.158 in a
  logit (the port's readings: 0.162 from the jitted run, 0.123 from the
  op-by-op one);
- ``train_loss`` and every gradient: float32 1e-5 (loss) and 1e-4
  (relative norm: the recurrences' backward sums over the sequence in
  another order, as ``tests/test_torch_xlstm.py`` and
  ``tests/test_torch_ssm.py`` hold the blocks), bfloat16 5e-3 and 5e-2;
  jamba's bf16 loss within 1e-2, half the reference's own bf16-float32
  gap of 0.019 (the port's reading: 6.6e-3), and its bf16 gradients
  within 0.15: the reference's gradients as run and op-by-op differ by
  up to 0.099 (median 0.057) in relative norm (the port's reading:
  0.102);
- mLSTM's ``b_i``: its gradient within 1e-2.  The block's output does not
  move when a head's input-gate preactivations all shift (the shift
  cancels between numerator and denominator) except where the floor
  ``exp(-m)`` binds, so the gradient is a sum that cancels to ~1e-3 of
  its terms: float32 evaluations of both libraries lie 1e-3 from a
  float64 one of the same block (port 1.5e-3, reference 9.7e-4);
- the ``Trainer``: 10 steps' losses within 1e-4 of the reference
  ``Trainer``'s, the final parameters within 1e-4 relative norm (mLSTM's
  ``b_i`` within 1e-2: AdamW normalizes that rounding-dominated
  gradient, so each step moves it by up to the learning rate in a
  direction the rounding picks).
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
from repro.models.transformer import _cast_params
from repro.optim import adamw as jax_adamw
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.models.convert import (load_params, named_to_numpy,
                                        opt_state_from_numpy,
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy,
                                        ref_key)
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig
from test_torch_moe_models import GAP_EPS, _check_flips, routing  # noqa: F401

ARCHS = ["xlstm_125m", "jamba_v01_52b"]
SERVE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-3, 5e-2)}
JAMBA_BF16 = {"serve": 0.2, "loss": 1e-2, "grad": 0.15}
B_I_TOL = 1e-2          # mLSTM's input-gate bias (see above)


def _leaf_tol(path: str, tol: float) -> float:
    return B_I_TOL if "mlstm" in path and "b_i" in path else tol


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


def _nudged(tree, cfg, seed):
    """Every 1-D leaf (stacked: ``[n_units, d]``) moved off its constant,
    so a missed cast or a constant the port makes itself shows."""
    rng = np.random.default_rng(seed + 1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == cfg.n_units):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(nudge, tree)


def _tree(jm, cfg, seed=0):
    return _nudged(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(seed))), cfg, seed)


# ---------------------------------------------------------------------------
# serving: prefill then decode, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, dtype, routing):
    jcfg, cfg = _configs(arch, dtype=dtype)
    jm = jax_build(jcfg)
    tree = _tree(jm, cfg)
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
    n_moe = sum(s.ffn == "moe" for s in cfg.unit) * cfg.n_units
    assert len(routing["port"]) == n_moe * (1 + steps)
    if n_moe:
        _check_flips(routing, GAP_EPS[dtype])
    tol = SERVE_TOL[dtype]
    if arch == "jamba_v01_52b" and dtype == "bfloat16":
        tol = JAMBA_BF16["serve"]
    for got, want in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the recurrent states the decode steps leave, against the reference's
    for name, c in tc["layers"].items():
        for k, t in c.items():
            if k in ("k", "v"):
                continue
            want = np.asarray(jc["layers"][name][k])
            assert t.shape == want.shape and t.dtype == torch.float32
            err = np.abs(t.numpy() - want).max() / max(1.0, np.abs(want)
                                                        .max())
            assert err <= (1e-4 if dtype == "float32" else 5e-2), (name, k)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 6e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_self_parity(arch, dtype, tol):
    """The port's prefill over ``k`` tokens against a prefill of ``S``
    then decode steps, with ``capacity_factor`` 8.0 for jamba so the
    prefill's capacity path drops nothing (``tests/test_models.py``'s
    parity; its 6e-2 for bf16)."""
    _, cfg = _configs(arch, dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_holds_one_state_a_unit_position(arch):
    """Attention positions hold the bf16 KV pair, recurrent ones the
    reference's state shapes, each stacked over the units."""
    jcfg, cfg = _configs(arch)
    want = jax_build(jcfg).init_cache(2, 16)["layers"]
    got = Model(cfg, device="cpu", init=False).init_cache(2, 16)["layers"]
    assert sorted(got) == sorted(want)
    for name, c in want.items():
        assert sorted(got[name]) == sorted(c), name
        for k, v in c.items():
            assert tuple(got[name][k].shape) == v.shape, (name, k)
            np.testing.assert_array_equal(_np(got[name][k]), _np(v))


# ---------------------------------------------------------------------------
# the serving cast
# ---------------------------------------------------------------------------

def _leaf(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_model_holds_cast_params(arch):
    """Every serving parameter equals ``_cast_params`` of a nudged bf16
    reference tree, bit for bit and dtype for dtype: the gate biases,
    ``out_norm``, ``a_log``, ``dt_proj_b`` (-4.6, which rounds in bf16),
    ``d_skip`` and ``conv_b`` are unit leaves, stacked and so cast."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    tree = _nudged(jax_build(jcfg).init_params(jax.random.PRNGKey(0)), cfg,
                   0)
    want = _cast_params(tree, jnp.bfloat16)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg,
                              device="cpu")
    names = dict(model.named_parameters())
    n_unit = len(jax.tree_util.tree_leaves(tree["units"]))
    assert len(names) == len(jax.tree_util.tree_leaves(tree)) + \
        (cfg.n_units - 1) * n_unit
    for name, p in names.items():
        key, unit = ref_key(name)
        w = _leaf(want, key)
        w = w[unit] if unit >= 0 else w
        assert str(p.dtype).split(".")[1] == str(w.dtype), name
        assert np.array_equal(p.detach().float().numpy(),
                              np.asarray(w.astype(jnp.float32))), name
    assert model.final_norm.dtype == torch.float32
    if arch == "jamba_v01_52b":
        b = model.units[0]["layer0"].mamba["dt_proj_b"]
        assert b.dtype == torch.bfloat16
        assert float(b.float().mean()) != pytest.approx(-4.6, abs=1e-3)
    else:
        assert not hasattr(model.units[0]["layer0"], "ln2")


# ---------------------------------------------------------------------------
# training: train_loss and every gradient
# ---------------------------------------------------------------------------

def _train_setup(arch, dtype, seed=0):
    jcfg, cfg = _configs(arch, dtype=dtype)
    jm = jax_build(jcfg)
    params = _tree(jm, cfg, seed)
    rng = np.random.default_rng(seed + 1)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype, routing):
    """Both without remat, so each side routes once a layer and the port
    takes the reference's choices (``routing``)."""
    jm, params, cfg, batch = _train_setup(arch, dtype)
    want_loss, want = jax.value_and_grad(
        functools.partial(jm.train_loss, remat=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.tree_util.tree_map(np.asarray, want)
    loss, grads = _port_loss_grads(params, cfg, batch, remat=False)
    n_moe = sum(s.ffn == "moe" for s in cfg.unit) * cfg.n_units
    assert len(routing["port"]) == n_moe
    if n_moe:
        _check_flips(routing, GAP_EPS[dtype])
    loss_tol, grad_tol = TRAIN_TOL[dtype]
    if arch == "jamba_v01_52b" and dtype == "bfloat16":
        loss_tol, grad_tol = JAMBA_BF16["loss"], JAMBA_BF16["grad"]
    assert abs(loss - float(want_loss)) <= loss_tol
    errs = jax.tree_util.tree_map(_rel, grads, want)
    flat = [(jax.tree_util.keystr(k), e)
            for k, e in jax.tree_util.tree_leaves_with_path(errs)]
    assert len(flat) == len(jax.tree_util.tree_leaves(want))
    bad = {k: e for k, e in flat if not e <= _leaf_tol(k, grad_tol)}
    assert not bad, f"gradients off by more than {grad_tol}: {bad}"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    _, params, cfg, batch = _train_setup(arch, "bfloat16", seed=3)
    if cfg.moe is not None:        # no near-tie can route the two apart
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    a_loss, a = _port_loss_grads(params, cfg, batch, remat=True)
    b_loss, b = _port_loss_grads(params, cfg, batch, remat=False)
    assert a_loss == b_loss
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_init_matches_serving_model_of_the_seed(arch):
    """``TrainModel.init_params`` draws in ``Model``'s order: a serving
    model of the same seed holds the masters cast, the constants
    (``b_f`` 3, ``dt_proj_b`` -4.6, ``a_log``, ``d_skip``) included."""
    cfg = get_config(arch, smoke=True)
    t = TrainModel(cfg, device="cpu", seed=4)
    s = Model(cfg, device="cpu", seed=4)
    got = dict(s.named_parameters())
    assert sorted(got) == sorted(n for n, _ in t.named_parameters())
    for name, p in t.named_parameters():
        want = p.detach() if name == "final_norm" else \
            p.detach().to(torch.bfloat16)
        assert got[name].dtype == want.dtype and torch.equal(got[name],
                                                             want), name
        assert p.dtype == torch.float32


# ---------------------------------------------------------------------------
# the converters, the Trainer and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,group,leaf", [
    ("xlstm_125m", "slstm", "r_o"), ("jamba_v01_52b", "mamba", "a_log")])
def test_convert_carries_the_leaves_both_ways(arch, group, leaf):
    jcfg, cfg = _configs(arch, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    m = params_from_numpy(tree, cfg, device="cpu", train=True)
    back = params_to_numpy(m)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    opt = {"m": tree, "v": tree, "step": np.asarray(3, np.int32)}
    state = opt_state_from_numpy(opt, m)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           opt_state_to_numpy(state, m), opt)
    layer = "layer1" if group == "slstm" else "layer0"
    assert f"units.0.{layer}.{group}.{leaf}" in state["m"]
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["units"][layer][group]["gate_bias"] = np.zeros((cfg.n_units, 4),
                                                       np.float32)
    with pytest.raises(KeyError, match="gate_bias"):
        params_from_numpy(bad, cfg, device="cpu")
    extra_ln2 = jax.tree_util.tree_map(lambda a: a, tree)
    if arch == "xlstm_125m":    # ffn="none": a layer with ln2 is refused
        extra_ln2["units"]["layer0"]["ln2"] = np.zeros(
            (cfg.n_units, cfg.d_model), np.float32)
        with pytest.raises(KeyError, match="ln2"):
            params_from_numpy(extra_ln2, cfg, device="cpu")
    short = jax.tree_util.tree_map(lambda a: a, tree)
    del short["units"][layer][group][leaf]
    with pytest.raises(KeyError, match=leaf):
        load_params(Model(cfg, device="cpu", init=False), short)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_trainer(arch, tmp_path):
    """The smoke config in float32: 10 steps of the port's ``Trainer``
    from the reference ``Trainer``'s initial weights."""
    jcfg, cfg = _configs(arch, dtype="float32", attn_chunk=1024)
    if cfg.moe is not None:        # no near-tie can route the two apart
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    ref = JaxTrainer(
        jax_build(jcfg),
        jax_adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10,
                              weight_decay=0.0),
        JaxDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4),
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
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4),
        TrainerConfig(total_steps=10, ckpt_every=10,
                      ckpt_dir=str(tmp_path / "port")), device="cpu")
    _, _, losses = port.run()
    np.testing.assert_allclose(losses, losses_r, rtol=0, atol=1e-4)
    errs = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        _rel, params_to_numpy(port.model),
        jax.tree_util.tree_map(np.asarray, params_r)))
    bad = {jax.tree_util.keystr(k): e for k, e in errs
           if not e < _leaf_tol(jax.tree_util.keystr(k), 1e-4)}
    assert not bad, bad


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_clis_run_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    admitted = int(out[0].split()[1].split("/")[0])
    assert out[0].startswith("admitted ") and admitted > 0
    assert out[1].startswith(f"generated ({admitted}, 8) tokens")
    losses = train_cli.main(["--arch", arch, "--smoke", "--steps", "4",
                             "--seq-len", "32", "--global-batch", "2",
                             "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 4 and np.isfinite(losses).all()
