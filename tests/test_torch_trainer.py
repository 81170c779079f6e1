"""The port's fault-tolerant ``Trainer`` on the CPU, mirroring
``tests/test_system.py``: the loss falls, a crash-restarted run equals
the uninterrupted run bit for bit (same data order, same updates, the
checkpoint restored exactly), an async-checkpointed run restores at its
last step, the straggler monitor runs.  Then the port's ``Trainer``
against the reference's over 10 steps from carried-across weights
(float32 compute): every loss within 1e-4, the final parameters within
1e-4 relative norm (float32 arithmetic in two libraries: the global norm
alone already differs by an ulp)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.models import build_model as jax_build
from repro.optim import adamw as jax_adamw
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.data.synthetic import DataConfig
from repro_torch.models.convert import load_params, params_to_numpy
from repro_torch.models.transformer import TrainModel
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

SPEC = dict(name="sys-test", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512)
CFG = ModelConfig(**SPEC, unit=(LayerSpec(kind="attn", ffn="dense"),))


def _trainer(tmp, steps=40, ckpt_every=10, ckpt_async=False, cfg=CFG,
             model=None):
    return Trainer(
        model or TrainModel(cfg, device="cpu", init=False),
        adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                          weight_decay=0.0),
        DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                      ckpt_async=ckpt_async, ckpt_dir=str(tmp)),
        device="cpu")


def test_training_reduces_loss(tmp_path):
    t = _trainer(tmp_path / "a")
    _, _, losses = t.run()
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_crash_restart_matches_uninterrupted_run(tmp_path):
    """Crash mid-run; the restarted run must match an uninterrupted run
    exactly, every parameter and the optimizer state, bit for bit."""
    t1 = _trainer(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="step 24"):
        t1.run(crash_at_step=24)
    t2 = _trainer(tmp_path / "crash")
    _, _, stream, start = t2.restore_or_init()
    assert start == 20 and stream.state() == {"seed": 0, "step": 20}
    t2 = _trainer(tmp_path / "crash")
    params_c, opt_c, losses_c = t2.run()
    assert len(losses_c) == 20

    t3 = _trainer(tmp_path / "ref")
    params_r, opt_r, losses_r = t3.run()
    assert losses_c == losses_r[20:]
    for name, p in params_r.items():
        assert torch.equal(params_c[name], p), name
        assert torch.equal(opt_c["m"][name], opt_r["m"][name]), name
        assert torch.equal(opt_c["v"][name], opt_r["v"][name]), name
    assert int(opt_c["step"]) == int(opt_r["step"]) == 40


def test_restore_is_what_was_saved(tmp_path):
    """The checkpoint a crash leaves holds the run's params, moments, step
    and stream position at its step, bit for bit."""
    t = _trainer(tmp_path / "s", steps=12, ckpt_every=6)
    params, opt, _ = t.run()
    saved = params_to_numpy(t.model)
    t2 = _trainer(tmp_path / "s", steps=12, ckpt_every=6)
    p2, o2, stream, start = t2.restore_or_init()
    assert start == 12 and stream.state()["step"] == 12
    for name, p in params.items():
        assert torch.equal(p2[name], p)
        assert torch.equal(o2["m"][name], opt["m"][name])
        assert torch.equal(o2["v"][name], opt["v"][name])
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 12
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(t2.model), saved)


def test_async_checkpointing_run(tmp_path):
    t = _trainer(tmp_path / "async", ckpt_async=True)
    _, _, losses = t.run()
    assert losses[-1] < losses[0]
    # a committed checkpoint exists and restores at the final step
    t2 = _trainer(tmp_path / "async")
    _, _, stream, start = t2.restore_or_init()
    assert start == 40


def test_straggler_monitor_runs(tmp_path):
    t = _trainer(tmp_path / "s", steps=12)
    t.run()
    assert len(t.step_times) == 12
    assert t.stragglers <= 3


def test_request_stop_commits_and_exits(tmp_path):
    t = _trainer(tmp_path / "stop", steps=40)
    t.request_stop()
    _, _, losses = t.run()
    assert len(losses) == 1
    assert _trainer(tmp_path / "stop").restore_or_init()[3] == 1


def test_losses_match_reference_trainer(tmp_path):
    jcfg = JaxModelConfig(**SPEC, unit=(JaxLayerSpec(kind="attn",
                                                     ffn="dense"),),
                          dtype="float32")
    cfg = dataclasses.replace(CFG, dtype="float32")
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

    port = _trainer(tmp_path / "port", steps=10, ckpt_every=10, cfg=cfg,
                    model=Carried(cfg, device="cpu", init=False))
    _, _, losses = port.run()
    np.testing.assert_allclose(losses, losses_r, rtol=0, atol=1e-4)
    got = params_to_numpy(port.model)
    want = jax.tree_util.tree_map(np.asarray, params_r)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(rel, got, want))
    assert max(errs) < 1e-4


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without ``device=`` the training entry points ask for the card; with
    none they raise, and nothing runs on the CPU instead."""
    from repro_torch.launch import train as train_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        TrainModel(CFG)
    with pytest.raises((RuntimeError, AssertionError)):
        train_cli.main(["--arch", "llama3-8b", "--smoke", "--steps", "2",
                        "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_step_builders(tmp_path):
    """``make_prefill_step`` / ``make_decode_step`` run the serving model;
    the dry run's pieces build the train cell on ``meta`` tensors, and its
    program's train step runs on the host mesh."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import Model
    cfg = get_config("llama3-8b", smoke=True)
    model = Model(cfg, device="cpu", seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    with torch.inference_mode():
        a, _ = steps.make_prefill_step(model)(toks, model.init_cache(2, 9))
        b, cache = model.prefill(toks, model.init_cache(2, 9))
        assert torch.equal(a, b)
        c, _ = steps.make_decode_step(model)(toks[:, :1], cache)
        assert c.shape == (2, cfg.padded_vocab)
    assert steps.cell_model_config(
        cfg, SHAPES["train_4k"]) is cfg
    from repro_torch.launch.mesh import make_host_mesh
    batch = steps.abstract_batch(cfg, SHAPES["train_4k"])
    assert set(steps.input_specs(cfg, SHAPES["train_4k"])) == {"batch"}
    assert {k: (t.device.type, tuple(t.shape)) for k, t in batch.items()} \
        == {k: ("meta", (256, 4096)) for k in ("tokens", "labels")}
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8,
                                global_batch=2)
    cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    state = cell.materialize("cpu", seed=0)
    _, opt_state, metrics = cell.run(state)
    assert int(opt_state["step"]) == 1
    assert torch.isfinite(metrics["loss"])
