"""The port's AdamW (``repro_torch.optim.adamw``) on the CPU against the
reference's ``repro.optim.adamw``.

``lr_schedule`` over warm-up, cosine and the tail; ``update`` over 10
steps of seeded gradients (alternately small and above the clip) for
each compression (``none``, ``bf16``, ``int8_ef``), comparing params,
``m``, ``v``, ``ef``, ``step``, ``lr`` and ``grad_norm`` after every
step.  ``lr`` and ``step`` are exact.  The global norm sums the squares
in another order than XLA and reads one float32 ulp apart (1.2e-7
relative), which moves the clipped gradients by an ulp: the rest is held
to rtol 1e-5 and atol 1e-6 (under ``bf16`` compression the rounding
absorbs that ulp and the states read exactly equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.optim import adamw as pt_adamw

SHAPES = {"a": (16, 8), "b": (8,), "c": (3, 5, 2)}    # sorted: tree order
RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 7, 10, 12])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=3, total_steps=10)
    want = jax_adamw.lr_schedule(jax_adamw.AdamWConfig(**kw),
                                 jnp.asarray(step, jnp.int32))
    got = pt_adamw.lr_schedule(pt_adamw.AdamWConfig(**kw),
                               torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
def test_update_matches_reference_over_ten_steps(compression):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10,
              compression=compression)
    jc, pc = jax_adamw.AdamWConfig(**kw), pt_adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ps = jax_adamw.init_state(jc, jp), pt_adamw.init_state(pc, pp)
    assert sorted(ps) == sorted(js)
    for step in range(10):
        g = {k: (rng.standard_normal(s) * (3.0 if step % 2 else 0.2))
             .astype(np.float32) for k, s in SHAPES.items()}
        jp, js, ji = jax_adamw.update(
            jc, {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pp, ps, pi = pt_adamw.update(
            pc, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, ps,
            pp)
        assert int(ps["step"]) == int(js["step"]) == step + 1
        assert ps["step"].dtype == torch.int32
        assert float(pi["lr"]) == float(ji["lr"])
        _close(pi["grad_norm"], ji["grad_norm"])
        for k in SHAPES:
            _close(pp[k], jp[k])
            for part in ("m", "v") + (("ef",) if compression == "int8_ef"
                                      else ()):
                _close(ps[part][k], js[part][k])
        if compression == "bf16":
            for k in SHAPES:
                np.testing.assert_array_equal(pp[k].numpy(),
                                              np.asarray(jp[k]))


def test_unknown_compression_raises():
    cfg = pt_adamw.AdamWConfig(compression="fp8")
    p = {"a": torch.zeros(2)}
    with pytest.raises(ValueError, match="fp8"):
        pt_adamw.update(cfg, {"a": torch.ones(2)},
                        pt_adamw.init_state(cfg, p), p)
