"""A cell program across the devices of a mesh: four gloo ranks on the CPU
(``tests/torch_mesh_ranks.py``, one process a rank, started once a mesh)
against the one-process program and the reference.

llama3-8b's smoke config in float32 (``attn_chunk=8``), prefill of 4 x 32
tokens and one decode step of 4 requests over a 48-position cache of
seeded K/V (index 47), on three meshes over ``("data", "model")``:
``(4, 1)`` (FSDP and the batch over ``data``), ``(2, 2)`` and ``(1, 4)``
(heads, the MLP's width and the vocabulary over ``model``).  ``(1, 4)``
runs the config with ``n_kv_heads=4``: at its 2 kv heads a model axis of
4 would shard the cache over its sequence, which the port refuses (ROADMAP
Queue 1 A #8.3).

- the logits, gathered whole on every rank, against the one-process
  ``CellProgram.run`` on the same weights and inputs: within 1e-5 where
  the model axis is one device (no sum is reordered), within
  ``tests/test_torch_dryrun.py``'s serve limit of 1e-3 where the
  all-reduce over it reorders the products' f32 sums: the cache holds
  bf16, so a last-bit difference in K or V can round to the neighbouring
  bf16 value, which the prefill's next layers carry into the logits
  (1.9e-4 on (2, 2), 3.3e-4 on (1, 4), from 3 and 7 of 4,096 cache
  entries one bf16 step apart).  Against the reference's jitted
  ``CellProgram`` within 1e-3, but for the prefill at ``n_kv_heads=4``,
  held within ``FLIP_TOL``: there the one-process port already reads
  2.6e-3 from the reference, because one entry of the first layer's V
  (whose inputs both programs share) rounds to the neighbouring bf16
  value and the second layer carries it on (354 of its 8,192 entries
  then differ).  ``test_one_process_port_against_the_reference`` shows
  it: given the reference's rounding of that entry, the port reads 3.3e-6
  from the reference;
- the cache, gathered whole, within one bf16 step (``rtol=2**-7``) of the
  one-process program's and of the reference's (at the ``n_kv_heads=4``
  prefill, the second layer's within ``FLIP_TOL`` beyond that step);
- every rank's ``held_bytes()`` equal to ``argument_bytes()`` on the mesh;
- the collectives every rank issued equal to ``CellProgram.trace`` of the
  same cell on that mesh (kind, axes, name and bytes, in order);
- the planted faults (rank 0's query heads rolled by one head; the
  all-reduce after the attention's ``wo`` skipped, where the model axis
  has more than one device) move the logits by more than 0.1, a hundred
  times the limits (they read 1.8 to 5.2);
- all-gather, all-reduce and reduce-scatter on a known tensor.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

import torch
import torch_mesh_ranks as ranks_mod
from repro import configs as ref_configs
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import attention as attn_mod
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.collectives import tally
from repro_torch.parallel.sharding import Mesh, leaves

ARCH = "llama3_8b"
SHAPES = {"prefill": ShapeConfig("prefill_32k", 32, 4, "prefill"),
          "decode": ShapeConfig("decode_32k", 48, 4, "decode")}
# name -> (mesh, the config's n_kv_heads)
MESHES = {"4x1": (Mesh((4, 1), ("data", "model")), 2),
          "2x2": (Mesh((2, 2), ("data", "model")), 2),
          "1x4": (Mesh((1, 4), ("data", "model")), 4)}
ONE = Mesh((1, 1), ("data", "model"))
TOL = 1e-5          # against the one-process program (f32)
SERVE_TOL = 1e-3    # the serve limit (tests/test_torch_dryrun.py)
BF16_STEP = 2 ** -7  # one bf16 step, relative (the cache's dtype)
# the prefill at n_kv_heads=4 against the reference, logits and cache
# (beyond one bf16 step): one bf16 flip in the first layer's V carried on
# by the second (2.63e-3 and 3.45e-3 read; every other case within
# SERVE_TOL and one bf16 step)
FLIP_TOL = 5e-3
# the first layer's K/V entries that may round to the neighbouring bf16
# value between the port and the reference (one read at each kv count)
FIRST_LAYER_FLIPS = 2
SEED = 0


@functools.lru_cache(maxsize=None)
def _setup(kv: int):
    """The configs, the reference's weights, and the one-process port's
    and the reference's results of both steps at ``n_kv_heads=kv``."""
    over = dict(dtype="float32", attn_chunk=8, n_kv_heads=kv)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True), **over)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_build_model(ref_cfg).init_params(
            jax.random.PRNGKey(SEED)))
    one, ref = {}, {}
    for mode, shape in SHAPES.items():
        cell = steps.build_cell(cfg, shape, ONE)
        state = cell.materialize("cpu", SEED, model=params_from_numpy(
            tree, cfg, device="cpu"))
        if mode == "decode":
            ranks_mod.fill_cache(cell, state.args["cache"], SEED + 1)
        tok = state.args["tokens" if mode == "prefill" else "token"].numpy()
        ref_cache = _ref_cache(ref_cfg, cell, state.args["cache"])
        logits, cache = cell.run(state)
        one[mode] = (logits.numpy(), {p: t.float().numpy()
                                      for p, t in leaves(cache)})
        rc = _ref_cell(ref_cfg, shape)
        want, wcache = rc.jitted(tree, jnp.asarray(tok), ref_cache)
        ref[mode] = (np.asarray(want), {
            f"layers/{n}/{k}": np.asarray(v, np.float32)
            for n, layer in wcache["layers"].items()
            for k, v in layer.items()})
    return cfg, tree, one, ref


def _ref_cache(ref_cfg, cell, port_cache):
    """The reference's cache holding the port's (a buffer of its own a
    leaf: the program donates it)."""
    B, L = cell.shape.global_batch, cell.args["cache"]["layers"][
        "layer0"]["k"].shape[3]
    cache = ref_build_model(ref_cfg).init_cache(B, L)
    layers = {n: {k: jnp.asarray(t.float().numpy()).astype(
        cache["layers"][n][k].dtype) for k, t in layer.items()}
        for n, layer in port_cache["layers"].items()}
    return dict(cache, layers=layers,
                index=jnp.asarray(port_cache["index"], jnp.int32))


def _ref_cell(ref_cfg, shape):
    """The reference's ``CellProgram`` on its host mesh, the axes ``Auto``
    (as ``tests/test_torch_dryrun.py::_ref_cell``)."""
    ref_shape = ref_configs.ShapeConfig(*dataclasses.astuple(shape))
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return ref_steps.build_cell(ref_cfg, ref_shape, mesh)


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    """Every rank's results on one mesh (one spawn of its ranks)."""
    mesh, kv = MESHES[request.param]
    cfg, tree, one, ref = _setup(kv)
    out = ranks_mod.run_mesh(mesh, cfg, SHAPES, tree,
                             tmp_path_factory.mktemp(request.param), SEED)
    return dict(mesh=mesh, cfg=cfg, ranks=out, one=one, ref=ref)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _limit(run) -> float:
    return TOL if run["mesh"].shape["model"] == 1 else SERVE_TOL


def _ref_limit(kv: int, mode: str) -> float:
    return FLIP_TOL if (kv, mode) == (4, "prefill") else SERVE_TOL


@pytest.mark.parametrize("kv", [2, 4])
def test_one_process_port_against_the_reference(kv, monkeypatch):
    """The one-process prefill against the reference's, and the cause of
    their gap: the first layer's cache (the same inputs in both) differs
    in at most ``FIRST_LAYER_FLIPS`` entries, each one bf16 step, and
    with the reference's rounding of those entries the port's logits
    read within the serve limit of the reference's."""
    cfg, tree, one, ref = _setup(kv)
    logits, cache = one["prefill"]
    want, wcache = ref["prefill"]
    assert _err(logits, want) <= _ref_limit(kv, "prefill")
    flips = 0
    for n in ("k", "v"):
        a, b = cache[f"layers/layer0/{n}"][0], wcache[f"layers/layer0/{n}"][0]
        np.testing.assert_allclose(a, b, atol=TOL, rtol=BF16_STEP)
        flips += int((a != b).sum())
    assert flips <= FIRST_LAYER_FLIPS
    if _err(logits, want) > SERVE_TOL:
        assert flips > 0

    write = attn_mod.cache_update
    units = []

    def reference_rounding(layer_cache, k_new, v_new, index):
        write(layer_cache, k_new, v_new, index)
        if not units:                       # the first layer (unit 0)
            at = slice(index, index + k_new.shape[2])
            for n in ("k", "v"):
                layer_cache[n][:, :, at] = torch.from_numpy(
                    wcache[f"layers/layer0/{n}"][0][:, :, at])
        units.append(index)
        return layer_cache

    monkeypatch.setattr(attn_mod, "cache_update", reference_rounding)
    cell = steps.build_cell(cfg, SHAPES["prefill"], ONE)
    state = cell.materialize("cpu", SEED, model=params_from_numpy(
        tree, cfg, device="cpu"))
    got, _ = cell.run(state)
    assert len(units) == cfg.n_layers
    assert _err(got.numpy(), want) <= SERVE_TOL


@pytest.mark.parametrize("mode", list(SHAPES))
def test_logits_match_one_process_and_reference(run, mode):
    want, _ = run["one"][mode]
    ref, _ = run["ref"][mode]
    kv = run["cfg"].n_kv_heads
    for r in run["ranks"]:
        got = r[mode]["logits"]
        assert got.shape == want.shape
        assert _err(got, want) <= _limit(run)
        assert _err(got, ref) <= _ref_limit(kv, mode)


@pytest.mark.parametrize("mode", list(SHAPES))
def test_cache_matches_one_process_and_reference(run, mode):
    _, want = run["one"][mode]
    _, ref = run["ref"][mode]
    L = SHAPES[mode].seq_len
    flip = _ref_limit(run["cfg"].n_kv_heads, mode) - SERVE_TOL
    for r in run["ranks"]:
        assert r[mode]["index"] == L
        got = r[mode]["cache"]
        assert set(got) == set(want) == set(ref)
        for path, t in got.items():
            w, f = want[path], ref[path]
            np.testing.assert_allclose(t, w, atol=TOL, rtol=BF16_STEP)
            np.testing.assert_allclose(t, f, atol=TOL + flip,
                                       rtol=BF16_STEP, err_msg=path)


def test_every_rank_holds_the_argument_bytes(run):
    for r in run["ranks"]:
        for mode in SHAPES:
            assert r[mode]["held"] == r[mode]["want"], (r["rank"], mode)
            assert r[mode]["held"]["params"] > 0


def test_collectives_equal_the_meta_trace(run):
    mesh, cfg = run["mesh"], run["cfg"]
    for mode, shape in SHAPES.items():
        traced, flops = steps.build_cell(cfg, shape, mesh).trace()
        assert flops > 0
        counts = tally(traced)["counts"]
        n_layers = cfg.n_layers
        # FSDP gathers over data: 7 weights a layer, the embedding and the
        # head; all-reduces over model: wo twice a layer and the lookup
        assert counts["all-gather"] == (7 * n_layers + 2
                                        if mesh.shape["data"] > 1 else 0)
        assert counts["all-reduce"] == (2 * n_layers + 1
                                        if mesh.shape["model"] > 1 else 0)
        for r in run["ranks"]:
            assert r[mode]["records"] == traced, (r["rank"], mode)


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("fault", ranks_mod.FAULTS)
def test_planted_faults_exceed_the_limits(run, mode, fault):
    want, _ = run["one"][mode]
    got = run["ranks"][0][mode]["faults"][fault]
    err = _err(got, want)
    if fault == "no_wo_all_reduce" and run["mesh"].shape["model"] == 1:
        assert err <= TOL            # no all-reduce to skip
    else:
        assert err > 100 * SERVE_TOL, err


def test_collectives_on_a_known_tensor(run):
    mesh = run["mesh"]
    shape = mesh.shape
    base = np.arange(8.).reshape(4, 2)
    for r in run["ranks"]:
        c, probe = r["coords"], r["probe"]
        rank_of = {(d, m): d * shape["model"] + m
                   for d in range(shape["data"])
                   for m in range(shape["model"])}
        gathered = np.concatenate(
            [base + rank_of[d, c["model"]] for d in range(shape["data"])],
            axis=1)
        np.testing.assert_array_equal(probe["gather"], gathered)
        summed = sum(base + rank_of[c["data"], m]
                     for m in range(shape["model"]))
        np.testing.assert_array_equal(probe["reduce"], summed)
        total = sum(base + k for k in range(mesh.size))
        rows = 4 // mesh.size
        np.testing.assert_array_equal(
            probe["scatter"], total[r["rank"] * rows:(r["rank"] + 1) * rows])
        kinds = [x.kind for x in probe["records"]]
        assert kinds == [k for k, n in (
            ("all-gather", shape["data"]), ("all-reduce", shape["model"]),
            ("reduce-scatter", mesh.size)) if n > 1]
