"""The port's abstract cell specs, cell programs and dry run
(``repro_torch.launch.{steps,dryrun,report}``) against the reference's
(``repro.launch.{steps,dryrun}``), on the CPU.

- ``abstract_batch`` / ``input_specs``: every leaf's shape and dtype equal
  to the reference's for every arch x shape at the published sizes (the
  reference's 0-d cache ``index`` is the int 0 in the port);
- ``run_cell``: every cell at both production meshes and the host mesh,
  every spec dividing (``argument_bytes`` raises otherwise, as a spec
  that does not divide shows); the traced FLOPs and collectives filled
  for the dense archs' prefill and decode where no cache spec shards the
  sequence, null with the ROADMAP item that would run them everywhere
  else, the compiler's fields null with the reason; llama3-8b's
  ``decode_32k`` all-reduces on ``(32, 8)`` against a hand reckoning and
  its ``prefill_32k`` FSDP all-gather bytes against the gathered
  weights' shapes;
- ``moe_groups``: the port's model with ``hints={"moe_groups": 4}``
  against the reference's with the same hints at granite-moe's smoke
  config in float32 (prefill logits within 1e-5), the groups reaching
  ``apply_moe``;
- ``build_cell``'s prefill, decode and train steps at llama3-8b's and
  granite-moe's smoke configs (float32) on the host mesh against the
  reference's jitted ``CellProgram`` with the same weights
  (``models/convert.py``) and inputs (its host mesh's axes ``Auto``,
  see ``_ref_cell``): serve logits within 1e-3 (the bf16
  KV cache turns a last-bit difference into a bf16 ulp, as in
  ``tests/test_torch_models.py``), the train step's loss within 1e-4 (as
  ``tests/test_torch_trainer.py``) and its gradient norm within 1e-4
  relative;
- a materialized cell holds exactly the dry run's per-device argument
  bytes; what a mesh of more than one device does not run yet refuses,
  naming its ROADMAP item (``tests/test_torch_multicard.py`` runs what it
  does).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as ref_configs
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, report, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import moe as pt_moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.parallel.collectives import KINDS, tally
from repro_torch.parallel.group import MeshGroup
from repro_torch.parallel.sharding import Mesh, leaves

CELL_ARCHS = ["llama3_8b", "granite_moe_3b_a800m"]
# the small cells: prefill 2 x 32 tokens, decode 2 requests over 48
# positions, train 2 x 32 tokens
SMALL = {"prefill": ShapeConfig("prefill_32k", 32, 2, "prefill"),
         "decode": ShapeConfig("decode_32k", 48, 2, "decode"),
         "train": ShapeConfig("train_4k", 32, 2, "train")}
SERVE_TOL = 1e-3
LOSS_TOL = 1e-4


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def _port_flat(tree):
    return dict(leaves(tree if isinstance(tree, dict) else {"": tree}))


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_batch_and_input_specs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in shapes_for(cfg):
        ref_shape = ref_configs.SHAPES[shape.name]
        pairs = [(steps.abstract_batch(cfg, shape),
                  ref_steps.abstract_batch(ref_cfg, ref_shape))]
        got = steps.input_specs(cfg, shape)
        want = ref_steps.input_specs(ref_cfg, ref_shape)
        assert set(got) == set(want), shape.name
        if "cache" in want:
            assert got["cache"]["index"] == 0
            assert want["cache"]["index"].shape == ()
            want = dict(want, cache={k: v for k, v in want["cache"].items()
                                     if k != "index"})
        pairs.append((got, want))
        for g, w in pairs:
            g, w = _port_flat(g), _flat(w)
            assert set(g) == set(w), (shape.name, set(g) ^ set(w))
            for path, t in g.items():
                assert t.device.type == "meta"
                assert (tuple(t.shape), _dtype_name(t)) == \
                    (w[path].shape, str(w[path].dtype)), (shape.name, path)


@pytest.mark.parametrize("mesh", ["single", "multi", "host"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_every_cell(arch, mesh):
    cfg = get_config(arch)
    for shape in shapes_for(cfg):
        rep = dryrun.run_cell(arch, shape.name, mesh, write=False,
                              device="cpu")       # every spec divides
        b = rep["argument_bytes_per_device"]
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
        assert b["params"] > 0 and (b["opt_state"] > 0) == \
            (shape.mode == "train") and (b["cache"] > 0) == \
            (shape.mode != "train")
        assert rep["n_devices"] == {"single": 256, "multi": 512,
                                    "host": 1}[mesh]
        mcfg = steps.cell_model_config(cfg, shape)
        per = {"train": 6 * shape.seq_len, "prefill": 2 * shape.seq_len,
               "decode": 2}[shape.mode]
        assert rep["model_flops_global"] == \
            per * mcfg.n_active_params * shape.global_batch
        assert rep["roofline"]["argument_bytes_at_hbm_s"] == \
            b["total"] / 3.35e12
        a = rep["accounting"]
        why = a["null_because"]
        assert a["temp_bytes"] is None and a["bytes_accessed_per_device"] \
            is None and why["temp_bytes"] == dryrun.NO_COMPILER
        # the serving cells of the dense, MoE and hybrid archs, but where
        # the kv heads do not split over the production meshes' model
        # axis of 8 (glm4-9b's 2, qwen3-moe's 4)
        traced = cfg.family in ("dense", "moe", "hybrid") and \
            shape.mode != "train" and not (
                arch in ("glm4_9b", "qwen3_moe_30b_a3b") and mesh != "host")
        fields = ("flops_per_device", "collective_bytes_per_device",
                  "collective_counts", "collective_total_bytes_per_device")
        if traced:
            assert a["flops_per_device"] > 0
            assert set(a["collective_counts"]) == set(KINDS)
            assert a["collective_total_bytes_per_device"] == sum(
                a["collective_bytes_per_device"].values())
            assert (a["collective_total_bytes_per_device"] > 0) == \
                (mesh != "host")
            assert not set(fields) & set(why)
        else:
            assert all(a[k] is None and "ROADMAP Queue 1 A #8." in why[k]
                       for k in fields), (arch, shape.name, why)
    assert rep["params_dtype"] == ("bfloat16" if rep["mode"] != "train"
                                   else "float32")


def test_jamba_does_not_fit_one_card():
    """jamba-v0.1 at 32 layers: 103 GB of bf16 weights a card."""
    rep = dryrun.run_cell("jamba-v0.1-52b", "prefill_32k", "host",
                          write=False, device="cpu")
    assert rep["argument_bytes_per_device"]["params"] > 100e9


def test_dryrun_cli_and_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(report, "OUT_DIR", tmp_path)
    assert dryrun.main(["--arch", "llama3-8b", "--mesh", "host",
                        "--device", "cpu"]) == 0
    assert dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape",
                        "decode_32k", "--mesh", "both"]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["granite_moe_3b_a800m_decode_32k_mp.json",
                     "granite_moe_3b_a800m_decode_32k_sp.json",
                     "llama3_8b_decode_32k_host.json",
                     "llama3_8b_prefill_32k_host.json",
                     "llama3_8b_train_4k_host.json"]
    rep = json.loads((tmp_path / names[-1]).read_text())
    assert rep["mesh"] == "host_1x1" and \
        rep["accounting"]["temp_bytes"] is None
    capsys.readouterr()
    report.main()
    out = capsys.readouterr().out
    assert "args fit 80.0 GB (H100 data sheet)" in out
    rows = [line for line in out.splitlines()
            if line.startswith("| llama3-8b | train_4k")]
    assert len(rows) == 2 and "| NO |" in rows[0]      # 96 GB of arguments
    assert "| - |" in rows[0]


# ---------------------------------------------------------------------------
# the programs against the reference's
# ---------------------------------------------------------------------------

def _configs(arch, **over):
    over = dict(dtype="float32", attn_chunk=8, **over)
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _tree(ref_cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_build_model(ref_cfg).init_params(
            jax.random.PRNGKey(seed)))


def _tokens(cfg, *shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _fill(ref_cache, port_cache, index, seed=2):
    """The same seeded K/V (rounded to the cache's bf16) in both caches,
    and the write index at ``index``; returns the reference's."""
    rng = np.random.default_rng(seed)
    layers = {}
    for name, layer in port_cache["layers"].items():
        layers[name] = {}
        for k, t in layer.items():
            x = rng.standard_normal(tuple(t.shape), dtype=np.float32)
            t.copy_(torch.from_numpy(x))
            layers[name][k] = jnp.asarray(x).astype(
                ref_cache["layers"][name][k].dtype)
    port_cache["index"] = index
    return dict(ref_cache, layers=layers,
                index=jnp.asarray(index, jnp.int32))


def _ref_cell(ref_cfg, mode):
    """The reference's ``CellProgram`` on its host mesh's devices, the
    mesh's axes ``Auto``: jax 0.9.0's ``make_mesh`` makes them
    ``Explicit`` by default, where the reference's activation hints
    (``with_sharding_constraint``) are refused."""
    ref_shape = ref_configs.ShapeConfig(*dataclasses.astuple(SMALL[mode]))
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return ref_steps.build_cell(ref_cfg, ref_shape, mesh)


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_prefill_cell_matches_reference(arch):
    ref_cfg, cfg = _configs(arch)
    tree = _tree(ref_cfg)
    shape = SMALL["prefill"]
    B, S = shape.global_batch, shape.seq_len
    tok = _tokens(cfg, B, S)
    rc = _ref_cell(ref_cfg, "prefill")
    # a buffer of its own a leaf: the program donates the cache
    cache = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                   ref_build_model(rc.cfg).init_cache(B, S))
    want, _ = rc.jitted(tree, jnp.asarray(tok), cache)
    cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    assert cell.hints == cell.rules.activation_hints(
        B, S, use_seq_sharding=False)
    state = cell.materialize("cpu", model=params_from_numpy(
        tree, cfg, device="cpu"))
    state.args["tokens"] = torch.from_numpy(tok)
    got, cache = cell.run(state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    assert cache["index"] == S and cache is state.args["cache"]


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_decode_cell_matches_reference(arch):
    """One decode step from a cache of seeded K/V at its last position
    (index L - 1: the step writes it and attends over all L)."""
    ref_cfg, cfg = _configs(arch)
    tree = _tree(ref_cfg)
    shape = SMALL["decode"]
    B, L = shape.global_batch, shape.seq_len
    tok = _tokens(cfg, B, 1)
    cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    state = cell.materialize("cpu", model=params_from_numpy(
        tree, cfg, device="cpu"))
    rc = _ref_cell(ref_cfg, "decode")
    ref_cache = _fill(ref_build_model(rc.cfg).init_cache(B, L),
                      state.args["cache"], L - 1)
    want, _ = rc.jitted(tree, jnp.asarray(tok), ref_cache)
    state.args["token"] = torch.from_numpy(tok)
    got, cache = cell.run(state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    assert cache["index"] == L


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_train_cell_matches_reference(arch):
    ref_cfg, cfg = _configs(arch)
    tree = _tree(ref_cfg)
    shape = SMALL["train"]
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _tokens(cfg, B, S), "labels": _tokens(cfg, B, S,
                                                              seed=3)}
    rc = _ref_cell(ref_cfg, "train")
    opt = ref_adamw.init_state(ref_adamw.AdamWConfig(), tree)
    _, _, want = rc.jitted(tree, opt, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    assert cell.hints["act"] == ("data", "model", None)   # sequence-sharded
    state = cell.materialize("cpu", model=params_from_numpy(
        tree, cfg, device="cpu", train=True))
    state.args["batch"] = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = {k: p.detach().clone() for k, p in state.args["params"].items()}
    params, opt_state, got = cell.run(state)
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)
    assert float(got["lr"]) == float(want["lr"])
    assert int(opt_state["step"]) == 1
    assert all(not torch.equal(before[k], p) for k, p in params.items()
               if p.dim() > 1)


def test_moe_groups_reach_apply_moe(monkeypatch):
    """granite-moe's smoke config at capacity factor 0.5 (so capacity
    drops tokens): the port's prefill with ``hints={"moe_groups": 4}``
    against the reference's with the same hints (no sharding entries),
    float32 logits within 1e-5; the groups reach every ``apply_moe``
    call, and drop other tokens than one group does."""
    arch = "granite_moe_3b_a800m"
    moe = dict(capacity_factor=0.5)
    ref_cfg, cfg = _configs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, **moe))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    tree = _tree(ref_cfg)
    B, S = 2, 32
    tok = _tokens(cfg, B, S)
    ref_model = ref_build_model(ref_cfg)
    ref_model.hints = {"moe_groups": 4}
    want, _ = jax.jit(ref_model.prefill)(tree, jnp.asarray(tok),
                                         ref_model.init_cache(B, S))
    seen = []
    apply_moe = pt_moe.apply_moe

    def spy(*a, **kw):
        seen.append(kw.get("groups"))
        return apply_moe(*a, **kw)

    monkeypatch.setattr(pt_moe, "apply_moe", spy)
    model = params_from_numpy(tree, cfg, device="cpu")
    model.hints = {"moe_groups": 4}
    with torch.inference_mode():
        got, _ = model.prefill(torch.from_numpy(tok), model.init_cache(B, S))
        # each layer's call, then its four groups' (the default groups)
        assert seen == [4, None, None, None, None] * cfg.n_layers
        model.hints = {}
        one, _ = model.prefill(torch.from_numpy(tok), model.init_cache(B, S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float((got - one).abs().max()) > 1e-3


def test_materialized_cell_holds_the_dry_run_bytes():
    """The tensors a materialized cell holds (parameters, AdamW's state,
    the cache, the batch) add up to ``argument_bytes`` on the host
    mesh, group by group."""
    cfg = get_config("llama3_8b", smoke=True)          # bf16 serving
    for mode, shape in SMALL.items():
        cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
        state = cell.materialize("cpu")
        held = state.held_bytes()
        n = sum(t.numel() for t in cell.args["params"].values())
        # f32 masters; bf16 serving weights beside the f32 final norm
        assert held["params"] == (4 * n if mode == "train" else
                                  2 * n + 2 * cfg.d_model), mode
        assert held == cell.argument_bytes(), mode


REFUSED = {   # (arch, mode, mesh) -> the ROADMAP item it names
    "glm4_9b decode 1x4": ("glm4_9b", "decode", (1, 4), "#8.3"),
    "llama3_8b train 4x1": ("llama3_8b", "train", (4, 1), "#8.2"),
    "jamba_v01_52b train 4x1": ("jamba_v01_52b", "train", (4, 1), "#8.2"),
    # the smoke's 2 kv heads over a model axis of 8
    "qwen3_moe_30b_a3b decode 1x8": ("qwen3_moe_30b_a3b", "decode", (1, 8),
                                     "#8.3"),
    "xlstm_125m decode 4x1": ("xlstm_125m", "decode", (4, 1), "#8.4"),
    "seamless_m4t_medium prefill 2x2": ("seamless_m4t_medium", "prefill",
                                        (2, 2), "#8.4"),
}


@pytest.mark.parametrize("case", ["size", "no group", *REFUSED])
def test_cell_program_refusals(case):
    """What a mesh of more than one device does not run yet: a group of
    another mesh (its world size differing), a mesh with no group, a
    cache sharded over its sequence (glm4-9b's 2 kv heads over a model
    axis of 4, qwen3-moe's over 8), training (llama3-8b's, jamba's), and
    the xLSTM and encoder-decoder stacks, each naming its ROADMAP item
    (the trace too)."""
    mesh = Mesh((4, 1), ("data", "model"))
    if case in ("size", "no group"):
        cfg = get_config("llama3_8b", smoke=True)
        cell = steps.build_cell(cfg, SMALL["decode"], mesh)
        group = (MeshGroup.trace(Mesh((2, 1), ("data", "model")))
                 if case == "size" else None)
        with pytest.raises(ValueError, match="group"):
            cell.materialize("cpu", group=group)
        with pytest.raises(ValueError, match="group"):
            cell.run(steps.CellState(Model(cfg, device="meta", init=False),
                                     None, {}))
        return
    arch, mode, sizes, item = REFUSED[case]
    cfg = get_config(arch, smoke=True)
    cell = steps.build_cell(cfg, SMALL[mode], Mesh(sizes, ("data",
                                                           "model")))
    assert cell.argument_bytes()["total"] > 0
    match = f"ROADMAP Queue 1 A {item}"
    assert match in steps.mesh_refusal(cell)
    with pytest.raises(NotImplementedError, match=match):
        cell.materialize("cpu", group=MeshGroup.trace(cell.mesh))
    with pytest.raises(NotImplementedError, match=match):
        cell.trace()


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["jamba_v01_52b", "granite_moe_3b_a800m"])
def test_moe_and_mamba_serving_cells_trace_collectives(arch, mesh):
    """jamba's and granite-moe's serving cells on the production meshes:
    traced FLOPs and collectives, the experts' combine (``moe``) and
    jamba's Mamba products (``mamba/x_proj``, ``mamba/out_proj``)
    all-reduced once a layer of theirs (once a capacity group at
    prefill: granite's 64 groups over the two pods' 32 data shards of its
    32 requests give each device 2), beside FSDP's all-gathers."""
    cfg = get_config(arch)
    n = {k: sum(s.kind == k or s.ffn == k for s in cfg.unit) * cfg.n_units
         for k in ("attn", "mamba", "moe")}
    for shape in shapes_for(cfg):
        if shape.mode == "train":
            continue
        cell = steps.build_cell(cfg, shape, dryrun.make_mesh(mesh))
        assert steps.mesh_refusal(cell) is None
        records, flops = cell.trace()
        names = [r.name for r in records if r.kind == "all-reduce"]
        groups = 2 if (mesh, shape.mode) == ("multi", "prefill") else 1
        assert names.count("moe") == n["moe"] * groups
        assert names.count("attn/wo") == n["attn"]
        for name in ("mamba/x_proj", "mamba/out_proj"):
            assert names.count(name) == n["mamba"]
        assert tally(records)["counts"]["all-gather"] > 0
        a = dryrun.accounting(cell)
        assert a["flops_per_device"] == flops > 0
        assert a["collective_counts"] == tally(records)["counts"]
        assert not {"flops_per_device", "collective_counts"} & set(
            a["null_because"])


def test_materialize_holds_a_given_cache_cut_to_each_rank():
    """``materialize(group=, cache=)`` on ``(2, 2)``: every rank holds its
    shard of the given cache (the batch over ``data``, the kv heads over
    ``model``) and exactly ``argument_bytes()``; no process group is
    needed to place them (ranks as ``MeshGroup``s with none)."""
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True),
                              dtype="float32")
    shape = SMALL["decode"]
    whole = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    full = whole.materialize("cpu", 0)
    gen = torch.Generator().manual_seed(5)
    for _, t in leaves(full.args["cache"]):
        t.normal_(generator=gen)
    full.args["cache"]["index"] = shape.seq_len - 1
    mesh = Mesh((2, 2), ("data", "model"))
    cell = steps.build_cell(cfg, shape, mesh)
    for rank in range(mesh.size):
        group = MeshGroup(mesh, rank, torch.device("cpu"))
        state = cell.materialize("cpu", 0, model=full.model, group=group,
                                 cache=full.args["cache"])
        assert state.held_bytes() == cell.argument_bytes()
        assert state.args["cache"]["index"] == shape.seq_len - 1
        d, m = divmod(rank, 2)
        wants = dict(leaves(full.args["cache"]))
        for path, t in leaves(state.args["cache"]):
            want = wants[path]
            # 2 requests over data, 2 kv heads over model: one of each
            assert torch.equal(t, want[:, d:d + 1, m:m + 1])


def test_decode_32k_all_reduces_by_hand():
    """llama3-8b's ``decode_32k`` on ``(32, 8)``: 4 requests a device
    (128 over 32), so each all-reduce over ``model`` carries ``[4, 1,
    4096]`` bf16: after ``attn/wo`` and ``mlp/wo`` in each of the 32
    layers, and after the embedding lookup; and 7 FSDP all-gathers a
    layer beside the embedding's and the head's."""
    rep = dryrun.run_cell("llama3-8b", "decode_32k", "single", write=False)
    a = rep["accounting"]
    per = 4 * 1 * 4096 * 2
    assert a["collective_counts"]["all-reduce"] == 2 * 32 + 1
    assert a["collective_bytes_per_device"]["all-reduce"] == (2 * 32 + 1) \
        * per
    assert a["collective_counts"]["all-gather"] == 7 * 32 + 2
    assert a["collective_counts"]["reduce-scatter"] == 0


def test_prefill_32k_fsdp_gather_bytes():
    """llama3-8b's ``prefill_32k`` on ``(32, 8)``: the all-gather bytes a
    device are the gathered weights' per-device output shapes, each
    parameter sharded over ``data`` gathered whole but for its ``model``
    split, once; the traced FLOPs at least the model's."""
    cell = steps.build_cell(get_config("llama3_8b"), SHAPES["prefill_32k"],
                            make_production_mesh())
    want = 0
    for name, t in cell.args["params"].items():
        spec = cell.specs["params"][name]
        if "data" not in [a for e in spec if e for a in
                          (e if isinstance(e, tuple) else (e,))]:
            continue
        n = t.numel() * t.element_size()
        want += n // (8 if "model" in spec else 1)
    rep = dryrun.run_cell("llama3-8b", "prefill_32k", "single", write=False)
    a = rep["accounting"]
    assert a["collective_bytes_per_device"]["all-gather"] == want
    assert want > 2e9 / 1.01 and want < 16.06e9 / 8 * 1.01
    assert a["flops_per_device"] >= rep["model_flops_per_device"]


def test_dry_run_extrapolation_equals_the_full_trace():
    """The dry run's one- and two-unit traces extrapolated to every unit
    give the full trace's collectives and FLOPs exactly (llama3-8b and
    gemma2-9b, whose unit is two layers, on the production mesh)."""
    for arch, shape in (("llama3_8b", "decode_32k"),
                        ("gemma2_9b", "prefill_32k")):
        cell = steps.build_cell(get_config(arch), SHAPES[shape],
                                make_production_mesh())
        records, flops = cell.trace()
        assert dryrun.traced(cell) == (tally(records), flops)


def test_trace_on_one_device_issues_no_collective():
    """The host mesh's trace: the same FLOPs as any mesh's sum over its
    devices would give for the products, and no collective."""
    cfg = get_config("llama3_8b", smoke=True)
    records, flops = steps.build_cell(cfg, SMALL["decode"],
                                      make_host_mesh("cpu")).trace()
    assert records == [] and flops > 0
    four, f4 = steps.build_cell(cfg, SMALL["decode"],
                                Mesh((2, 1), ("data", "model"))).trace()
    assert f4 * 2 == flops and len(four) == 7 * cfg.n_layers + 2


def test_build_cell_on_the_full_config_is_abstract():
    """llama3-8b's published config: every argument a meta tensor; the
    host mesh's argument bytes are the whole model's (16.06 GB of bf16
    weights, the cache's 131,072 B a position)."""
    cfg = get_config("llama3_8b")
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=8)
    cell = steps.build_cell(cfg, shape, make_host_mesh("cpu"))
    assert all(t.device.type == "meta" for *_, t, _ in cell.arg_leaves())
    b = cell.argument_bytes()
    n = sum(t.numel() for t in cell.args["params"].values())
    assert b["params"] == 2 * n + 2 * cfg.d_model     # the f32 final norm
    assert b["cache"] == 8 * 32768 * 131072
    assert b["batch"] == 8 * 4
