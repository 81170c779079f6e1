"""MoE and Mamba layers across the devices of a mesh: four gloo ranks on the
CPU (``tests/torch_mesh_ranks.py``, one process a rank, started once a
mesh for both archs) against the one-process program and the reference.

Two configs in float32 (``attn_chunk=8``), prefill of 4 x 32 tokens and
one decode step of 4 requests over a 48-position cache of seeded K/V and
Mamba states (index 47), on three meshes over ``("data", "model")``:
``(4, 1)`` (FSDP and the requests over ``data``, one MoE capacity group
a rank), ``(2, 2)`` and ``(1, 4)`` (heads, widths, the vocabulary, the
experts and Mamba's inner channels over ``model``):

- jamba-v0.1's smoke config (Mamba, attention, dense MLP and MoE layers;
  4 experts, top-2), at ``n_kv_heads=4`` on ``(1, 4)``: at its 2 kv heads
  a model axis of 4 would shard the cache over its sequence, which the
  port refuses (ROADMAP Queue 1 A #8.3);
- granite-moe's smoke config with 8 query heads of width 8, 4 kv heads
  and 8 experts (top-2) on every mesh: its 6 heads, 2 kv heads and 5
  experts do not split over a model axis of 4, nor its experts over 2.

What is held, and within what:

- the logits, gathered whole on every rank, against the one-process
  ``CellProgram.run`` on the same weights and inputs (its model given the
  mesh's MoE capacity groups, one a data shard, as the mesh's program
  routes them): within ``TOL`` = 1e-5 where the model axis is one device
  (nothing is summed in another order), within the serve limit
  ``SERVE_TOL`` = 1e-3 where the all-reduces over it reorder float32
  sums: the attention layer's cache holds bf16, so a last-bit difference
  in K or V can round to the neighbouring bf16 value, which the next
  layers carry on (``tests/test_torch_multicard.py`` shows the same for
  llama3-8b).  Against the reference's jitted ``CellProgram`` (its rules'
  ``moe_groups`` set to the mesh's) within the serve limit;
- the cache (K/V, Mamba's ``conv`` and ``ssm`` states), gathered whole,
  within one bf16 step (``rtol=2**-7``, ``atol`` ``TOL``) of the
  one-process program's and of the reference's;
- every parameter gathered back from the ranks' shards equal to the whole
  model's (Mamba's ``in_proj`` undoing its two-block cut exactly);
- every rank's ``held_bytes()`` equal to ``argument_bytes()``;
- the collectives every rank issued equal to ``CellProgram.trace``'s;
  the named all-reduces ``moe``, ``mamba/x_proj`` and ``mamba/out_proj``
  issued once a layer of theirs where the model axis has more than one
  device;
- the planted faults of ``chip_smoke.py`` (``plant_mesh_fault``: rank
  0's local experts rolled by one; Mamba's ``out_proj`` all-reduce
  skipped; ``in_proj`` cut plainly; for granite also rank 0's query
  heads rolled and the attention's ``wo`` all-reduce skipped) move the
  logits by more than 100 times the serve limit, where they change
  anything (a skipped all-reduce or a plain cut over a model axis of one
  device changes nothing, within ``TOL``, nor does rolling a rank's one
  expert: jamba's 4 over a model axis of 4).

Beside the ranks: a rank's weights drawn one parameter at a time equal
the whole model's cut, bit for bit, on every rank of every mesh, and a
draw that is not its parameter's own tensor fails the draw; and the
Mamba scan's FLOPs as the dry run counts them on ``meta`` (one product
for the step loop) equal a full run's at a 1,024-token prompt.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils.flop_counter import FlopCounterMode

import torch_mesh_ranks as ranks_mod
from repro import configs as ref_configs
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro.parallel.sharding import ShardingRules as RefRules
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import ssm as pt_ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.parallel.collectives import tally
from repro_torch.parallel.group import MeshGroup
from repro_torch.parallel.sharding import Mesh, leaves

chip_smoke = ranks_mod.chip_smoke
SHAPES = {"prefill": ShapeConfig("prefill_32k", 32, 4, "prefill"),
          "decode": ShapeConfig("decode_32k", 48, 4, "decode")}
MESHES = {"4x1": Mesh((4, 1), ("data", "model")),
          "2x2": Mesh((2, 2), ("data", "model")),
          "1x4": Mesh((1, 4), ("data", "model"))}
ONE = Mesh((1, 1), ("data", "model"))
ARCHS = ("jamba_v01_52b", "granite_moe_3b_a800m")
FAULTS = {"jamba_v01_52b": chip_smoke.JAMBA_MESH_FAULTS,
          "granite_moe_3b_a800m": ("expert_slice",) + chip_smoke.MESH_FAULTS}
# the faults that change nothing where the model axis is one device
MODEL_AXIS_FAULTS = ("no_wo_all_reduce", "no_out_proj_all_reduce",
                     "in_proj_contiguous")
TOL = 1e-5          # against the one-process program (f32)
SERVE_TOL = 1e-3    # the serve limit (tests/test_torch_dryrun.py)
BF16_STEP = 2 ** -7  # one bf16 step, relative (the K/V cache's dtype)
SEED = 0


def _overrides(arch: str, mesh_name: str) -> dict:
    over = dict(dtype="float32", attn_chunk=8)
    if arch == "jamba_v01_52b":
        return dict(over, n_kv_heads=4 if mesh_name == "1x4" else 2)
    return dict(over, n_heads=8, n_kv_heads=4, head_dim=8)


def _configs(arch: str, mesh_name: str):
    over = _overrides(arch, mesh_name)
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    if arch == "granite_moe_3b_a800m":
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, n_experts=8))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8))
    return ref_cfg, cfg


def _groups(mesh: Mesh) -> int:
    """The mesh's MoE capacity groups (one a data shard)."""
    return mesh.shape["data"]


@functools.lru_cache(maxsize=None)
def _setup(arch: str, mesh_name: str):
    """The configs, the reference's weights, and the one-process port's
    and the reference's results of both steps, with the mesh's MoE
    capacity groups."""
    ref_cfg, cfg = _configs(arch, mesh_name)
    groups = _groups(MESHES[mesh_name])
    tree = jax.tree_util.tree_map(
        np.asarray, ref_build_model(ref_cfg).init_params(
            jax.random.PRNGKey(SEED)))
    one, ref = {}, {}
    for mode, shape in SHAPES.items():
        cell = steps.build_cell(cfg, shape, ONE)
        state = cell.materialize("cpu", SEED, model=params_from_numpy(
            tree, cfg, device="cpu"))
        state.model.hints["moe_groups"] = groups
        if mode == "decode":
            ranks_mod.fill_cache(cell, state.args["cache"], SEED + 1)
        tok = state.args["tokens" if mode == "prefill" else "token"].numpy()
        ref_cache = _ref_cache(ref_cfg, shape, state.args["cache"])
        logits, cache = cell.run(state)
        one[mode] = (logits.numpy(), {p: t.float().numpy()
                                      for p, t in leaves(cache)})
        want, wcache = _ref_cell(ref_cfg, shape, groups).jitted(
            tree, jnp.asarray(tok), ref_cache)
        ref[mode] = (np.asarray(want), {
            f"layers/{n}/{k}": np.asarray(v, np.float32)
            for n, layer in wcache["layers"].items()
            for k, v in layer.items()})
    return cfg, tree, one, ref


def _ref_cache(ref_cfg, shape, port_cache):
    """The reference's cache holding copies of the port's leaves (the
    port's steps write theirs in place, and the program donates its)."""
    cache = ref_build_model(ref_cfg).init_cache(shape.global_batch,
                                                shape.seq_len)
    layers = {n: {k: jnp.array(t.float().numpy(), copy=True).astype(
        cache["layers"][n][k].dtype) for k, t in layer.items()}
        for n, layer in port_cache["layers"].items()}
    return dict(cache, layers=layers,
                index=jnp.asarray(port_cache["index"], jnp.int32))


def _ref_cell(ref_cfg, shape, groups: int):
    """The reference's ``CellProgram`` on its host mesh (axes ``Auto``, as
    ``tests/test_torch_dryrun.py::_ref_cell``), its rules' ``moe_groups``
    set to ``groups``."""
    ref_shape = ref_configs.ShapeConfig(*dataclasses.astuple(shape))
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = RefRules(mesh=mesh, cfg=ref_cfg)
    hints = rules.activation_hints

    def with_groups(*a, **kw):
        return dict(hints(*a, **kw), moe_groups=groups)

    object.__setattr__(rules, "activation_hints", with_groups)
    return ref_steps.build_cell(ref_cfg, ref_shape, mesh, rules=rules)


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    """Every rank's results on one mesh (one spawn of its ranks, both
    archs)."""
    mesh = MESHES[request.param]
    jobs, setups = {}, {}
    for arch in ARCHS:
        cfg, tree, one, ref = setups[arch] = _setup(arch, request.param)
        jobs[arch] = (cfg, SHAPES, tree, FAULTS[arch])
    out = ranks_mod.run_mesh_jobs(mesh, jobs,
                                  tmp_path_factory.mktemp(request.param),
                                  SEED)
    return dict(mesh=mesh, setups=setups, ranks=out)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _limit(run) -> float:
    return TOL if run["mesh"].shape["model"] == 1 else SERVE_TOL


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_one_process_and_reference(run, arch, mode):
    _, _, one, ref = run["setups"][arch]
    want, _ = one[mode]
    assert _err(want, ref[mode][0]) <= SERVE_TOL
    for r in run["ranks"]:
        got = r[arch][mode]["logits"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _err(got, want) <= _limit(run), r["rank"]
        assert _err(got, ref[mode][0]) <= SERVE_TOL, r["rank"]


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_matches_one_process_and_reference(run, arch, mode):
    _, _, one, ref = run["setups"][arch]
    want, wref = one[mode][1], ref[mode][1]
    for r in run["ranks"]:
        assert r[arch][mode]["index"] == SHAPES[mode].seq_len
        got = r[arch][mode]["cache"]
        assert set(got) == set(want) == set(wref)
        for path, t in got.items():
            np.testing.assert_allclose(t, want[path], atol=TOL,
                                       rtol=BF16_STEP, err_msg=path)
            np.testing.assert_allclose(t, wref[path], atol=TOL,
                                       rtol=BF16_STEP, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_gather_back_whole(run, arch):
    for r in run["ranks"]:
        assert r[arch]["gathered_differ"] == [], r["rank"]


def test_every_rank_holds_the_argument_bytes(run):
    for r in run["ranks"]:
        for arch in ARCHS:
            for mode in SHAPES:
                res = r[arch][mode]
                assert res["held"] == res["want"], (r["rank"], arch, mode)
                assert res["held"]["params"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_equal_the_meta_trace(run, arch):
    mesh = run["mesh"]
    cfg = run["setups"][arch][0]
    layers = {k: sum(s.kind == k or s.ffn == k for s in cfg.unit)
              * cfg.n_units for k in ("mamba", "moe")}
    split = mesh.shape["model"] > 1
    for mode, shape in SHAPES.items():
        traced, flops = steps.build_cell(cfg, shape, mesh).trace()
        assert flops > 0
        names = [x.name for x in traced if x.kind == "all-reduce"]
        assert names.count("moe") == (layers["moe"] if split else 0)
        for name in ("mamba/x_proj", "mamba/out_proj"):
            assert names.count(name) == (layers["mamba"] if split else 0)
        assert tally(traced)["counts"]["all-gather"] > 0 or \
            mesh.shape["data"] == 1
        for r in run["ranks"]:
            assert r[arch][mode]["records"] == traced, (r["rank"], mode)


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch_fault", [(a, f) for a in ARCHS
                                        for f in FAULTS[a]],
                         ids=lambda af: "-".join(af))
def test_planted_faults_exceed_the_limits(run, arch_fault, mode):
    arch, fault = arch_fault
    cfg, _, one, _ = run["setups"][arch]
    tp = run["mesh"].shape["model"]
    err = _err(run["ranks"][0][arch][mode]["faults"][fault], one[mode][0])
    if (fault in MODEL_AXIS_FAULTS and tp == 1) or (
            fault == "expert_slice" and cfg.moe.n_experts == tp):
        assert err <= TOL  # nothing to skip or to cut; one expert a rank
    else:
        assert err > 100 * SERVE_TOL, err


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_one_parameter_at_a_time_equals_the_whole_cut(arch,
                                                           mesh_name):
    """``materialize`` with no model draws each weight and cuts it at once;
    every rank's shards equal ``Model(cfg, seed=s)`` cut whole, bit for
    bit (bf16 weights, as served), and no rank holds a whole weight that
    the mesh splits."""
    _, cfg = _configs(arch, mesh_name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    mesh = MESHES[mesh_name]
    shape = SHAPES["decode"]
    cell = steps.build_cell(cfg, shape, mesh)
    whole = Model(cell.cfg, device="cpu", seed=7)
    for rank in range(mesh.size):
        group = MeshGroup(mesh, rank, torch.device("cpu"))
        drawn = cell.materialize("cpu", 7, group=group)
        cut = cell.materialize("cpu", 7, model=whole, group=group)
        got = dict(drawn.model.named_parameters())
        want = dict(cut.model.named_parameters())
        assert got.keys() == want.keys()
        for name, t in want.items():
            assert torch.equal(got[name], t), (rank, name)
        assert drawn.held_bytes() == cell.argument_bytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_draw_that_is_no_parameter_fails_the_draw(arch, monkeypatch):
    """Where a drawn tensor is not its parameter's own (here every draw
    copied before it is kept, as a weight reshaped or stacked into its
    parameter would be), no rank can cut it as it is made:
    ``materialize`` raises before it draws anything, rather than hold it
    whole."""
    from repro_torch.models import layers
    _, cfg = _configs(arch, "1x4")
    mesh = MESHES["1x4"]
    cell = steps.build_cell(cfg, SHAPES["decode"], mesh)
    made = layers._made
    monkeypatch.setattr(layers, "_made", lambda t: made(t).clone())
    with pytest.raises(RuntimeError, match="no parameter's own tensor"):
        cell.materialize("cpu", 7, group=MeshGroup(mesh, 0,
                                                   torch.device("cpu")))


def test_scan_flops_on_meta_equal_a_full_run():
    """The Mamba block at a 1,024-token prompt: ``FlopCounterMode`` over
    the ``meta`` trace (the step loop as one product) counts the same
    FLOPs as over the run on real tensors, the loop's ``2 B d_in N`` a
    step included."""
    d_model, B, L = 32, 2, 1024
    p = pt_ssm.init_mamba(None, d_model, torch.float32, mode="empty",
                          device="cpu")
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(t.shape, generator=gen) * 0.1 for k, t in p.items()}
    x = torch.randn(B, L, d_model, generator=gen)
    counts = []
    for dev in ("cpu", "meta"):
        with FlopCounterMode(display=False) as counter:
            y, _ = pt_ssm.apply_mamba({k: t.to(dev) for k, t in p.items()},
                                      x.to(dev), chunk=256)
        assert y.shape == (B, L, d_model)
        counts.append(counter.get_total_flops())
    d_in, n = p["a_log"].shape
    assert counts[0] == counts[1] and counts[0] > 2 * B * L * d_in * n * 1


def test_materialize_cuts_a_given_mamba_cache():
    """``materialize(group=, cache=)`` at jamba's smoke config on ``(2,
    2)``: every rank holds its shard of the given cache by the cache
    specs (the requests over ``data``; K/V's kv heads, ``conv``'s
    channels on dimension -1 and ``ssm``'s on -2 over ``model``) and
    exactly ``argument_bytes()``; no process group is needed to place
    them."""
    _, cfg = _configs("jamba_v01_52b", "2x2")
    shape = SHAPES["decode"]
    whole = steps.build_cell(cfg, shape, ONE).materialize("cpu", 0)
    gen = torch.Generator().manual_seed(5)
    for _, t in leaves(whole.args["cache"]):
        t.normal_(generator=gen)
    mesh = MESHES["2x2"]
    cell = steps.build_cell(cfg, shape, mesh)
    wants = dict(leaves(whole.args["cache"]))
    for rank in range(mesh.size):
        group = MeshGroup(mesh, rank, torch.device("cpu"))
        state = cell.materialize("cpu", 0, model=whole.model, group=group,
                                 cache=whole.args["cache"])
        assert state.held_bytes() == cell.argument_bytes()
        d, m = divmod(rank, 2)
        got = dict(leaves(state.args["cache"]))
        assert got.keys() == wants.keys()
        for path, want in wants.items():
            b = slice(2 * d, 2 * d + 2)        # 4 requests over data
            if path.endswith("/conv"):
                c = want.shape[-1] // 2
                want = want[:, b, :, m * c:(m + 1) * c]
            elif path.endswith("/ssm"):
                c = want.shape[-2] // 2
                want = want[:, b, m * c:(m + 1) * c]
            else:                             # 2 kv heads over model
                want = want[:, b, m:m + 1]
            assert torch.equal(got[path], want), (rank, path)
