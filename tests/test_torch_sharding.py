"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's (``repro.parallel.sharding``), on the CPU, with no
compile: every arch at its published size, on the reference's TPU meshes
(16 x 16, 2 x 16 x 16), the port's H100 meshes (32 x 8, 2 x 32 x 8), one
device (1 x 1) and a small 4 x 2.

Held exactly: every parameter leaf's spec (the reference's stacked
``units``/``encoder`` leaves without their leading ``None``: the port
holds one parameter a unit), every cache leaf's spec at each serving
shape after ``cell_model_config`` (qwen1.5-32b's int8 cache and its
scales at decode; the reference's 0-d ``index`` is a Python int in the
port and has no spec), ``batch_spec``, ``batch_pspecs`` and every
``activation_hints`` entry (``moe_groups`` too), and the per-device
argument bytes of ``build_cell`` against the same arithmetic on the
reference's specs and shapes.  The reference's meshes are built as
``AbstractMesh(axis_sizes, axis_names)``.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RefP

from repro import configs as ref_configs
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro.parallel.sharding import ShardingRules as RefRules
from repro_torch.configs import ARCH_IDS, get_config, shapes_for
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.convert import ref_key, stack_len
from repro_torch.parallel.sharding import (Mesh, P, ShardingRules,
                                           device_bytes, leaves,
                                           to_placements)

MESHES = [(16, 16), (2, 16, 16), (32, 8), (2, 32, 8), (1, 1), (4, 2)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


def _names(sizes):
    return ("pod", "data", "model") if len(sizes) == 3 else ("data",
                                                             "model")


def _meshes(sizes):
    return (AbstractMesh(sizes, _names(sizes)), Mesh(sizes, _names(sizes)))


def _flat(tree, leaf=None):
    """``{"a/b/c": leaf}`` of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def _is_spec(x):
    return isinstance(x, RefP)


def _ref_shape(name):
    return ref_configs.SHAPES[name]


@functools.lru_cache(maxsize=None)
def _ref_aparams(arch):
    return ref_build_model(ref_get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return _flat(_ref_aparams(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(steps.abstract_model(get_config(arch)).named_parameters())


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape_name, batch, length):
    cfg = ref_steps.cell_model_config(ref_get_config(arch),
                                      _ref_shape(shape_name))
    model = ref_build_model(cfg)
    return jax.eval_shape(lambda: model.init_cache(batch, length))


def _serving_shapes(cfg):
    return [s for s in shapes_for(cfg) if s.mode != "train"]


def _cache_len(cfg, shape):
    return (steps.prefill_len(cfg, shape) if shape.mode == "prefill"
            else shape.seq_len)


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, sizes):
    ref_mesh, mesh = _meshes(sizes)
    cfg = get_config(arch)
    ref = _flat(RefRules(mesh=ref_mesh, cfg=ref_get_config(arch))
                .params_pspecs(_ref_aparams(arch)), _is_spec)
    ref_shapes = _ref_params(arch)
    port = ShardingRules(mesh=mesh, cfg=cfg).params_pspecs(
        _port_params(arch))
    seen = set()
    n_sharded = 0
    for name, spec in port.items():
        key, _ = ref_key(name)
        path = key.replace(".", "/")
        want = tuple(ref[path])
        if stack_len(cfg, key):
            assert want[0] is None, (path, want)
            want = want[1:]
            assert tuple(_port_params(arch)[name].shape) == \
                ref_shapes[path].shape[1:]
        assert isinstance(spec, P) and tuple(spec) == want, (name, spec,
                                                             want)
        n_sharded += any(e is not None for e in spec)
        seen.add(path)
    assert seen == set(ref), set(ref) ^ seen
    assert n_sharded > 0 or sizes == (1, 1) or arch == "xlstm_125m"


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, sizes):
    ref_mesh, mesh = _meshes(sizes)
    cfg = get_config(arch)
    shapes = _serving_shapes(cfg)
    assert shapes
    for shape in shapes:
        mcfg = steps.cell_model_config(cfg, shape)
        L = _cache_len(cfg, shape)
        acache = _ref_cache(arch, shape.name, shape.global_batch, L)
        ref_cfg = ref_steps.cell_model_config(ref_get_config(arch),
                                              _ref_shape(shape.name))
        assert ref_cfg.kv_dtype == mcfg.kv_dtype
        ref = _flat(RefRules(mesh=ref_mesh, cfg=ref_cfg)
                    .cache_pspecs(acache), _is_spec)
        assert tuple(ref.pop("index")) == ()
        shapes_ref = {k: v for k, v in _flat(acache).items()
                      if k != "index"}
        cache = steps.abstract_cache(steps.abstract_model(mcfg),
                                     shape.global_batch, L)
        assert cache["index"] == 0
        port = ShardingRules(mesh=mesh, cfg=mcfg).cache_pspecs(cache)
        assert set(port) == set(ref), (shape.name, set(port) ^ set(ref))
        for path, spec in port.items():
            assert tuple(spec) == tuple(ref[path]), (shape.name, path)
        for path, t in leaves(cache):
            r = shapes_ref[path]
            assert tuple(t.shape) == r.shape, path
            assert str(t.dtype).split(".")[-1] == str(r.dtype), path


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_activation_hints_match_reference(arch, sizes):
    ref_mesh, mesh = _meshes(sizes)
    cfg = get_config(arch)
    for shape in shapes_for(cfg):
        mcfg = steps.cell_model_config(cfg, shape)
        ref_cfg = ref_steps.cell_model_config(ref_get_config(arch),
                                              _ref_shape(shape.name))
        ref = RefRules(mesh=ref_mesh, cfg=ref_cfg)
        port = ShardingRules(mesh=mesh, cfg=mcfg)
        for b in (shape.global_batch, 1, 17, 64, 512):
            assert port.batch_spec(b) == ref.batch_spec(b)
        train = shape.mode == "train"
        want = _flat(ref.batch_pspecs(ref_steps.abstract_batch(
            ref_cfg, _ref_shape(shape.name))), _is_spec)
        got = port.batch_pspecs(steps.abstract_batch(mcfg, shape))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        for seq in (True, False):
            rh = ref.activation_hints(shape.global_batch, shape.seq_len,
                                      use_seq_sharding=seq)
            ph = port.activation_hints(shape.global_batch, shape.seq_len,
                                       use_seq_sharding=seq)
            assert set(ph) == set(rh)
            for k, v in rh.items():
                if k == "moe_groups":
                    assert ph[k] == v and isinstance(ph[k], int)
                else:
                    assert tuple(ph[k]) == tuple(v.spec), (k, ph[k], v)
            if train == seq:
                assert steps.build_cell(cfg, shape, mesh).hints == ph


def _ref_bytes(shape, itemsize, spec, mesh_shape):
    n = int(np.prod(shape, dtype=np.int64)) * itemsize
    for entry in spec:
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        n //= int(np.prod([mesh_shape[a] for a in axes], dtype=np.int64))
    return n


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_reference_arithmetic(arch, sizes):
    """``build_cell(...).argument_bytes()`` against the reference's specs
    and shapes: parameters in the dtype each side serves with (the
    reference's ``_cast_params``: a floating leaf of two or more
    dimensions in ``cfg.dtype``; float32 masters to train), AdamW's
    ``m``/``v`` as their parameter and its int32 ``step``, the cache
    without its index, the batch (tokens, labels, frames) over its
    leading dimension."""
    ref_mesh, mesh = _meshes(sizes)
    ms = dict(zip(_names(sizes), sizes))
    cfg = get_config(arch)
    for shape in shapes_for(cfg):
        ref_shape = _ref_shape(shape.name)
        ref_cfg = ref_steps.cell_model_config(ref_get_config(arch),
                                              ref_shape)
        rules = RefRules(mesh=ref_mesh, cfg=ref_cfg)
        aparams = _ref_params(arch)
        pspecs = _flat(rules.params_pspecs(_ref_aparams(arch)), _is_spec)
        train = shape.mode == "train"
        serve_item = jax.numpy.dtype(ref_cfg.dtype).itemsize
        want = dict.fromkeys(("params", "opt_state", "cache", "batch"), 0)
        for path, leaf in aparams.items():
            item = (leaf.dtype.itemsize if train or leaf.ndim < 2
                    else serve_item)
            want["params"] += _ref_bytes(leaf.shape, item, pspecs[path], ms)
            if train:
                want["opt_state"] += 2 * _ref_bytes(leaf.shape, 4,
                                                    pspecs[path], ms)
        B = shape.global_batch
        if train:
            want["opt_state"] += 4               # the int32 step, P()
            batch = ref_steps.abstract_batch(ref_cfg, ref_shape)
        else:
            specs = ref_steps.input_specs(ref_get_config(arch), ref_shape)
            cache = specs.pop("cache")
            cspecs = _flat(rules.cache_pspecs(cache), _is_spec)
            for path, leaf in _flat(cache).items():
                if path != "index":
                    want["cache"] += _ref_bytes(leaf.shape,
                                                leaf.dtype.itemsize,
                                                cspecs[path], ms)
            batch = specs
        bspecs = _flat(rules.batch_pspecs(batch), _is_spec)
        for path, leaf in _flat(batch).items():
            want["batch"] += _ref_bytes(leaf.shape, leaf.dtype.itemsize,
                                        bspecs[path], ms)
        want["total"] = sum(want.values())
        cell = steps.build_cell(cfg, shape, mesh)
        assert cell.argument_bytes() == want, (shape.name, B)


@pytest.mark.parametrize("sizes", [(16, 16), (32, 8), (2, 32, 8)],
                         ids=["16x16", "32x8", "2x32x8"])
def test_batch_spec_falls_back(sizes):
    """The reference's case on its 16 x 16 mesh, and the H100 meshes: a
    batch the data axes do not divide is not sharded."""
    rules = ShardingRules(mesh=Mesh(sizes, _names(sizes)),
                          cfg=get_config("llama3_8b"))
    data = ("pod", "data") if len(sizes) == 3 else ("data",)
    assert rules.batch_spec(256) == data
    assert rules.batch_spec(1) is None          # long_500k: unshardable
    assert rules.batch_spec(17) is None
    if len(sizes) == 3:                         # 32 is not 2 x 32
        assert rules.batch_spec(32) == ("data",)


@pytest.mark.parametrize("sizes", [(16, 16), (32, 8)],
                         ids=["16x16", "32x8"])
@pytest.mark.parametrize("arch,heads", [("qwen15_32b", 40),
                                        ("paligemma_3b", 8),
                                        ("llama3_8b", 32)])
def test_attention_fallback_when_heads_dont_divide(arch, heads, sizes):
    """qwen1.5 (40 heads) and paligemma (8 heads) cannot split their
    heads 16 ways: their attention weights fall back to FSDP only; on
    the H100 mesh's 8-way model axis every one splits."""
    rules = ShardingRules(mesh=Mesh(sizes, _names(sizes)),
                          cfg=get_config(arch))
    spec = rules.param_spec("units/layer0/attn/wq", (4096, 4096))
    assert get_config(arch).n_heads == heads
    assert ("model" in spec) == (heads % sizes[-1] == 0)
    if sizes == (16, 16):
        assert ("model" in spec) == (arch == "llama3_8b")


def test_to_placements():
    """A spec as DTensor placements, one per mesh dimension; a dimension
    over ``("pod", "data")`` is ``Shard(d)`` at both; no process group."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    rules = ShardingRules(mesh=mesh, cfg=get_config("llama3_8b"))
    spec = rules.param_spec("embedding", (128256, 4096))
    assert spec == P("model", ("pod", "data"))
    assert to_placements(spec, mesh) == [Shard(1), Shard(1), Shard(0)]
    assert to_placements(P(None, "data"), mesh_lib.make_production_mesh()) \
        == [Shard(1), Replicate()]
    assert to_placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="no mesh axis"):
        to_placements(P("tensor"), mesh)


def test_device_bytes():
    """A dimension over axes of total size ``n`` holds ``size / n`` a
    device; a spec that does not divide its tensor raises."""
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    assert device_bytes((128, 4096, 8), 2, P(("pod", "data"), "model"),
                        mesh) == (128 // 64) * (4096 // 8) * 8 * 2
    assert device_bytes((), 4, P(), mesh) == 4
    with pytest.raises(ValueError, match="does not divide"):
        device_bytes((128, 40), 2, P(None, ("pod", "data")), mesh)


def test_production_and_host_meshes():
    """The reference's device counts as H100 nodes of 8; the host mesh
    on the CPU is one device."""
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (single.shape, single.size) == ({"data": 32, "model": 8}, 256)
    assert (multi.shape, multi.size) == (
        {"pod": 2, "data": 32, "model": 8}, 512)
    assert mesh_lib.make_host_mesh("cpu") == Mesh((1, 1), ("data", "model"))
