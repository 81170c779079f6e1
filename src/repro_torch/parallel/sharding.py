"""Sharding rules: best-effort logical-axis assignment with divisibility.

The port of ``repro/parallel/sharding.py``.  Every parameter and cache
leaf gets a partition spec derived from its *path* and the architecture's
geometry.  Assignments degrade gracefully: if a dimension does not divide
the mesh axis (40 attention heads on an 8-way model axis that would need
5, granite's 40 experts on a 16-way one), the rule falls back (FSDP only,
replication, or sequence sharding) instead of failing.

The port works on its own mesh description, :class:`Mesh` (axis names and
sizes, the counterpart of ``jax.sharding.AbstractMesh``), and its own
spec, :class:`P` (a tuple with one entry per dimension: ``None``, an axis
name, or a tuple of names, as ``PartitionSpec``).  :func:`to_placements`
turns a spec into ``torch.distributed.tensor`` placements, one per mesh
dimension; those need no process group.  Nothing here starts one.

The rules keep the reference's choices literally, its quirks included,
because the parity tests compare specs as values: ``fit`` stops at the
first empty candidate; a one-axis tuple collapses to its name;
``_heads_ok`` reads only the first model candidate; the cache's
``/(k|v|k_scale|v_scale)$`` does not match ``cross_k``/``cross_v``, so
those get batch sharding only; Mamba's ``ssm`` state shards dimension -2
and every other recurrent leaf dimension -1.

Parameter names.  The reference stacks a unit's leaves over the units and
prepends ``None`` to the spec of any path under ``units`` or ``encoder``.
The port holds one parameter a unit (``units.3.layer0.attn.wq``), so
:meth:`ShardingRules.params_pspecs` keys each rule by the reference key
(:func:`repro_torch.models.convert.ref_key`: ``units/layer0/attn/wq``) and
gives the per-unit parameter the reference's core spec, the reference's
spec without its leading ``None``.  The cache's write index is a Python
int in the port (a 0-d array with ``P()`` in the reference): it gets no
spec and no bytes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import ref_key


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``;
    one entry per dimension (``None``: not sharded; a name or a tuple of
    names: sharded over those mesh axes, the first the slowest)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):            # copy and pickle: P(*parts)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as shape only: ``Mesh((32, 8), ("data", "model"))``
    (the argument order of ``AbstractMesh(axis_sizes, axis_names)``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return _prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.axis_sizes)


def to_placements(spec: Sequence, mesh: Mesh) -> list:
    """``spec`` as ``torch.distributed.tensor`` placements, one per mesh
    dimension: ``Shard(d)`` where tensor dimension ``d`` is sharded over
    that mesh axis, else ``Replicate()`` (a dimension over ``("pod",
    "data")`` gives ``Shard(d)`` at both)."""
    from torch.distributed.tensor import Replicate, Shard
    on = {}
    for d, entry in enumerate(spec):
        for axis in axes_of(entry):
            if axis in on:
                raise ValueError(f"{spec}: mesh axis {axis!r} used twice")
            on[axis] = d
    unknown = set(on) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"{spec}: no mesh axis {sorted(unknown)}")
    return [Shard(on[a]) if a in on else Replicate()
            for a in mesh.axis_names]


def device_bytes(shape: Sequence[int], itemsize: int, spec: Sequence,
                 mesh: Mesh) -> int:
    """Bytes one device holds of a tensor of ``shape`` under ``spec``: a
    dimension sharded over axes of total size ``n`` contributes
    ``size / n``.  Raises if a sharded dimension does not divide."""
    n = _prod(shape)
    for d, entry in enumerate(spec):
        size = _prod(mesh.shape[a] for a in axes_of(entry))
        if shape[d] % size:
            raise ValueError(f"{spec} does not divide {tuple(shape)} on "
                             f"{mesh.shape}")
        n //= size
    return n * itemsize


def param_blocks(name: str) -> int:
    """How many equal blocks lie side by side along a parameter's
    model-axis dimension, each split over the axis on its own
    (:func:`~repro_torch.parallel.group.local_shard`): 2 for Mamba's
    ``in_proj`` (``[D, 2 d_in]``: the ``x`` half, then the ``z`` half that
    gates it channel by channel), 1 for every other parameter.  ``name``
    is the port's (``units.0.layer1.mamba.in_proj``) or the reference's
    key."""
    return 2 if re.search(r"mamba[./]in_proj$", name) else 1


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of a nested dict, the path the
    keys joined by ``/``; other leaves (the cache's int index) are
    skipped."""
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from leaves(val, path)
        elif isinstance(val, torch.Tensor):
            yield path, val


@dataclasses.dataclass
class ShardingRules:
    """Per-(arch x shape) sharding policy, overridable for perf
    iteration."""
    mesh: Mesh
    cfg: ModelConfig
    # axis roles; tuples of mesh axis names, tried in order
    fsdp_candidates: Tuple[Tuple[str, ...], ...] = ()
    model_candidates: Tuple[Tuple[str, ...], ...] = ()
    dp_candidates: Tuple[Tuple[str, ...], ...] = ()
    # decode-cache strategy: shard sequence when heads don't fit
    seq_shard_cache: bool = True
    # residual-stream sequence sharding (sequence parallelism); production
    # default for training
    act_seq_axes: Optional[Tuple[str, ...]] = ("model",)

    def __post_init__(self):
        has_pod = "pod" in self.mesh.axis_names
        if not self.fsdp_candidates:
            self.fsdp_candidates = ((("pod", "data") if has_pod
                                     else ("data",)), ("data",), ())
        if not self.model_candidates:
            self.model_candidates = (("model",), ())
        if not self.dp_candidates:
            self.dp_candidates = ((("pod", "data") if has_pod
                                   else ("data",)), ("data",), ())

    # -- helpers ------
    def axis_size(self, axes: Tuple[str, ...]) -> int:
        return _prod(self.mesh.shape[a] for a in axes)

    def fit(self, size: int, candidates, taken) -> Optional[Tuple[str, ...]]:
        for axes in candidates:
            if not axes:
                return None
            if any(a in taken for a in axes):
                continue
            if size % self.axis_size(axes) == 0:
                return axes
        return None

    def _spec(self, shape, wants) -> P:
        """wants: list of (dim, role) in priority order."""
        assign: Dict[int, Tuple[str, ...]] = {}
        taken: set = set()
        for dim, role in wants:
            cands = {"fsdp": self.fsdp_candidates,
                     "model": self.model_candidates,
                     "dp": self.dp_candidates}[role]
            axes = self.fit(shape[dim], cands, taken)
            if axes:
                assign[dim] = axes
                taken.update(axes)
        return P(*(self._axes_or_none(assign.get(d))
                   for d in range(len(shape))))

    @staticmethod
    def _axes_or_none(axes):
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    # -- parameters ------
    def _heads_ok(self, n_heads: int) -> bool:
        m = self.axis_size(self.model_candidates[0]) \
            if self.model_candidates[0] else 1
        return n_heads % m == 0

    def param_spec(self, path: str, shape) -> P:
        """The spec of one unstacked parameter: ``path`` is the
        reference's key joined by ``/`` (``units/layer0/attn/wq``),
        ``shape`` the port's (one unit's)."""
        cfg = self.cfg
        if re.search(r"embedding$", path):
            return self._spec(shape, [(0, "model"), (1, "fsdp")])
        if re.search(r"lm_head$", path):
            return self._spec(shape, [(1, "model"), (0, "fsdp")])
        if re.search(r"frontend_proj$", path):
            return self._spec(shape, [(1, "model"), (0, "fsdp")])
        # attention ------
        if re.search(r"(attn|cross)/w([qkv])$", path):
            which = re.search(r"w([qkv])$", path).group(1)
            heads = cfg.n_heads if which == "q" else cfg.n_kv_heads
            if self._heads_ok(heads):
                return self._spec(shape, [(1, "model"), (0, "fsdp")])
            return self._spec(shape, [(0, "fsdp")])
        if re.search(r"(attn|cross)/wo$", path):
            if self._heads_ok(cfg.n_heads):
                return self._spec(shape, [(0, "model"), (1, "fsdp")])
            return self._spec(shape, [(1, "fsdp")])
        if re.search(r"(attn|cross)/b([qkv])$", path):
            which = re.search(r"b([qkv])$", path).group(1)
            heads = cfg.n_heads if which == "q" else cfg.n_kv_heads
            if self._heads_ok(heads):
                return self._spec(shape, [(0, "model")])
            return P(*([None] * len(shape)))
        # dense mlp ------
        if re.search(r"mlp/wi_(gate|up)$", path):
            return self._spec(shape, [(1, "model"), (0, "fsdp")])
        if re.search(r"mlp/wo$", path):
            return self._spec(shape, [(0, "model"), (1, "fsdp")])
        # moe ------
        if re.search(r"moe/router$", path):
            return self._spec(shape, [(0, "fsdp")])
        if re.search(r"moe/wi_(gate|up)$", path):  # [E, D, F]
            return self._spec(shape, [(0, "model"), (1, "fsdp"), (2, "model")])
        if re.search(r"moe/wo$", path):            # [E, F, D]
            return self._spec(shape, [(0, "model"), (2, "fsdp"), (1, "model")])
        # mamba ------
        if re.search(r"mamba/in_proj$", path):
            return self._spec(shape, [(1, "model"), (0, "fsdp")])
        if re.search(r"mamba/conv_w$", path):
            return self._spec(shape, [(1, "model")])
        if re.search(r"mamba/(conv_b|dt_proj_b|d_skip)$", path):
            return self._spec(shape, [(0, "model")])
        if re.search(r"mamba/(x_proj|a_log|out_proj)$", path):
            return self._spec(shape, [(0, "model"), (1, "fsdp")]
                              if path.endswith("out_proj")
                              else [(0, "model")])
        if re.search(r"mamba/dt_proj_w$", path):
            return self._spec(shape, [(1, "model")])
        # xlstm: tiny -> replicate compute params, fsdp the projections
        if re.search(r"(mlstm|slstm)/(up_proj|down_proj)$", path):
            return self._spec(shape, [(0, "fsdp")])
        # xlstm's other leaves, norms, everything else: replicated
        return P(*([None] * len(shape)))

    def params_pspecs(self, named: Dict[str, torch.Tensor]) -> Dict[str, P]:
        """The spec of every parameter, keyed as ``named`` (a model's
        ``named_parameters()``, the port's names)."""
        return {name: self.param_spec(ref_key(name)[0].replace(".", "/"),
                                      tuple(t.shape))
                for name, t in named.items()}

    # -- batches ------
    def batch_spec(self, global_batch: int) -> Optional[Tuple[str, ...]]:
        return self.fit(global_batch, self.dp_candidates, set())

    def batch_pspecs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, P]:
        """Every input sharded over its leading (batch) dimension."""
        return {name: P(self._axes_or_none(self.batch_spec(t.shape[0])),
                        *([None] * (t.dim() - 1)))
                for name, t in batch.items()}

    # -- decode caches ------
    def cache_spec(self, path: str, shape) -> P:
        """Cache leaves are stacked [n_units, B, ...]."""
        if len(shape) == 0:
            return P()
        taken: set = set()
        parts = [None] * len(shape)
        # batch
        b = self.fit(shape[1], self.dp_candidates, taken)
        if b:
            parts[1] = self._axes_or_none(b)
            taken.update(b)
        if re.search(r"/(k|v|k_scale|v_scale)$", path):
            kv_dim, seq_dim = 2, 3
            kv = self.fit(shape[kv_dim], self.model_candidates, taken)
            if kv:
                parts[kv_dim] = self._axes_or_none(kv)
            elif self.seq_shard_cache:
                sq = self.fit(shape[seq_dim], self.model_candidates, taken)
                if sq:
                    parts[seq_dim] = self._axes_or_none(sq)
        elif re.search(r"mamba|ssm|conv", path) and len(shape) >= 3:
            dim = -2 if path.endswith("ssm") else -1
            d = self.fit(shape[dim], self.model_candidates, taken)
            if d:
                parts[dim] = self._axes_or_none(d)
        return P(*parts)

    def cache_pspecs(self, cache: Dict[str, Any]) -> Dict[str, P]:
        """The spec of every tensor of a cache, keyed by its path
        (``layers/layer0/k``)."""
        return {path: self.cache_spec(path, tuple(t.shape))
                for path, t in leaves(cache)}

    # -- activation hints ------
    def activation_hints(self, global_batch: int, seq_len: int,
                         use_seq_sharding: bool = True) -> Dict[str, Any]:
        """Specs for the residual stream (``act``), the logits, the MoE
        buffers and the recurrent states, and ``moe_groups`` (one MoE
        capacity group a data shard).  On a one-device mesh only
        ``moe_groups`` has an effect (1 there)."""
        cfg = self.cfg
        b = self.batch_spec(global_batch)
        taken = set(b or ())
        seq = None
        act_seq_axes = self.act_seq_axes if use_seq_sharding else None
        if act_seq_axes and seq_len % self.axis_size(act_seq_axes) == 0:
            seq = act_seq_axes
        aon = self._axes_or_none
        hints: Dict[str, Any] = {"act": P(aon(b), aon(seq), None)}
        v = self.fit(cfg.padded_vocab, self.model_candidates, taken)
        hints["logits"] = P(aon(b), None, aon(v))
        if cfg.moe is not None:
            # experts over the model axis when divisible; the capacity dim
            # always over the data axes (it is a token dim)
            e = self.fit(cfg.moe.n_experts, self.model_candidates, set())
            c_axes = self.dp_candidates[0]
            hints["moe_ecd"] = P(aon(e), aon(c_axes), None)
            hints["moe_gather"] = P(aon(c_axes), None, None)
            hints["moe_groups"] = self.axis_size(c_axes)
            hints["moe_grp"] = P(aon(c_axes), None, None, None)
        hints["state_b"] = P(aon(b), None)
        return hints
