"""A mesh's process group, and where each rank's shard of a tensor lies.

A :class:`~repro_torch.parallel.sharding.Mesh` of ``n`` devices runs as
``n`` ranks, one process a device, laid out row-major over the mesh's
axes (rank ``r`` of ``Mesh((2, 2), ("data", "model"))`` sits at
``data = r // 2``, ``model = r % 2``), as a ``DeviceMesh`` lays them out.
:func:`init_mesh_group` starts the process group (NCCL for a card, gloo
on the CPU) through a ``FileStore`` at a path the caller gives, and one
subgroup for every set of the mesh's axes over which some spec shards:
the ranks that differ only along those axes, ordered so that a rank's
place in its subgroup is its index along the axes taken together, the
first the slowest (``("pod", "data")``: ``pod * data_size + data``),
which is how a spec entry with several axes splits a dimension.

:func:`local_shard` cuts a full tensor (or a ``meta`` one) to this rank's
shard of it under a spec; :func:`gather_full` puts the shards back
together through the collectives.  Both take ``blocks``
(:func:`~repro_torch.parallel.sharding.param_blocks`): Mamba's
``in_proj`` is ``[D, 2 d_in]``, the ``x`` half then the ``z`` half, and
each half is cut over the model axis on its own, so that a rank holds
``[x_r | z_r]``, the same bytes as a plain cut (which would give the
first ranks only ``x`` columns and the last only ``z`` columns).  :meth:`MeshGroup.trace` is a group
with no process group behind it, rank 0's coordinates only: the dry run
traces a mesh of 256 or 512 devices on ``meta`` tensors through it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.collectives import TP_AXES
from repro_torch.parallel.sharding import Mesh, axes_of
from repro_torch.pmwcas import resolve_device


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def coords_of(mesh: Mesh, rank: int) -> Dict[str, int]:
    """The mesh coordinates of ``rank`` (row-major, the last axis the
    fastest)."""
    out = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
        out[name] = rank % size
        rank //= size
    return {n: out[n] for n in mesh.axis_names}


def axis_sets(mesh: Mesh):
    """Every non-empty set of the mesh's axes of more than one device, in
    the mesh's order: the axes a subgroup can span."""
    names = [n for n, s in zip(mesh.axis_names, mesh.axis_sizes) if s > 1]
    for k in range(1, len(names) + 1):
        yield from itertools.combinations(names, k)


@dataclasses.dataclass
class MeshGroup:
    """One rank of a mesh: its rank, its device, and the process group of
    every set of axes it spans (:func:`axis_sets`; empty when tracing)."""
    mesh: Mesh
    rank: int
    device: torch.device
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def trace(cls, mesh: Mesh) -> "MeshGroup":
        """Rank 0 of ``mesh`` on the ``meta`` device, with no process
        group: its collectives record and return shapes only."""
        return cls(mesh, 0, torch.device("meta"))

    @property
    def coords(self) -> Dict[str, int]:
        return coords_of(self.mesh, self.rank)

    def size(self, axes: Sequence[str]) -> int:
        return _prod(self.mesh.shape[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` taken together, the first the
        slowest."""
        out, c = 0, self.coords
        for a in axes:
            out = out * self.mesh.shape[a] + c[a]
        return out

    def process_group(self, axes: Sequence[str]):
        """The subgroup over ``axes`` (only the axes of more than one
        device count)."""
        key = tuple(a for a in axes if self.mesh.shape[a] > 1)
        return self.groups[key]


def init_mesh_group(mesh: Mesh, rank: int, store_path, device="cuda"
                    ) -> MeshGroup:
    """Join ``mesh``'s process group as ``rank``: NCCL on the card
    ``cuda:rank`` (modulo the cards present) for a CUDA ``device``, gloo
    for the CPU; rendezvous through a ``FileStore`` at ``store_path``
    (every rank passes the same path; a file that no earlier group
    used).  A process already in a group of ``mesh.size`` ranks keeps it
    (another mesh of the same cards).  Every rank makes every subgroup,
    in one order, and sets each one's communicator up with a one-element
    all-reduce, so that no step pays for it."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        store = dist.FileStore(str(store_path), mesh.size)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=rank, world_size=mesh.size,
                                device_id=dev if dev.type == "cuda" else None)
    elif dist.get_world_size() != mesh.size or dist.get_rank() != rank:
        raise ValueError(f"this process is rank {dist.get_rank()} of "
                         f"{dist.get_world_size()}, not rank {rank} of "
                         f"{mesh.size}")
    groups = {}
    for axes in axis_sets(mesh):
        rest = [n for n in mesh.axis_names if n not in axes]
        for fixed in itertools.product(*(range(mesh.shape[n])
                                         for n in rest)):
            at = dict(zip(rest, fixed))
            ranks = [r for r in range(mesh.size)
                     if all(coords_of(mesh, r)[n] == i
                            for n, i in at.items())]
            pg = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = pg
    for pg in groups.values():     # each communicator made now, not mid-step
        dist.all_reduce(torch.zeros(1, device=dev), group=pg)
    return MeshGroup(mesh, rank, dev, groups)


def destroy_mesh_group() -> None:
    """Leave the process group :func:`init_mesh_group` joined."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _blocks(axes, blocks: int) -> int:
    """The blocks a dimension sharded over ``axes`` is cut in: ``blocks``
    along the model axes, one along any other."""
    return blocks if set(axes) & set(TP_AXES) else 1


def local_shard(full: torch.Tensor, spec: Sequence, group: MeshGroup,
                device: Optional[torch.device] = None,
                blocks: int = 1) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec``: each dimension
    sharded over axes of total size ``n`` cut to its ``index``-th
    ``1/n``; a dimension over the model axes made of ``blocks`` equal
    blocks side by side gets its ``1/n`` of each block, in order.  A copy
    of its own when anything was cut (a view would keep the full tensor
    alive), ``full`` itself when nothing was; moved to ``device`` when
    given."""
    out = full
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        n = group.size(axes)
        if n > 1:
            b = _blocks(axes, blocks)
            if full.shape[d] % (n * b):
                raise ValueError(f"{spec} does not divide "
                                 f"{tuple(full.shape)} on {group.mesh.shape}"
                                 f" in {b} block(s)")
            step = full.shape[d] // (n * b)
            out = out.unflatten(d, (b, n * step)).narrow(
                d + 1, group.index(axes) * step, step).flatten(d, d + 1)
    if out is not full:
        out = out.clone(memory_format=torch.contiguous_format)
    return out if device is None else out.to(device)


def gather_full(local: torch.Tensor, spec: Sequence, coll,
                blocks: int = 1) -> torch.Tensor:
    """The full tensor back from every rank's ``local`` shard under
    ``spec`` (cut with ``blocks``, as :func:`local_shard` cuts it),
    all-gathered through ``coll``
    (:class:`~repro_torch.parallel.collectives.Collectives`) over each
    sharded dimension's axes; every rank gets it."""
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if axes:
            local = coll.all_gather(local, axes, d, name="gather_full")
            n, b = coll.group.size(axes), _blocks(axes, blocks)
            if n > 1 and b > 1:      # [r, block, part] -> [block, r, part]
                local = local.unflatten(d, (n, b, -1)).transpose(
                    d, d + 1).flatten(d, d + 2)
    return local
