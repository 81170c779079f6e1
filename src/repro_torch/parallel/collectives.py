"""The collectives a sharded program issues, recorded as they are issued.

:class:`Collectives` holds one rank's all-gather, all-reduce and
reduce-scatter over the axes of its mesh
(:class:`~repro_torch.parallel.group.MeshGroup`).  Every call appends a
:class:`Record`: its kind, its mesh axes, its name and its per-device
output bytes, the reference dry run's "output-shape proxy"
(``repro/launch/dryrun.py::collective_bytes``), so the port's numbers
mean what the reference's mean.  A call over axes of one device is no
collective: it returns its input and records nothing.  On ``meta``
tensors a call only records and returns a ``meta`` result of the output's
shape, which is how the dry run traces a mesh of 256 or 512 devices
without one.  ``timed=True`` brackets every call on a card with CUDA
events (:meth:`Collectives.seconds` reads them).

:class:`Spmd` is a model's view of its rank: the spec of every parameter,
the FSDP all-gather of a parameter before use (every axis but the model
axis gathered; the caller drops the result after use), the all-reduce
over the model axis after a row-parallel product (each named for the
product it serves: ``attn/wo``, ``mlp/wo``, ``embed/embedding``, ``moe``,
``mamba/x_proj``, ``mamba/out_proj``), and the rank's slice of a count
split evenly over the model axis (its experts).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.parallel.sharding import P, axes_of

# the reference's five kinds (``repro/launch/dryrun.py::_COLLECTIVES``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# the tensor-parallel axes: heads, the MLP's hidden width and the
# vocabulary split over these; every other axis of a parameter is FSDP
TP_AXES = ("model",)


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective: ``kind`` (one of :data:`KINDS`), the mesh ``axes``
    it runs over, its ``name`` (the parameter or product it serves) and
    ``bytes``, its per-device output bytes."""
    kind: str
    axes: Tuple[str, ...]
    name: str
    bytes: int


def tally(records: Sequence[Record]) -> Dict[str, Dict[str, int]]:
    """Per-device bytes and counts of each of :data:`KINDS`, and their
    total bytes."""
    out = {"bytes": dict.fromkeys(KINDS, 0), "counts": dict.fromkeys(KINDS, 0)}
    for r in records:
        out["bytes"][r.kind] += r.bytes
        out["counts"][r.kind] += 1
    out["total_bytes"] = sum(out["bytes"].values())
    return out


def _op(name: str):
    import torch.distributed as dist
    new = {"all_gather": "all_gather_single",
           "reduce_scatter": "reduce_scatter_single"}[name]
    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[name]
    return getattr(dist, new, None) or getattr(dist, old)


class Collectives:
    """One rank's named collectives over ``group``'s axes; ``records``
    lists every call since :meth:`reset`."""

    def __init__(self, group, timed: bool = False):
        self.group = group
        self.timed = timed and group.device.type == "cuda"
        self.records: List[Record] = []
        self._events: list = []

    def reset(self) -> None:
        self.records = []
        self._events = []

    def seconds(self) -> float:
        """Stream time of the timed calls since :meth:`reset`
        (synchronizes the card)."""
        if not self._events:
            return 0.0
        torch.cuda.synchronize(self.group.device)
        return sum(a.elapsed_time(b) for a, b in self._events) / 1e3

    def _issue(self, kind, axes, name, out):
        self.records.append(Record(kind, tuple(axes), name,
                                   out.numel() * out.element_size()))

    @contextlib.contextmanager
    def _timer(self):
        if not self.timed:
            yield
            return
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        yield
        b.record()
        self._events.append((a, b))

    def all_gather(self, t: torch.Tensor, axes: Sequence[str], dim: int,
                   name: str = "") -> torch.Tensor:
        """The shards of every rank along ``axes`` concatenated along
        ``dim``, in the ranks' order along the axes."""
        n = self.group.size(axes)
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        if t.device.type == "meta":
            out = t.new_empty(shape)
        else:
            buf = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            with self._timer():
                _op("all_gather")(buf, t.contiguous(),
                                  group=self.group.process_group(axes))
            out = (buf if dim == 0 else
                   torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0),
                             dim=dim))
        self._issue("all-gather", axes, name, out)
        return out

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   name: str = "") -> torch.Tensor:
        """The sum over the ranks along ``axes``, in ``t``'s dtype (in
        place where ``t`` is contiguous)."""
        if self.group.size(axes) == 1:
            return t
        if t.device.type != "meta":
            import torch.distributed as dist
            t = t.contiguous()
            with self._timer():
                dist.all_reduce(t, group=self.group.process_group(axes))
        self._issue("all-reduce", axes, name, t)
        return t

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str],
                       dim: int, name: str = "") -> torch.Tensor:
        """The sum over the ranks along ``axes``, each rank keeping its
        ``1/n`` of dimension ``dim``."""
        n = self.group.size(axes)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways")
        shape = list(t.shape)
        shape[dim] //= n
        if t.device.type == "meta":
            out = t.new_empty(shape)
        else:
            src = torch.cat(t.chunk(n, dim=dim), dim=0).contiguous()
            out = t.new_empty(shape)
            with self._timer():
                _op("reduce_scatter")(out, src,
                                      group=self.group.process_group(axes))
        self._issue("reduce-scatter", axes, name, out)
        return out


class Spmd:
    """A model's rank of a sharded program: ``coll``, its collectives;
    ``pspecs``, the spec of every parameter by name.  Heads, the MLP's
    hidden width, the vocabulary, the experts and Mamba's inner channels
    are split over :data:`TP_AXES`."""

    def __init__(self, coll: Collectives, pspecs: Dict[str, P]):
        self.coll = coll
        self.pspecs = pspecs
        self.tp = coll.group.size(TP_AXES)
        self.tp_index = coll.group.index(TP_AXES)

    def param(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name``'s local shard with every axis but the model
        axes all-gathered (FSDP): the weight this rank computes with."""
        for d, entry in enumerate(self.pspecs[name]):
            axes = tuple(a for a in axes_of(entry) if a not in TP_AXES)
            if axes:
                t = self.coll.all_gather(t, axes, d, name=name)
        return t

    def reduce(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of a row-parallel product's partial results over the
        model axes."""
        return self.coll.all_reduce(t, TP_AXES, name=name)

    def local_range(self, n: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's share of ``n`` items split
        evenly over the model axes (its experts)."""
        if n % self.tp:
            raise ValueError(f"{n} does not split {self.tp} ways")
        step = n // self.tp
        return self.tp_index * step, (self.tp_index + 1) * step
