"""Execution backends for the canonical PMwCAS operation model.

This slice of the port has one backend, :class:`KernelBackend`: a word
table on a torch device plus the batched MwCAS primitive, which runs the
hand-written Hopper kernel on a CUDA table and its plain PyTorch version
on a CPU table.  The durable committer backend and the simulator backend
are ROADMAP Queue 1 #3 and #7; asking the factory for them raises.

Canonical batch semantics (DESIGN.md Sec. 3.2) — *deterministic one-shot*:
the batch executes against the pre-batch state with index order as the
linearization.  Op ``i`` succeeds iff

  (a) every target's expected value matches the pre-batch state, and
  (b) no lower-index op that also passes (a) targets a shared address.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.kernels.pmwcas_apply.ops import (pmwcas_apply,
                                                  tensor_to_words,
                                                  words_to_tensor)
from repro_torch.obs import span

from .descriptor import Addr, MwCASOp, OpResult, ops_to_arrays, \
    results_from_mask

# backend kinds of the reference that later slices port
_LATER = {"durable": "ROADMAP Queue 1 #3 (backends and the durable layer)",
          "sim": "ROADMAP Queue 1 #7 (the simulator)"}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it without a card raises rather than running
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; pass device='cpu' for the plain PyTorch version")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@runtime_checkable
class Backend(Protocol):
    """What every PMwCAS execution backend provides."""
    name: str

    def execute(self, ops: Sequence[MwCASOp]) -> List[OpResult]:
        """Run one batch under the deterministic one-shot semantics."""
        ...

    def read(self, addr: Addr) -> int:
        """Current committed value of one word/slot."""
        ...


class KernelBackend:
    """Word table on a torch device + the batched MwCAS primitive.

    The table holds the uint32 words as their int32 bit patterns;
    :meth:`read` and :meth:`values` give them back as uint32 values.
    """
    name = "kernel"

    def __init__(self, n_words: Optional[int] = None,
                 values: Optional[Sequence[int]] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if values is not None:
            self._words = words_to_tensor(np.asarray(values, np.uint32),
                                          self.device)
        elif n_words is not None:
            self._words = torch.zeros(n_words, dtype=torch.int32,
                                      device=self.device)
        else:
            raise ValueError("need n_words or values")

    # -- Backend protocol ------------------------------------------------------
    def execute(self, ops: Sequence[MwCASOp],
                k: Optional[int] = None) -> List[OpResult]:
        with span("mwcas.round", backend=self.name, ops=len(ops)):
            addr, exp, des = (words_to_tensor(a, self.device)
                              for a in ops_to_arrays(ops, k))
            _, success = pmwcas_apply(self._words, addr, exp, des)
            return results_from_mask(ops, success.cpu().numpy(), self.name)

    def read(self, addr: Addr) -> int:
        if not isinstance(addr, int):
            raise TypeError(f"kernel backend uses int addresses, got {addr!r}")
        return int(self._words[addr]) & 0xFFFFFFFF

    def values(self) -> np.ndarray:
        """A host copy of the table as uint32 words."""
        return tensor_to_words(self._words)

    # -- sharded-service surface ----------------------------------------------
    @property
    def n_words(self) -> int:
        return int(self._words.shape[0])

    def word_table(self) -> torch.Tensor:
        """The live device word table (int32[W] bit patterns).  Under the
        sharded service's stacked dispatch it is a view of this shard's
        row of one persistent ``[S, W]`` tensor (:meth:`bind_row`), which
        ONE kernel launch per wave updates in place for every shard."""
        return self._words

    def set_word_table(self, new: torch.Tensor) -> None:
        """Overwrite the table with ``new`` (copied into the live table,
        so a view bound by :meth:`bind_row` stays bound).  Must match
        :meth:`word_table` in shape, dtype and device."""
        self._check_like(new)
        self._words.copy_(new)

    def bind_row(self, row: torch.Tensor) -> None:
        """Move the table into ``row``, a view of a caller's persistent
        stacked tensor: the current words are copied in once, and from
        then on every read, round and :meth:`set_word_table` works on
        the view."""
        self._check_like(row)
        row.copy_(self._words)
        self._words = row

    def _check_like(self, t: torch.Tensor) -> None:
        if t.shape != self._words.shape or t.dtype != torch.int32 \
                or t.device != self._words.device:
            raise ValueError(
                f"word table {tuple(t.shape)} {t.dtype} on "
                f"{t.device} != {tuple(self._words.shape)} int32 on "
                f"{self._words.device}")


# ===========================================================================
# Backend factory hooks (the sharded service builds per-shard backends
# through this registry, so deployments can plug in their own substrate)
# ===========================================================================

def _make_kernel(n_words: Optional[int] = None, **kw) -> KernelBackend:
    return KernelBackend(n_words=n_words, **kw)


BACKEND_FACTORIES: Dict[str, Callable[..., Backend]] = {
    "kernel": _make_kernel,
}


def register_backend(name: str, factory: Callable[..., Backend],
                     replace: bool = False) -> None:
    """Register a custom backend factory under ``name`` (usable anywhere
    a backend kind string is accepted, e.g. ``KVService(backend=name)``).
    The factory must accept ``n_words`` as a keyword (ignore it if the
    substrate is not array-shaped)."""
    if name in BACKEND_FACTORIES and not replace:
        raise ValueError(f"backend kind {name!r} already registered")
    BACKEND_FACTORIES[name] = factory


def make_backend(spec: Union[str, Callable[..., Backend], Backend],
                 **kw) -> Backend:
    """Resolve a backend spec into an instance.

    ``spec`` may be a registered kind name (``"kernel"`` / anything added
    via :func:`register_backend`), a callable factory (called with the
    keyword arguments), or an existing :class:`Backend` instance
    (returned as-is; passing construction kwargs alongside an instance
    is an error).
    """
    if isinstance(spec, str):
        factory = BACKEND_FACTORIES.get(spec)
        if factory is not None:
            return factory(**kw)
        if spec in _LATER:
            raise NotImplementedError(
                f"backend kind {spec!r} is not ported yet: {_LATER[spec]}")
        raise ValueError(f"unknown backend kind {spec!r}; registered: "
                         f"{sorted(BACKEND_FACTORIES)}")
    # classes pass the runtime Protocol check (their *attributes* exist on
    # the class object), so treat any type as a factory first
    if not isinstance(spec, type) and isinstance(spec, Backend):
        if kw:
            raise ValueError(
                f"cannot apply kwargs {sorted(kw)} to an existing "
                "backend instance")
        return spec
    if callable(spec):
        return spec(**kw)
    raise TypeError(f"backend spec {spec!r} is not a kind name, factory "
                    "or Backend")
