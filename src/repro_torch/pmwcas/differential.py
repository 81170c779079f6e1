"""Cross-backend differential execution: the same ``MwCASOp`` batch runs
through the simulator, the batched kernel and the durable committer, and
the per-op success verdicts (plus final word values) must agree.

This is the payoff of the unified operation model: the three
implementations of the paper's algorithm check each other.  On a CUDA
device the simulator side is one launch of the simulator kernel
(``csrc/pmwcas_sim.cu``) and the kernel side the hand-written PMwCAS
kernel (``csrc/pmwcas_apply.cu``, on the route its plan picks from the
batch's ``[B, K]``), with no fallback; on the CPU both are their plain
versions.  The durable side is host code over a
:class:`repro_torch.checkpoint.PMemPool`.

Batch construction caveat (see the backends module docstring): the
simulator executes one attempt per op with winner-blocking conflict
semantics, while kernel/durable use the conservative one-shot verdict.
The two coincide whenever every pair of address-sharing ops involves an
actual winner; :func:`increment_batch` builds batches with that
property.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from .algorithms import Algorithm, OURS
from .backends import (DurableBackend, KernelBackend, SimBackend,
                       resolve_device)
from .descriptor import MwCASOp


@dataclasses.dataclass
class DifferentialReport:
    ops: List[MwCASOp]
    verdicts: Dict[str, np.ndarray]        # backend name -> bool[B]
    values: Dict[str, np.ndarray]          # backend name -> final word values
    agree: bool

    def summary(self) -> str:
        lines = [f"differential over {len(self.ops)} ops: "
                 f"{'AGREE' if self.agree else 'DISAGREE'}"]
        for name, v in self.verdicts.items():
            lines.append(f"  {name:8s} verdicts={v.astype(int).tolist()}")
        return "\n".join(lines)


def increment_batch(n_words: int, k: int, n_ops: int,
                    seed: int = 0) -> tuple:
    """A random increment batch whose conflict graph only contains
    winner-involving edges (sim == kernel == durable verdicts).

    Strategy: ops are built in index order; an op either reuses addresses
    of the current round's *winner set* (guaranteed conflict with a
    winner) or draws fresh untouched addresses (guaranteed win).  Returns
    (initial_values, ops).
    """
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 7, n_words).astype(np.uint32)
    winners_addrs: set = set()
    free = list(range(n_words))
    rng.shuffle(free)
    ops = []
    for i in range(n_ops):
        conflict = winners_addrs and rng.random() < 0.5
        if conflict and len(winners_addrs) >= 1 and len(free) >= k - 1:
            stolen = rng.choice(sorted(winners_addrs))
            fresh = [free.pop() for _ in range(k - 1)]
            addrs = sorted([int(stolen)] + fresh)
        elif len(free) >= k:
            addrs = sorted(free.pop() for _ in range(k))
            winners_addrs.update(addrs)
        else:
            break
        ops.append(MwCASOp.increment(addrs, [int(initial[a])
                                             for a in addrs]))
    return initial, ops


def run_differential(ops: Sequence[MwCASOp],
                     initial_values: Sequence[int], *,
                     algorithm: Union[str, Algorithm] = OURS,
                     durable_root=None,
                     device: Union[str, torch.device] = "cuda"
                     ) -> DifferentialReport:
    """Execute one batch on all three backends and compare outcomes.
    ``device`` places the simulator's and the kernel's state (``"cuda"``,
    the default, runs the two Hopper kernels and raises without a card;
    ``"cpu"`` runs their plain versions)."""
    initial = np.asarray(initial_values, np.uint32)
    n_words = len(initial)
    addrs = sorted({a for op in ops for a in op.addrs})
    dev = resolve_device(device)

    kernel = KernelBackend(values=initial, device=dev)
    sim = SimBackend(n_words, algorithm=algorithm, values=initial,
                     device=dev)
    durable = DurableBackend(durable_root)
    durable.seed({a: int(initial[a]) for a in addrs})

    verdicts: Dict[str, np.ndarray] = {}
    values: Dict[str, np.ndarray] = {}
    for backend in (sim, kernel, durable):
        results = backend.execute(list(ops))
        verdicts[backend.name] = np.asarray([r.success for r in results])
        if backend is kernel:
            table = kernel.values()
            values[backend.name] = np.asarray([table[a] for a in addrs],
                                              np.int64)
        else:
            values[backend.name] = np.asarray(
                [backend.read(a) for a in addrs], np.int64)

    names = list(verdicts)
    agree = all(
        np.array_equal(verdicts[names[0]], verdicts[n]) and
        np.array_equal(values[names[0]], values[n])
        for n in names[1:])
    return DifferentialReport(ops=list(ops), verdicts=verdicts,
                              values=values, agree=agree)
