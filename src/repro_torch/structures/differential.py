"""Cross-backend differential execution for structure workloads.

``repro_torch.pmwcas.run_differential`` checks one hand-built increment
batch; this module raises the stakes: an entire *logical* workload — a
hash map's or the multi-node BzTree's, splits and root splits included —
runs to completion on the kernel backend and the durable backend, the
two must agree op for op, and every executed CAS round is additionally
replayed NATIVELY through the cycle-accurate simulator — the real ops,
real expected/desired payloads (keys, values, TOMBSTONEs), mixed widths
and all (``SimBackend``'s per-batch value codec + internal padding).
Each round seeds a fresh sim from the round's pre-state and must
reproduce both the verdicts and the post-round word values.
:func:`replay_rounds` also replays a recorded history on a fresh
:class:`KernelBackend` — the kernel's rounds against its plain PyTorch
version on the CPU, verdicts and post-round words.

Verdicts are compared with the simulator whenever the conservative and
winner-blocking semantics provably coincide for that round's sharing
graph (computed combinatorially below); rounds where they diverge are
counted but not asserted — that divergence is a documented property of
the substrates (DESIGN.md Sec. 3.2), not a bug.

:func:`shadow_batch` — the increment-over-fresh-words translation of a
round onto the simulator's vocabulary — is kept for the simulator crash
sweep and for callers that build shadow rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.pmwcas import (Algorithm, DurableBackend, KernelBackend,
                                MwCASOp, OURS, SimBackend, resolve_device)

from .hashmap import HashMap, KVOp, RoundTrace


def conservative_verdicts(ops: Sequence[MwCASOp]) -> np.ndarray:
    """Kernel/durable semantics for an all-(a)-passing batch: op i loses
    iff a lower-index op (passing (a), i.e. any op here) shares an
    address — every (a)-passer claims its addresses."""
    claimed: set = set()
    out = []
    for op in ops:
        blocked = any(a in claimed for a in op.addrs)
        claimed.update(op.addrs)
        out.append(not blocked)
    return np.asarray(out)


def winner_blocking_verdicts(ops: Sequence[MwCASOp]) -> np.ndarray:
    """Simulator semantics: only actual winners keep their claims (a
    loser's reservations roll back before the next attempt starts)."""
    claimed: set = set()
    out = []
    for op in ops:
        ok = not any(a in claimed for a in op.addrs)
        if ok:
            claimed.update(op.addrs)
        out.append(ok)
    return np.asarray(out)


def shadow_batch(ops: Sequence[MwCASOp]) -> tuple:
    """Map a round onto the simulator's vocabulary: compress the round's
    addresses to 0..n-1 and turn every op into an increment (0 -> 1)
    over its compressed address set.  Returns (n_shadow_words, ops).

    Mixed-width rounds (the tree batches 3-word inserts next to 2-word
    updates) are padded to one uniform width with FRESH private words —
    the simulator requires a uniform k per batch, and a private word is
    invisible to the conflict graph, so verdicts are unchanged.  Padding
    words are appended above the compressed range, preserving each op's
    canonical sorted address order."""
    addrs = sorted({a for op in ops for a in op.addrs})
    index = {a: i for i, a in enumerate(addrs)}
    k_max = max(op.k for op in ops)
    shadow = []
    next_pad = len(addrs)
    for op in ops:
        compressed = sorted(index[a] for a in op.addrs)
        pad = list(range(next_pad, next_pad + k_max - op.k))
        next_pad += len(pad)
        shadow.append(MwCASOp.increment(compressed + pad, [0] * k_max))
    return next_pad, shadow


@dataclasses.dataclass
class StructDifferentialReport:
    kvops: List[KVOp]
    statuses: Dict[str, List[str]]        # backend -> per-logical-op status
    items: Dict[str, Dict[int, int]]      # backend -> final live k/v pairs
    rounds: Dict[str, int]                # backend -> CAS rounds executed
    sim_rounds_checked: int               # rounds asserted against sim
    sim_rounds_skipped: int               # rounds where semantics diverge
    agree: bool
    # backend -> the structure after the run (its tables, counters and
    # ``last_history``), for callers that check more than the verdicts
    structs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        lines = [f"struct differential over {len(self.kvops)} logical ops: "
                 f"{'AGREE' if self.agree else 'DISAGREE'}"]
        for name, st in self.statuses.items():
            ok = sum(1 for s in st if s == "ok")
            lines.append(f"  {name:8s} ok={ok}/{len(st)} "
                         f"rounds={self.rounds.get(name)}")
        lines.append(f"  sim shadow: {self.sim_rounds_checked} rounds "
                     f"checked, {self.sim_rounds_skipped} where "
                     "winner-blocking != conservative")
        return "\n".join(lines)


def replay_rounds(history: Sequence[RoundTrace], *,
                  device: Union[str, torch.device]) -> Tuple[int, bool]:
    """Replay every recorded round on a fresh :class:`KernelBackend` on
    ``device`` (``"cpu"``: against the plain PyTorch version); returns
    ``(rounds replayed, all matched)``.

    Each round's pre-state is rebuilt from the ops' expected values
    (every round op passed condition (a), so they are mutually
    consistent) and the same ops run again: the verdicts must equal the
    recorded ones and every touched word must hold its post-round value
    (a winner's desired value, else the pre-round value)."""
    dev = resolve_device(device)
    matched = True
    for trace in history:
        pre: Dict[int, int] = {}
        for op in trace.ops:
            for t in op.targets:
                pre[t.addr] = t.expected
        values = np.zeros(max(pre) + 1, np.uint32)
        for a, v in pre.items():
            values[a] = v
        backend = KernelBackend(values=values, device=dev)
        verdicts = np.asarray([r.success for r in backend.execute(trace.ops)])
        if not np.array_equal(verdicts, np.asarray(trace.success)):
            matched = False
            continue
        post = dict(pre)
        for ok, op in zip(trace.success, trace.ops):
            if ok:
                for t in op.targets:
                    post[t.addr] = t.desired
        table = backend.values()
        if any(int(table[a]) != v for a, v in post.items()):
            matched = False
    return len(history), matched


def _replay_rounds_on_sim(history: List[RoundTrace],
                          algorithm: Union[str, Algorithm],
                          device: torch.device) -> tuple:
    """Natively replay every executed round through SimBackend on
    ``device``; returns (checked, skipped, all_matched).

    Each round's pre-state is reconstructed from the ops' expected
    values (every round op passed condition (a), so expecteds are
    mutually consistent) and the REAL ops run on the micro-op machines —
    actual desired payloads, mixed widths, guard words.  A checked round
    must reproduce the verdicts *and* the post-round values at every
    touched word."""
    checked = skipped = 0
    matched = True
    for trace in history:
        cons = conservative_verdicts(trace.ops)
        wb = winner_blocking_verdicts(trace.ops)
        if not np.array_equal(cons, wb):
            skipped += 1
            continue
        pre: Dict[int, int] = {}
        for op in trace.ops:
            for t in op.targets:
                pre[t.addr] = t.expected
        n_words = max(pre) + 1
        values = np.zeros(n_words, np.uint32)
        for a, v in pre.items():
            values[a] = v
        sim = SimBackend(n_words, algorithm=algorithm, values=values,
                         device=device)
        verdicts = np.asarray([r.success for r in sim.execute(trace.ops)])
        checked += 1
        if not np.array_equal(verdicts, np.asarray(trace.success)):
            matched = False
            continue
        # post-round values: a winner's targets moved to desired, every
        # other touched word still holds its pre-round value
        post = dict(pre)
        for ok, op in zip(trace.success, trace.ops):
            if ok:
                for t in op.targets:
                    post[t.addr] = t.desired
        if any(sim.read(a) != v for a, v in post.items()):
            matched = False
    return checked, skipped, matched


def run_struct_differential(kvops: Sequence[KVOp], n_buckets: int = 0, *,
                            structure: str = "hashmap",
                            algorithm: Union[str, Algorithm] = OURS,
                            durable_root=None,
                            device: Union[str, torch.device] = "cuda",
                            max_rounds: Optional[int] = None,
                            max_doublings: int = 0,
                            leaf_cap: int = 4, root_cap: int = 8,
                            n_regions: int = 8
                            ) -> StructDifferentialReport:
    """One logical workload on kernel + durable backends, with every
    kernel round shadow-verified on the simulator (``algorithm``).
    Agreement means: identical per-op statuses, identical final live
    items, identical round counts, and every shadow-checked round's
    verdicts and post-round values match.

    ``structure`` selects the structure under test: ``"hashmap"`` (size
    by ``n_buckets``; ``max_doublings > 0`` makes it elastic, so growth
    rounds — generation CASes, 4-word pump moves, guarded split-brain
    ops — run in kernel+durable lockstep) or ``"bztree"`` (the
    multi-node tree, sized by ``leaf_cap`` / ``root_cap`` /
    ``n_regions``; its splits, root splits included, are part of the
    history).  ``device`` places the kernel backend's table, the trees'
    region allocators and the simulator's state (``"cuda"``, the default,
    runs the Hopper kernels; ``"cpu"`` their plain versions)."""
    kvops = list(kvops)
    dev = resolve_device(device)
    if structure == "hashmap":
        if n_buckets < 1:
            raise ValueError("hashmap differential needs n_buckets >= 1")
        n_words = HashMap.words_needed(n_buckets, max_doublings)

        def make(backend):
            return HashMap(backend, n_buckets, max_doublings=max_doublings)
    elif structure == "bztree":
        from .bztree_index import BzTreeIndex
        n_words = BzTreeIndex.words_needed(leaf_cap, root_cap, n_regions)

        def make(backend):
            return BzTreeIndex(backend, leaf_cap=leaf_cap,
                               root_cap=root_cap, n_regions=n_regions,
                               device=dev)
    else:
        raise ValueError(f"unknown structure {structure!r}; "
                         "expected 'hashmap' or 'bztree'")
    kernel = KernelBackend(n_words=n_words, device=dev)
    durable = DurableBackend(durable_root)
    structs = {"kernel": make(kernel), "durable": make(durable)}

    statuses: Dict[str, List[str]] = {}
    items: Dict[str, Dict[int, int]] = {}
    rounds: Dict[str, int] = {}
    for name, struct in structs.items():
        results = struct.apply(kvops, max_rounds=max_rounds)
        statuses[name] = [r.status for r in results]
        items[name] = struct.check_integrity()
        rounds[name] = struct.rounds_run

    checked, skipped, sim_ok = _replay_rounds_on_sim(
        structs["kernel"].last_history, algorithm, dev)
    agree = (statuses["kernel"] == statuses["durable"]
             and items["kernel"] == items["durable"]
             and rounds["kernel"] == rounds["durable"]
             and sim_ok)
    return StructDifferentialReport(
        kvops=kvops, statuses=statuses, items=items, rounds=rounds,
        sim_rounds_checked=checked, sim_rounds_skipped=skipped, agree=agree,
        structs=structs)
