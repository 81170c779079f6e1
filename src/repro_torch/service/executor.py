"""Shard-round execution engines.

One service step produces at most one CAS round per shard; the executor
runs all of those rounds "concurrently".  For kernel shards concurrency
is real data parallelism: every shard round is padded to a common
``[B, K]`` shape, the shard word tables are stacked into ``[S, W]``, and
ONE launch of the batched MwCAS kernel (``pmwcas_apply_stacked``)
resolves every shard's round — the batched analogue of S cores retiring
their CAS rounds in the same cycle, and the reason service throughput
scales with shard count instead of paying one launch per shard.

Shards whose backend is not stackable (custom backends, or kernel
shards with mismatched table widths/devices) fall back to per-shard
``execute`` calls.

The stacked shapes are BUCKETED as in the reference (DESIGN.md Sec. 9.2):
S is the FULL kernel shard group (shards with no round this wave ride
along as all-padding rows), B is the scheduler's ``round_cap``, K is the
next power of two.  PyTorch runs eagerly, so a new bucket costs no
recompile here, but ``DispatchStats`` keeps the reference's accounting —
``traces`` counts the distinct ``[S, B, K, W]`` buckets seen — so the
two packages' stats compare equal.  This slice stacks the shard tables
into a fresh ``[S, W]`` tensor every wave and writes the rows back; the
persistent stacked table is ROADMAP Queue 1 #5.

Round FORMATION also lives here (:func:`build_rounds`): the service's
conflict-defer rule — an op whose targets collide with an op already in
this round's claim set is pushed to the NEXT round instead of being
executed-to-lose.  Under the deterministic one-shot semantics a
duplicate-target op is guaranteed to fail condition (b), so executing it
would burn batch slots and CAS work on a known outcome; deferral keeps
every submitted CAS a potential winner (the paper's fewer-CASes lever,
applied at the batching layer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.obs import span
from repro_torch.pmwcas import (Backend, KernelBackend, MwCASOp,
                                claim_scratch, ops_to_arrays,
                                pmwcas_apply_stacked, words_to_tensor)


@dataclasses.dataclass
class DispatchStats:
    """Shape-bucket accounting for the stacked kernel dispatch.

    ``traces`` counts dispatches whose ``[S, B, K]`` (+ table width)
    bucket had never been seen by this executor — in the reference each
    one is an XLA recompile, here only a new launch shape.  ``hits`` are
    dispatches in an already-seen bucket; a steady-state service must
    add ZERO new buckets.  ``bytes_padded`` is what shape
    stability costs: pad cells shipped to the device per dispatch
    (addr+exp+des, 4 bytes each)."""
    traces: int = 0
    hits: int = 0
    dispatches: int = 0          # stacked device calls issued
    serial_rounds: int = 0       # rounds executed by per-shard fallback
    bytes_padded: int = 0

    def as_row(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def build_rounds(queues: Dict[int, Sequence], round_cap: int
                 ) -> Tuple[Dict[int, list], Dict[int, list],
                            Dict[int, int], Dict[int, int]]:
    """Form one conflict-free round per shard from FIFO queues.

    ``queues`` maps shard -> sequence of entries, each entry an object
    with a ``local`` attribute (a shard-local :class:`MwCASOp`).
    Returns ``(rounds, leftovers, defers, overflows)``:
    ``rounds[s]`` the entries scheduled this round, ``leftovers[s]`` the
    entries to retry next round (conflict-deferred or over ``round_cap``,
    original order preserved), and the two defer counters per shard.
    """
    rounds: Dict[int, list] = {}
    leftovers: Dict[int, list] = {}
    defers: Dict[int, int] = {}
    overflows: Dict[int, int] = {}
    for shard, queue in queues.items():
        claimed: set = set()
        sched, later = [], []
        n_defer = n_over = 0
        for entry in queue:
            targets = set(entry.local.addrs)
            if targets & claimed:
                n_defer += 1           # conflict-defer wins the attribution
                later.append(entry)
            elif len(sched) >= round_cap:
                n_over += 1
                later.append(entry)
            else:
                claimed |= targets
                sched.append(entry)
        if sched:
            rounds[shard] = sched
        if later:
            leftovers[shard] = later
        defers[shard] = n_defer
        overflows[shard] = n_over
    return rounds, leftovers, defers, overflows


def schedule_wave(queues: Dict[int, Sequence], round_cap: int, stats
                  ) -> Tuple[Dict[int, list], Dict[int, list]]:
    """:func:`build_rounds` plus defer/overflow accounting into a
    :class:`~repro_torch.service.ServiceStats` — the wave-formation step both
    the raw scheduler and the KV front run."""
    rounds, leftovers, defers, overflows = build_rounds(queues, round_cap)
    for s, n in defers.items():
        stats.shards[s].defers += n
    for s, n in overflows.items():
        stats.shards[s].overflows += n
    return rounds, leftovers


def execute_wave(executor, backends: Sequence[Backend],
                 rounds: Dict[int, Sequence], stats
                 ) -> Dict[int, List[Tuple[object, bool]]]:
    """Run one wave of formed shard rounds and record the per-shard
    round/CAS accounting; returns ``{shard: [(entry, won)]}`` for the
    caller to complete futures / requeue losers from."""
    verdicts = executor.execute(
        backends, {s: [p.local for p in entries]
                   for s, entries in rounds.items()})
    stats.dispatch = getattr(executor, "stats", None)
    out: Dict[int, List[Tuple[object, bool]]] = {}
    for s, entries in rounds.items():
        st = stats.shards[s]
        st.rounds += 1
        st.ops_executed += len(entries)
        pairs = []
        for ok, entry in zip(verdicts[s], entries):
            if ok:
                st.ops_won += 1
            pairs.append((entry, bool(ok)))
        out[s] = pairs
    return out


class SerialShardExecutor:
    """Reference engine: one ``backend.execute`` call per shard round."""

    name = "serial"

    def __init__(self):
        self.stats = DispatchStats()

    def execute(self, backends: Sequence[Backend],
                rounds: Dict[int, List[MwCASOp]]) -> Dict[int, List[bool]]:
        out: Dict[int, List[bool]] = {}
        for shard, ops in rounds.items():
            with span("executor.serial_round", shard=shard, ops=len(ops)):
                verdicts = backends[shard].execute(ops)
            out[shard] = [bool(r.success) for r in verdicts]
            self.stats.serial_rounds += 1
        return out


class StackedKernelExecutor:
    """Kernel shard rounds in ONE kernel launch; serial fallback for
    everything else.  ``last_stacked`` records how many shard rounds the
    most recent call actually stacked (tests and benches read it).

    The dispatch is pinned to SHAPE BUCKETS ``[S, B_bucket, K_bucket]``
    (the reference's trace-cache discipline, kept for equal stats):

    - **S** is the whole kernel shard group, every wave — a shard with
      no round this wave rides along as all-padding rows rather than
      shrinking the stack;
    - **B_bucket** is ``round_cap`` when known (rounds never exceed it),
      else the next power of two of the widest round;
    - **K_bucket** is the next power of two of the widest op.

    Padded rows/slots are ``addr = -1`` no-ops.  The kernel updates the
    stacked word-table temporary in place and each shard takes its row
    back; the kernel's claim scratch is kept per shard group.
    ``stats``/:class:`DispatchStats` counts new buckets vs hits plus the
    padding bytes bucketing ships — steady-state waves must be all hits.
    """

    name = "stacked"

    def __init__(self, round_cap: Optional[int] = None):
        self._serial = SerialShardExecutor()
        self.round_cap = round_cap
        self.last_stacked = 0
        self.stacked_dispatches = 0
        self.stats = DispatchStats()
        self._shapes: Set[Hashable] = set()     # buckets seen so far
        self._claims: Dict[Hashable, torch.Tensor] = {}

    @staticmethod
    def _group_key(backend: KernelBackend) -> Hashable:
        return (backend.n_words, backend.device)

    def execute(self, backends: Sequence[Backend],
                rounds: Dict[int, List[MwCASOp]]) -> Dict[int, List[bool]]:
        # group EVERY kernel shard (not just those with a round this
        # wave): group membership fixes the stacked S axis
        groups: Dict[Hashable, List[int]] = {}
        rest: Dict[int, List[MwCASOp]] = {}
        for shard, b in enumerate(backends):
            if isinstance(b, KernelBackend):
                groups.setdefault(self._group_key(b), []).append(shard)
        for shard, ops in rounds.items():
            if not isinstance(backends[shard], KernelBackend):
                rest[shard] = ops
        out: Dict[int, List[bool]] = {}
        self.last_stacked = 0
        for key, shards in groups.items():
            active = [s for s in shards if s in rounds]
            if not active:
                continue
            if len(shards) < 2:
                # a lone kernel shard gains nothing from stacking
                rest[shards[0]] = rounds[shards[0]]
                continue
            n_words, device = key
            B = max(len(rounds[s]) for s in active)
            if self.round_cap and self.round_cap >= B:
                B = self.round_cap
            else:
                B = 1 << (B - 1).bit_length()    # capless: pow2 bucket
            K = max(op.k for s in active for op in rounds[s])
            K = 1 << (K - 1).bit_length()        # next power of two
            shape = (len(shards), B, K, n_words, device)
            if shape in self._shapes:
                self.stats.hits += 1
                traced = False
            else:
                self._shapes.add(shape)
                self.stats.traces += 1
                traced = True
            addr = np.full((len(shards), B, K), -1, np.int32)
            exp = np.zeros((len(shards), B, K), np.uint32)
            des = np.zeros((len(shards), B, K), np.uint32)
            for i, s in enumerate(shards):
                if s not in rounds:
                    continue
                a, e, d = ops_to_arrays(rounds[s], K)
                addr[i, :a.shape[0]] = a
                exp[i, :a.shape[0]] = e
                des[i, :a.shape[0]] = d
            real_cells = sum(op.k for s in active for op in rounds[s])
            self.stats.bytes_padded += \
                (len(shards) * B * K - real_cells) * 3 * 4
            with span("executor.stacked_dispatch", shards=len(shards),
                      B=B, K=K, traced=traced):
                words = torch.stack([backends[s].word_table()
                                     for s in shards])
                claim_key = (key, len(shards))
                if claim_key not in self._claims:
                    self._claims[claim_key] = claim_scratch(words)
                _, success = pmwcas_apply_stacked(
                    words, words_to_tensor(addr, device),
                    words_to_tensor(exp, device),
                    words_to_tensor(des, device),
                    claim=self._claims[claim_key])
                success = success.cpu().numpy()
            for i, s in enumerate(shards):
                backends[s].set_word_table(words[i])
                if s in rounds:
                    out[s] = [bool(v)
                              for v in success[i, :len(rounds[s])]]
            self.last_stacked += len(active)
            self.stacked_dispatches += 1
            self.stats.dispatches += 1
        if rest:
            out.update(self._serial.execute(backends, rest))
            self.stats.serial_rounds += len(rest)
        return out


def select_executor(backends: Sequence[Backend], stack_kernel: bool = True,
                    round_cap: Optional[int] = None):
    """Stacked engine whenever >= 2 shards are kernel-backed; pass the
    scheduler's ``round_cap`` so stacked shapes stay compile-stable."""
    n_kernel = sum(isinstance(b, KernelBackend) for b in backends)
    if stack_kernel and n_kernel >= 2:
        return StackedKernelExecutor(round_cap)
    return SerialShardExecutor()
