"""Async batched MwCAS scheduling over sharded backends.

``BatchScheduler`` is the raw-op layer of the service: N logical clients
``submit`` :class:`MwCASOp`\\ s (global addresses) and get futures; the
scheduler routes each op to its shard, coalesces queued ops into
conflict-free per-shard rounds, executes all shard rounds in one wave
(kernel shards through the single stacked dispatch), and completes the
futures with per-op :class:`OpResult` verdicts.

Scheduling rules:

- **conflict-defer**: an op whose targets collide with an op already
  scheduled in this round is deferred to the next round, not executed
  to certain (b)-failure — deferral is invisible to the client except
  as latency (measured in rounds).
- **at-most-one execution**: every submission is executed exactly once;
  a CAS that fails condition (a) (stale expected values) completes its
  future with ``success=False``.  Retry policy belongs to the caller —
  the KV front (`repro_torch.service.KVService`) recompiles and resubmits.
- **cross-shard serialization**: ops whose targets span shards execute
  in a dedicated GLOBAL round — one at a time, with no concurrent shard
  rounds — so multi-word atomicity is never split across interleavings.
  With durable shards, atomicity across a *crash* additionally needs the
  decision log (:class:`repro_torch.service.CrossShardJournal`): pass
  one, and call :meth:`recover` after re-attaching crashed shards.
- **epoch durability is bounded-loss at this layer**: unlike the KV
  front (which withholds acks behind open epochs), the raw scheduler
  completes futures at commit time — under ``epoch_rounds > 1`` a
  completed-but-unsynced op can be lost to a crash, bounded by the
  epoch window.  :meth:`drain` closes every shard's open epoch before
  returning, so a drained scheduler is fully durable; callers needing
  a mid-stream barrier call :meth:`sync_epochs` explicitly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import instant, span, tracing_enabled
from repro_torch.pmwcas import Backend, MwCASOp, OpResult, Target

from .executor import execute_wave, schedule_wave, select_executor
from .journal import CrossShardJournal
from .router import RoutedOp, ShardRouter
from .stats import ServiceStats, collect_durability, fresh_stats


class ServiceError(RuntimeError):
    """The service observed a state its protocol rules out."""


class OpFuture:
    """Client handle for one submitted op (completed by ``step``)."""

    __slots__ = ("op", "client", "shard", "seq", "op_id", "submit_step",
                 "submit_ns", "done", "result", "latency_rounds")

    def __init__(self, op: MwCASOp, client, shard: int, seq: int,
                 submit_step: int):
        self.op = op
        self.client = client
        self.shard = shard
        self.seq = seq
        # stable causal identity for the op's trace events (DESIGN §13)
        self.op_id = f"op{seq}"
        self.submit_step = submit_step
        self.submit_ns = time.perf_counter_ns()
        self.done = False
        self.result: Optional[OpResult] = None
        self.latency_rounds = 0

    @property
    def success(self) -> bool:
        return bool(self.done and self.result and self.result.success)

    def __repr__(self) -> str:
        state = (f"done success={self.result.success}" if self.done
                 else "pending")
        return f"OpFuture(client={self.client}, shard={self.shard}, {state})"


@dataclasses.dataclass
class _Pending:
    """Internal queue entry: the routed op plus its future."""
    routed: RoutedOp
    future: OpFuture

    @property
    def local(self) -> MwCASOp:          # build_rounds reads .local
        return self.routed.local


class BatchScheduler:
    def __init__(self, backends: Sequence[Backend], router: ShardRouter, *,
                 round_cap: int = 16, executor=None,
                 journal: Optional[CrossShardJournal] = None,
                 journal_prune_every: int = 16,
                 wal_prune_every: int = 0):
        """``journal_prune_every``: GC the cross-shard decision journal
        every N serialized global rounds (0 disables).  Without the
        cadence a long-running service grows ``xwal/`` one record per
        cross-shard op, forever — the scheduler-level analogue of the
        committer's ``prune_completed`` WAL hygiene.

        ``wal_prune_every``: the same hygiene one layer down — every N
        round waves, durably drop spent PER-SHARD committer WAL records
        (``DurableBackend.prune_completed``) on shards that support it
        (0 disables)."""
        if router.n_shards != len(backends):
            raise ValueError(f"router has {router.n_shards} shards, got "
                             f"{len(backends)} backends")
        if round_cap < 1:
            raise ValueError("round_cap must be >= 1")
        if journal_prune_every < 0:
            raise ValueError("journal_prune_every must be >= 0")
        if wal_prune_every < 0:
            raise ValueError("wal_prune_every must be >= 0")
        self.backends = list(backends)
        self.router = router
        self.round_cap = round_cap
        self.executor = executor or select_executor(self.backends,
                                                    round_cap=round_cap)
        self.journal = journal
        self.journal_prune_every = journal_prune_every
        self.wal_prune_every = wal_prune_every
        self.stats: ServiceStats = fresh_stats(len(backends), round_cap)
        self._queues: Dict[int, List[_Pending]] = {
            s: [] for s in range(len(backends))}
        self._cross: List[_Pending] = []
        self._seq = 0

    # -- submission ------------------------------------------------------------
    def submit(self, op: MwCASOp, client=0) -> OpFuture:
        routed = self.router.classify(op)
        fut = OpFuture(op, client, routed.shard, self._seq, self.stats.steps)
        self._seq += 1
        self.stats.submitted += 1
        if tracing_enabled():
            instant("op.submit", op_id=fut.op_id, client=client,
                    shard=routed.shard, cross=routed.is_cross,
                    step=self.stats.steps)
        if routed.is_cross:
            self._cross.append(_Pending(routed, fut))
        else:
            self._queues[routed.shard].append(_Pending(routed, fut))
        return fut

    def submit_many(self, ops: Sequence[MwCASOp],
                    client=0) -> List[OpFuture]:
        return [self.submit(op, client) for op in ops]

    @property
    def pending_count(self) -> int:
        return len(self._cross) + sum(len(q) for q in self._queues.values())

    # -- execution -------------------------------------------------------------
    def step(self) -> int:
        """Drive one round wave; returns futures completed.

        If cross-shard ops are queued, this step is a serialized GLOBAL
        round (each queued cross op runs alone, in submission order) and
        no shard rounds execute; otherwise one conflict-free round per
        shard executes, all in the same wave.
        """
        if not self.pending_count:
            return 0
        self.stats.steps += 1
        with span("scheduler.wave", step=self.stats.steps) as sp:
            if self._cross:
                completed = self._global_round()
            else:
                completed = self._shard_rounds()
            if (self.wal_prune_every and
                    self.stats.steps % self.wal_prune_every == 0):
                # per-shard committer WAL hygiene, on a wave cadence
                for b in self.backends:
                    prune = getattr(b, "prune_completed", None)
                    if prune is not None:
                        self.stats.wal_pruned += prune()
            sp.set(completed=completed)
        return completed

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until every queue is empty; returns futures completed.
        Terminates: every step executes (or serially completes) at least
        one queued op."""
        limit = (self.pending_count + 4) if max_steps is None else max_steps
        done = 0
        for _ in range(limit):
            if not self.pending_count:
                break
            done += self.step()
        if self.pending_count:
            raise ServiceError(
                f"drain did not converge in {limit} steps "
                f"({self.pending_count} ops still queued)")
        # a drained scheduler promises durability: close open epochs so
        # every completed future's round is actually on the medium
        self.sync_epochs()
        return done

    def sync_epochs(self) -> int:
        """Durability barrier over the shards: close every open epoch
        (one fence each).  Returns rounds made durable; counted in
        ``stats.epoch_syncs`` when anything flushed."""
        synced = 0
        for b in self.backends:
            sync = getattr(b, "sync", None)
            if sync is not None:
                synced += sync()
        if synced:
            self.stats.epoch_syncs += 1
        return synced

    def read(self, addr: int) -> int:
        """Read one word through the shard that owns it."""
        shard = self.router.shard_of_addr(addr)
        return self.backends[shard].read(self.router.local(addr))

    # -- shard rounds ----------------------------------------------------------
    def _shard_rounds(self) -> int:
        with span("wave.schedule"):
            rounds, leftovers = schedule_wave(
                {s: q for s, q in self._queues.items() if q},
                self.round_cap, self.stats)
            for s in self._queues:
                self._queues[s] = leftovers.get(s, [])
        if not rounds:
            return 0
        completed = 0
        with span("wave.dispatch", shards=len(rounds)):
            dispatch_start_ns = time.perf_counter_ns()
            persist_ns0 = self._persist_ns_total()
            wave = execute_wave(self.executor, self.backends, rounds,
                                self.stats)
        with span("wave.complete"):
            # the wave's fence wall-clock splits evenly across its ops
            # (one group-commit record covers the whole round)
            persist_wave_ns = self._persist_ns_total() - persist_ns0
            n_done = sum(len(pairs) for pairs in wave.values())
            persist_share_us = (persist_wave_ns / 1e3 / n_done
                                if n_done else 0.0)
            for pairs in wave.values():
                for pending, ok in pairs:     # executed verdicts are final
                    self._complete(pending.future, ok,
                                   dispatch_start_ns=dispatch_start_ns,
                                   persist_share_us=persist_share_us)
                    completed += 1
        return completed

    def _persist_ns_total(self) -> int:
        """Wall-clock the durable shards have spent inside persist
        fences, summed (0 for kernel deployments)."""
        total = 0
        for b in self.backends:
            pool = getattr(b, "pool", None)
            if pool is not None:
                total += pool.persist_ns
        return total

    # -- the serialized global round -------------------------------------------
    def _global_round(self) -> int:
        self.stats.cross_rounds += 1
        batch, self._cross = self._cross, []
        completed = 0
        with span("wave.global_round", ops=len(batch)):
            for pending in batch:
                dispatch_start_ns = time.perf_counter_ns()
                persist_ns0 = self._persist_ns_total()
                ok = self._execute_cross(pending.routed)
                self.stats.cross_ops += 1
                self._complete(
                    pending.future, ok,
                    dispatch_start_ns=dispatch_start_ns,
                    persist_share_us=(self._persist_ns_total()
                                      - persist_ns0) / 1e3)
                completed += 1
            if (self.journal is not None and self.journal_prune_every and
                    self.stats.cross_rounds % self.journal_prune_every
                    == 0):
                # journal hygiene on a cadence: COMPLETED decision
                # records are spent (redo never consults them), drop them
                self.stats.journal_pruned += self.journal.prune()
        return completed

    def _execute_cross(self, routed: RoutedOp) -> bool:
        """One cross-shard op: validate, decide (journal), apply per
        shard, complete.  Runs with nothing else in flight (the global
        round is the only execution this step)."""
        parts = routed.parts
        for shard, targets in parts.items():
            for t in targets:
                if self.backends[shard].read(t.addr) != t.expected:
                    return False                       # failed condition (a)
        op_id = f"x{self._seq}-{routed.op.addrs[0]}"
        self._seq += 1
        if self.journal is not None:
            self.journal.decide(op_id, [
                (shard, t.addr, t.expected, t.desired)
                for shard, targets in sorted(parts.items())
                for t in targets])
        for shard in sorted(parts):
            (res,) = self.backends[shard].execute([MwCASOp(parts[shard])])
            if not res.success:
                # nothing else runs during a global round and validation
                # just passed, so a sub-op can never legitimately lose
                raise ServiceError(
                    f"cross-shard sub-op lost on shard {shard} during a "
                    "serialized global round")
        if self.journal is not None:
            self.journal.complete(op_id)
        return True

    # -- crash recovery --------------------------------------------------------
    def recover(self) -> int:
        """Redo incomplete cross-shard decisions from the journal.

        Call after re-attaching recovered shard backends (each durable
        shard's own WAL recovery runs in ``DurableBackend.crash()``).
        Returns the number of ops redone.  Idempotent.
        """
        if self.journal is None:
            return 0
        redone = 0
        with span("scheduler.recover") as sp:
            redone = self._recover_pending()
            sp.set(redone=redone)
        return redone

    def _recover_pending(self) -> int:
        redone = 0
        for rec in self.journal.pending():
            by_shard: Dict[int, List[Target]] = {}
            for shard, addr, exp, des in self.journal.targets_of(rec):
                by_shard.setdefault(shard, []).append(Target(addr, exp, des))
            for shard, targets in sorted(by_shard.items()):
                vals = [self.backends[shard].read(t.addr) for t in targets]
                if all(v == t.desired for v, t in zip(vals, targets)):
                    continue                   # this shard already applied
                if not all(v == t.expected for v, t in zip(vals, targets)):
                    raise ServiceError(
                        f"journal redo of {rec['id']}: shard {shard} words "
                        f"{[t.addr for t in targets]} hold {vals}, neither "
                        "expected nor desired — torn sub-op")
                (res,) = self.backends[shard].execute([MwCASOp(targets)])
                if not res.success:
                    raise ServiceError(
                        f"journal redo of {rec['id']} lost its CAS on "
                        f"shard {shard}")
            self.journal.complete(rec["id"])
            redone += 1
        return redone

    # -- instrumentation -------------------------------------------------------
    def durability_stats(self):
        """Merged committer flush accounting over the durable shards
        (None when no shard is durable)."""
        return collect_durability(self.backends)

    # -- completion ------------------------------------------------------------
    def _complete(self, fut: OpFuture, success: bool, *,
                  dispatch_start_ns: Optional[int] = None,
                  persist_share_us: float = 0.0) -> None:
        fut.done = True
        fut.latency_rounds = self.stats.steps - fut.submit_step
        fut.result = OpResult(index=fut.seq, success=success,
                              backend="service", op=fut.op)
        status = "ok" if success else "conflict"
        latency_us = (time.perf_counter_ns() - fut.submit_ns) / 1e3
        # queue + dispatch + persist partition latency_us exactly (the
        # same decomposition as KVService._complete; the scheduler
        # executes each submission once, so retry_waves is always 0)
        if dispatch_start_ns is None:
            queue_us, dispatch_us, persist_us = latency_us, 0.0, 0.0
        else:
            queue_us = min(max(
                (dispatch_start_ns - fut.submit_ns) / 1e3, 0.0), latency_us)
            persist_us = min(max(persist_share_us, 0.0),
                             latency_us - queue_us)
            dispatch_us = latency_us - queue_us - persist_us
        self.stats.record_completion(
            fut.latency_rounds, status, latency_us=latency_us,
            queue_us=queue_us, dispatch_us=dispatch_us,
            persist_us=persist_us, retry_waves=0)
        if tracing_enabled():
            instant("op.complete", op_id=fut.op_id, status=status,
                    queue_us=round(queue_us, 1),
                    dispatch_us=round(dispatch_us, 1),
                    persist_us=round(persist_us, 1), step=self.stats.steps)
