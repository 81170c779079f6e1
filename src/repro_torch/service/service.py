"""KVService: many logical clients on sharded persistent structures.

The service front for the structures layer: S shards, each owning its
own backend instance (built through the ``repro_torch.pmwcas`` factory
hooks) and its own structure partition
(:class:`repro_torch.structures.HashMap` or
:class:`repro_torch.structures.BzTreeIndex`).  Keys are routed by
multiplicative hash, so every logical op is shard-local by construction
— cross-shard atomicity only arises at the raw-op layer
(:class:`repro_torch.service.BatchScheduler`), never for single-key KV
ops.

Execution is the structures' snapshot-compile/round-execute loop lifted
across shards: each ``step`` compiles every shard's pending ops against
that shard's snapshot, forms ONE conflict-free round per shard (the
conflict-defer rule: duplicate-target ops wait a round instead of
executing to certain failure), and runs all shard rounds in a single
wave — kernel shards through the stacked dispatch, so S rounds cost
one kernel launch; durable shards one committer round each, on the
host.  CAS losers recompile against the next snapshot; tree shards run
the split protocol between waves, exactly like ``BzTreeIndex.apply``
does between rounds (a split's wide MwCAS is its own launch, on the
route the kernel's plan picks for its width).

Durable shards (``backend="durable"``) keep their state in a
:class:`repro_torch.checkpoint.PMemPool` each and put nothing on the
device: group commit, epochs with the ack gate (acks withheld until the
epoch that holds them closes), checkpoints, WAL pruning on a wave
cadence, and :meth:`KVService.crash`.  Online key-range migration is
ported, its decision log on a ``PMemPool``.
"""
from __future__ import annotations

import pathlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint import PMemPool
from repro_torch.obs import (flush_reason, instant, reset_metrics, span,
                             tracing_enabled)
from repro_torch.pmwcas import (Backend, KernelBackend, MwCASOp,
                                make_backend, resolve_device,
                                words_to_tensor)
from repro_torch.structures import (BzTreeIndex, DELETE, EXHAUSTED,
                                    FROZEN_BIT, FULL, HashMap, INSERT, KVOp,
                                    NeedsResize, NeedsSplit, OK,
                                    OutOfRegions, SCAN, StructResult)
from repro_torch.structures.bztree_index import count_ge

from .executor import DispatchStats, execute_wave, schedule_wave, \
    select_executor
from .journal import MIG_MIGRATING, MIG_ROUTED, MigrationLog
from .router import ShardRouter
from .stats import ServiceStats, collect_durability, fresh_stats


class KVFuture:
    """Client handle for one submitted logical op."""

    __slots__ = ("op", "client", "shard", "seq", "op_id", "submit_step",
                 "submit_ns", "done", "done_step", "result")

    def __init__(self, op: KVOp, client, shard: int, seq: int,
                 submit_step: int):
        self.op = op
        self.client = client
        self.shard = shard
        self.seq = seq
        # the stable causal identity: every trace event of this op's
        # lifecycle (submit -> defer/requeue -> dispatch -> complete)
        # carries it, so the timeline reassembles from the trace alone
        self.op_id = f"kv{seq}"
        self.submit_step = submit_step
        self.submit_ns = time.perf_counter_ns()
        self.done = False
        # the wave that DECIDED the op (epoch mode can ack later than it
        # decides; history checkers need the decision wave)
        self.done_step: Optional[int] = None
        self.result: Optional[StructResult] = None

    @property
    def status(self) -> Optional[str]:
        return self.result.status if self.done else None

    def __repr__(self) -> str:
        state = f"done {self.result.status}" if self.done else "pending"
        return f"KVFuture(client={self.client}, shard={self.shard}, {state})"


class _PendingKV:
    """Queue entry: future + the op compiled for the CURRENT wave.

    ``attempts`` counts EXECUTED-and-lost CAS rounds plus split retries —
    not waves spent queued behind the round cap.  Queue delay is latency,
    not failure; only genuine retry churn can exhaust an op.
    """

    __slots__ = ("future", "local", "attempts")

    def __init__(self, future: KVFuture):
        self.future = future
        self.local: Optional[MwCASOp] = None      # set per wave
        self.attempts = 0


class _Migration:
    """One in-flight key-range migration (service-side state; the
    durable truth is the :class:`MigrationLog` record)."""

    __slots__ = ("mig_id", "lo", "hi", "dst", "held", "start_step",
                 "start_ns")

    def __init__(self, mig_id: str, lo: int, hi: int, dst: int,
                 start_step: int):
        self.mig_id = mig_id
        self.lo = lo
        self.hi = hi
        self.dst = dst
        self.held: List[_PendingKV] = []     # ops parked until the swing
        self.start_step = start_step
        self.start_ns = time.perf_counter_ns()

    def covers(self, key: int) -> bool:
        return self.lo <= key < self.hi


class KVService:
    """Sharded, batched KV execution service (see module docstring).

    ``backend`` is a registered backend kind (``"kernel"``/``"durable"``/
    ``"sim"``/custom), a factory callable, or a list of pre-built
    per-shard backends.  ``structure`` selects the per-shard partition
    type: ``"hashmap"`` (sized by ``n_buckets`` per shard) or
    ``"bztree"`` (sized by ``leaf_cap``/``root_cap``/``n_regions`` per
    shard).  ``device`` places the kernel shards' word tables and the sim
    shards' simulations (default ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels) and every tree shard's region allocator;
    it is checked for every
    backend kind.  Durable shards put no word table on it; they live
    under ``durable_root/shard{s}`` (a temporary directory each without
    a root) and take ``group_commit``, ``epoch_rounds`` and
    ``checkpoint_every``; ``wal_prune_every`` prunes their WALs on a wave
    cadence.
    """

    def __init__(self, n_shards: int, *,
                 structure: str = "hashmap",
                 backend: Union[str, Callable[..., Backend],
                                Sequence[Backend]] = "kernel",
                 n_buckets: int = 64, max_doublings: int = 0,
                 leaf_cap: int = 4, root_cap: int = 8, n_regions: int = 8,
                 round_cap: int = 16, max_op_rounds: Optional[int] = None,
                 durable_root: Union[str, pathlib.Path, None] = None,
                 group_commit: bool = True,
                 epoch_rounds: int = 1, checkpoint_every: int = 0,
                 wal_prune_every: int = 0,
                 migration_pool=None, migration_chunk: int = 8,
                 device: Union[str, torch.device] = "cuda",
                 executor=None):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        if structure not in ("hashmap", "bztree"):
            raise ValueError(f"unknown structure {structure!r}")
        self.structure = structure
        self.n_buckets = n_buckets
        self.max_doublings = max_doublings
        self.tree_shape = dict(leaf_cap=leaf_cap, root_cap=root_cap,
                               n_regions=n_regions)
        if structure == "hashmap":
            words = HashMap.words_needed(n_buckets, max_doublings)
        else:
            words = BzTreeIndex.words_needed(leaf_cap, root_cap, n_regions)
        self.words_per_shard = words
        self.router = ShardRouter(n_shards, words_per_shard=words,
                                  policy="range")
        # checked whatever the backend kind: an entry point asked for
        # the card raises without one, and never falls back
        self.device = resolve_device(device)
        self.epoch_rounds = max(1, int(epoch_rounds))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.backends = self._build_backends(
            backend, n_shards, words, durable_root, group_commit,
            self.epoch_rounds, self.checkpoint_every, self.device)
        self.structs = [self._attach(b) for b in self.backends]
        # epoch ack gate (DESIGN.md Sec. 14): decisions made while ANY
        # durable shard has an open epoch are withheld here, in decide
        # order, until the global durability frontier passes them
        self._held: List[tuple] = []
        self._epoch_open_since: Dict[int, int] = {}
        self._epochs_closed_seen: Dict[int, int] = {}
        # the shards that can hold an epoch open; the gate checks only
        # these on every completion (none on a kernel deployment)
        self._epoch_backends = [b for b in self.backends
                                if hasattr(b, "epoch_pending")]
        self.round_cap = round_cap
        self.max_op_rounds = (2 * round_cap + 8 if max_op_rounds is None
                              else max_op_rounds)
        self.executor = executor or select_executor(self.backends,
                                                    round_cap=round_cap)
        self.stats: ServiceStats = fresh_stats(n_shards, round_cap)
        self._queues: List[List[_PendingKV]] = [[] for _ in range(n_shards)]
        self._seq = 0
        # per-wave compile-phase state: each shard's sorted live keys,
        # which the wave's scans count (see _scan_counts)
        self._scan_keys: Dict[int, np.ndarray] = {}
        if wal_prune_every < 0:
            raise ValueError("wal_prune_every must be >= 0")
        self.wal_prune_every = wal_prune_every
        # online key-range migration (decide -> copy -> swing; DESIGN.md
        # Sec. 12): the durable decision log lives in its own pool so
        # its persists are crash-sweepable like any shard's
        if migration_chunk < 1:
            raise ValueError("migration_chunk must be >= 1")
        self.migration_chunk = migration_chunk
        if migration_pool is None and durable_root is not None:
            migration_pool = PMemPool(pathlib.Path(durable_root) / "miglog")
        elif isinstance(migration_pool, (str, pathlib.Path)):
            migration_pool = PMemPool(migration_pool)
        self.mig_pool = migration_pool
        self.mig_log = (MigrationLog(migration_pool)
                        if migration_pool is not None else None)
        self._migrations: List[_Migration] = []
        self._mig_seq = 0
        self._recover_migrations()

    # -- construction ----------------------------------------------------------
    @staticmethod
    def _build_backends(spec, n_shards, words, durable_root, group_commit,
                        epoch_rounds, checkpoint_every,
                        device) -> List[Backend]:
        if isinstance(spec, (list, tuple)):
            if len(spec) != n_shards:
                raise ValueError(f"{len(spec)} backends for {n_shards} "
                                 "shards")
            return list(spec)
        out = []
        for s in range(n_shards):
            if spec in ("kernel", "sim"):
                kw = dict(n_words=words, device=device)
            elif spec == "durable":
                root = (None if durable_root is None
                        else pathlib.Path(durable_root) / f"shard{s}")
                kw = dict(root=root, group_commit=group_commit,
                          epoch_rounds=epoch_rounds,
                          checkpoint_every=checkpoint_every)
            else:                       # custom kind / factory
                kw = dict(n_words=words)
            out.append(make_backend(spec, **kw))
        return out

    def _attach(self, backend: Backend):
        if self.structure == "hashmap":
            return HashMap(backend, self.n_buckets,
                           max_doublings=self.max_doublings)
        return BzTreeIndex(backend, device=self.device, **self.tree_shape)

    # -- submission ------------------------------------------------------------
    def submit(self, op: KVOp, client=0) -> KVFuture:
        shard = self.router.shard_of_key(op.key)
        fut = KVFuture(op, client, shard, self._seq, self.stats.steps)
        self._seq += 1
        self.stats.submitted += 1
        if tracing_enabled():
            instant("op.submit", op_id=fut.op_id, client=client,
                    shard=shard, kind=op.kind, step=self.stats.steps)
        mig = self._covering_migration(op)
        if mig is not None:
            # park until the routing swings; released ops re-route
            mig.held.append(_PendingKV(fut))
        else:
            self._queues[shard].append(_PendingKV(fut))
        return fut

    def submit_many(self, ops: Sequence[KVOp], client=0) -> List[KVFuture]:
        return [self.submit(op, client) for op in ops]

    @property
    def pending_count(self) -> int:
        # held acks count as pending: the client has no verdict yet, and
        # drain() must not return while an epoch still owes them a fence
        return sum(len(q) for q in self._queues) \
            + sum(len(m.held) for m in self._migrations) \
            + len(self._held)

    # -- execution -------------------------------------------------------------
    def step(self) -> int:
        """One service wave: compile, form rounds, execute, complete —
        plus one copy chunk of every in-flight migration (the
        incremental materialize; the swing runs the wave the copy
        drains).  Returns the number of futures completed this wave."""
        if not self.pending_count and not self._migrations:
            return 0
        self.stats.steps += 1
        with span("service.wave", step=self.stats.steps) as sp:
            completed = self._execute_step()
            if self._migrations:
                self._advance_migrations()
            if (self.wal_prune_every and
                    self.stats.steps % self.wal_prune_every == 0):
                # per-shard WAL hygiene on a wave cadence: without it a
                # long-running durable service grows wal/ one record per
                # committed round, forever
                self.prune_wal()
            if self._held and not any(self._queues) \
                    and not self._migrations:
                # only withheld acks remain: no further round will close
                # the epochs naturally, so pay the barrier now (this is
                # what makes drain() a durability barrier)
                self.sync_epochs()
            self._settle_epochs()
            sp.set(completed=completed)
        return completed

    def _execute_step(self) -> int:
        completed = 0
        compiled_queues: Dict[int, List[_PendingKV]] = {}
        with span("wave.compile"):
            for s in range(len(self.structs)):
                if not self._queues[s]:
                    continue
                ready, done = self._compile_shard(s)
                completed += done
                if ready:
                    compiled_queues[s] = ready
            # the compile phase's scan keys die with it
            self._scan_keys.clear()
        if not compiled_queues:
            return completed
        with span("wave.schedule"):
            rounds, leftovers = schedule_wave(compiled_queues,
                                              self.round_cap, self.stats)
            # deferred ops recompile next wave (their snapshot is stale
            # by construction once this wave's round commits)
            for s, later in leftovers.items():
                self._requeue(s, later)
        with span("wave.dispatch", shards=len(rounds)):
            dispatch_start_ns = time.perf_counter_ns()
            persist_ns0 = self._persist_ns_total()
            wave = execute_wave(self.executor, self.backends, rounds,
                                self.stats)
        with span("wave.complete"):
            # this op's persist share: the wave's fence wall-clock is a
            # group property (one round record covers every winner), so
            # it splits evenly across the winners it made durable
            persist_wave_ns = self._persist_ns_total() - persist_ns0
            winners = sum(1 for pairs in wave.values()
                          for _p, ok in pairs if ok)
            persist_share_us = (persist_wave_ns / 1e3 / winners
                                if winners else 0.0)
            for s, pairs in wave.items():
                losers = []
                for pending, ok in pairs:
                    if ok:
                        self._finish(pending.future, OK,
                                     dispatch_start_ns=dispatch_start_ns,
                                     persist_share_us=persist_share_us,
                                     retry_waves=pending.attempts)
                        completed += 1
                    else:
                        pending.attempts += 1
                        losers.append(pending)   # recompile next wave
                self._requeue(s, losers)
        return completed

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until no op is pending.  Per-op round budgets
        (``max_op_rounds`` -> EXHAUSTED) bound the loop."""
        limit = ((self.pending_count + 4) * (self.max_op_rounds + 2)
                 if max_steps is None else max_steps)
        done = 0
        for _ in range(limit):
            if not self.pending_count:
                break
            done += self.step()
        if self.pending_count:
            raise RuntimeError(
                f"service drain did not converge in {limit} steps")
        return done

    def apply(self, ops: Sequence[KVOp], client=0) -> List[StructResult]:
        """Synchronous convenience: submit a batch, drain, return results
        in submission order (the ``HashMap.apply`` signature, served)."""
        futs = self.submit_many(ops, client)
        self.drain()
        return [f.result for f in futs]

    def _persist_ns_total(self) -> int:
        """Wall-clock the durable shards have spent inside persist
        fences, summed (0 for kernel deployments)."""
        total = 0
        for b in self.backends:
            pool = getattr(b, "pool", None)
            if pool is not None:
                total += pool.persist_ns
        return total

    def prune_wal(self) -> int:
        """Durably drop spent descriptor records on every shard whose
        backend supports it; returns records pruned (also accumulated in
        ``stats.wal_pruned``)."""
        pruned = 0
        for b in self.backends:
            prune = getattr(b, "prune_completed", None)
            if prune is not None:
                pruned += prune()
        self.stats.wal_pruned += pruned
        return pruned

    # -- wave internals --------------------------------------------------------
    def _compile_shard(self, s: int):
        """Compile shard ``s``'s queue against one snapshot.  Immediate
        results complete; split/resize requests run the structure's grow
        protocol (ops recompile next wave); CAS-compiled ops return for
        round formation."""
        struct = self.structs[s]
        if getattr(struct, "hdr", 0) and struct.migrating:
            # an in-flight directory doubling pumps a chunk per wave
            with flush_reason("structures", "doubling_pump"):
                struct.resize_step(max_moves=max(len(self._queues[s]), 2))
        with span("wave.snapshot", shard=s):
            snap = struct.snapshot()
        ready: List[_PendingKV] = []
        later: List[_PendingKV] = []
        done = 0
        resizes: List[_PendingKV] = []
        splits: Dict[int, List[_PendingKV]] = {}
        queue = self._queues[s]
        max_rounds = self.max_op_rounds
        # a tree compiles its whole queue in one batch (numpy gathers),
        # read in queue order; a hash map compiles op by op
        compile_ops = getattr(struct, "compile_ops", None)
        compiled_ops = None if compile_ops is None else compile_ops(
            [p.future.op for p in queue if p.attempts <= max_rounds
             and p.future.op.kind != SCAN], snap, defer_same_leaf=True)
        scan_counts = None
        for i, pending in enumerate(queue):
            fut = pending.future
            if pending.attempts > max_rounds:
                self._finish(fut, EXHAUSTED,
                             retry_waves=pending.attempts)
                done += 1
                continue
            if fut.op.kind == SCAN:
                # scans cover the whole keyspace: sum the count over
                # every shard partition (disjoint key sets, so a plain
                # sum); a scan always answers OK.  The queue's scans
                # are counted together at the first of them.
                if scan_counts is None:
                    self._scan_keys_of(s, snap)
                    scan_counts = self._scan_counts([
                        p.future.op for p in queue[i:]
                        if p.attempts <= max_rounds
                        and p.future.op.kind == SCAN])
                self._finish(fut, OK, next(scan_counts),
                             retry_waves=pending.attempts)
                done += 1
                continue
            compiled = (struct.compile_op(fut.op, snap) if compiled_ops is None
                        else next(compiled_ops))
            if isinstance(compiled, NeedsResize):
                resizes.append(pending)
            elif isinstance(compiled, NeedsSplit):
                splits.setdefault(compiled.leaf_base, []).append(pending)
            elif isinstance(compiled, StructResult):
                self._finish(fut, compiled.status, compiled.value,
                             retry_waves=pending.attempts)
                done += 1
            else:
                pending.local = compiled
                ready.append(pending)
        self._queues[s] = []
        if resizes:
            # publish the doubling decision; the waiters recompile next
            # wave against the split-brain table (room is immediate: a
            # fresh generation has twice the buckets)
            with flush_reason("structures", "doubling_swing"):
                began = struct.begin_resize()
            if began:
                for pending in resizes:
                    pending.attempts += 1
                later.extend(resizes)
            else:
                for pending in resizes:
                    self._finish(pending.future, FULL,
                                 retry_waves=pending.attempts)
                    done += 1
        if splits:
            # grow first; this wave's compiled ops would mostly lose
            # (the split freezes their leaf's meta), so everything on
            # this shard recompiles next wave — BzTreeIndex.apply's rule
            for leaf_base, waiters in sorted(splits.items()):
                try:
                    with span("wave.grow", shard=s):
                        grew = struct.ensure_room(leaf_base)
                except OutOfRegions:
                    grew = False
                    self.stats.shards[s].out_of_regions += 1
                if grew:
                    for pending in waiters:
                        pending.attempts += 1
                    later.extend(waiters)
                else:
                    for pending in waiters:
                        self._finish(pending.future, FULL,
                                     retry_waves=pending.attempts)
                        done += 1
            self._requeue(s, ready + later)
            return [], done
        self._requeue(s, later)
        return ready, done

    def _scan_counts(self, ops: Sequence[KVOp]):
        """Each scan's value in order: the live keys ``>= op.key`` over
        every shard (what each structure's SCAN compiles to; disjoint key
        sets, so a plain sum), counted by :func:`count_ge` over one
        sorted key array per shard and wave (:meth:`_scan_keys_of`).  A
        tree shard refuses a key outside (0, 2^31) at that scan, as its
        ``compile_op`` does."""
        bad = len(ops)
        if self.structure == "bztree":
            bad = next((i for i, op in enumerate(ops)
                        if not 0 < op.key < FROZEN_BIT), bad)
        keys = np.fromiter((op.key for op in ops[:bad]), np.int64, bad)
        counts = np.zeros(bad, np.int64)
        if bad:
            for s in range(len(self.structs)):
                counts += count_ge(self._scan_keys_of(s), keys)
        yield from counts.tolist()
        if bad < len(ops):
            raise ValueError(f"key {ops[bad].key} outside (0, 2^31)")

    def _scan_keys_of(self, s: int,
                      snap: Optional[np.ndarray] = None) -> np.ndarray:
        """Shard ``s``'s live keys, sorted, once per wave: from ``snap``
        (the shard's compile snapshot) if given, else from a snapshot
        taken now.

        Exact: nothing a wave's compile phase writes (tree splits and
        GC, hash-map doubling pumps) adds, removes or changes a live key,
        so every snapshot taken during the phase holds the same keys."""
        keys = self._scan_keys.get(s)
        if keys is None:
            struct = self.structs[s]
            snap = struct.snapshot() if snap is None else snap
            keys = self._scan_keys[s] = (
                struct.scan_keys(snap) if isinstance(struct, BzTreeIndex)
                else np.sort(np.fromiter(struct.items(snap), np.int64)))
        return keys

    def _requeue(self, s: int, entries: List[_PendingKV]) -> None:
        """Merge entries back into the shard queue in submission order
        (FIFO fairness across defers, losses and recompiles)."""
        if entries:
            if tracing_enabled():
                for pending in entries:
                    instant("op.requeue", op_id=pending.future.op_id,
                            shard=s, attempts=pending.attempts,
                            step=self.stats.steps)
            self._queues[s].extend(entries)
            self._queues[s].sort(key=lambda p: p.future.seq)

    # -- epoch ack gate (DESIGN.md Sec. 14) ------------------------------------
    def _finish(self, fut: KVFuture, status: str, value=None, *,
                dispatch_start_ns: Optional[int] = None,
                persist_share_us: float = 0.0,
                retry_waves: int = 0) -> None:
        """Completion gate for the epoch window.  The decision (status/
        value) is final here, but while ANY durable shard has an open
        epoch the ack is withheld GLOBALLY — released in decide order
        once every shard has durably passed the deciding step.  A
        global gate (not per-shard) because cross-shard reads (scans)
        observe every shard's visible state: acking a scan before a
        slower shard's epoch closes could expose a round a crash then
        revokes.  Outside epoch mode the gate is always open and this
        is exactly :meth:`_complete`."""
        if any(b.epoch_pending for b in self._epoch_backends):
            self._held.append((self.stats.steps, fut, status, value, dict(
                dispatch_start_ns=dispatch_start_ns,
                persist_share_us=persist_share_us,
                retry_waves=retry_waves)))
            self.stats.acks_held += 1
            if tracing_enabled():
                instant("op.ack_held", op_id=fut.op_id, status=status,
                        step=self.stats.steps)
        else:
            self._complete(fut, status, value,
                           dispatch_start_ns=dispatch_start_ns,
                           persist_share_us=persist_share_us,
                           retry_waves=retry_waves)

    def _settle_epochs(self) -> None:
        """End-of-wave epoch bookkeeping: note which shards hold an open
        epoch (and since when), then release held acks up to the global
        durability frontier — the last step EVERY durable shard has
        durably passed.  A shard that paid a fence this wave restarts
        its open-since mark: whatever epoch is open now only holds
        rounds from this wave."""
        open_since = self._epoch_open_since
        for s, b in enumerate(self.backends):
            pending = getattr(b, "epoch_pending", 0)
            stats = getattr(getattr(b, "committer", None), "stats", None)
            closed = getattr(stats, "epochs_closed", 0)
            fenced = closed > self._epochs_closed_seen.get(s, closed)
            self._epochs_closed_seen[s] = closed
            if not pending:
                open_since.pop(s, None)
            elif fenced:
                open_since[s] = self.stats.steps
            else:
                open_since.setdefault(s, self.stats.steps)
        if self._held:
            frontier = (min(open_since.values()) - 1 if open_since
                        else None)
            self._release_held(frontier)

    def _release_held(self, frontier: Optional[int]) -> None:
        """Ack held completions whose deciding step the frontier has
        passed (``None`` = everything), in decide order."""
        if not self._held:
            return
        keep: List[tuple] = []
        for item in self._held:
            step, fut, status, value, kw = item
            if frontier is None or step <= frontier:
                self._complete(fut, status, value, decided_step=step, **kw)
            else:
                keep.append(item)
        self._held = keep

    def sync_epochs(self) -> int:
        """Explicit durability barrier: close every shard's open epoch
        (one fence each) and release every withheld ack.  Returns rounds
        made durable across shards."""
        synced = 0
        for b in self.backends:
            sync = getattr(b, "sync", None)
            if sync is not None:
                synced += sync()
        if synced:
            self.stats.epoch_syncs += 1
        self._epoch_open_since.clear()
        self._release_held(None)
        return synced

    # -- completion ------------------------------------------------------------
    def _complete(self, fut: KVFuture, status: str, value=None, *,
                  dispatch_start_ns: Optional[int] = None,
                  persist_share_us: float = 0.0,
                  retry_waves: int = 0,
                  decided_step: Optional[int] = None) -> None:
        fut.done = True
        fut.done_step = (self.stats.steps if decided_step is None
                         else decided_step)
        latency = max(1, self.stats.steps - fut.submit_step)
        fut.result = StructResult(fut.op, status, value=value,
                                  rounds=latency)
        now_ns = time.perf_counter_ns()
        latency_us = (now_ns - fut.submit_ns) / 1e3
        # decompose: queue (submit -> this wave's dispatch start),
        # persist (the op's share of the wave's fence wall-clock),
        # dispatch (the rest).  The three sum to latency_us exactly —
        # compile-time completions (reads, EXHAUSTED, FULL) never reach
        # a dispatch, so their whole latency is queueing.
        if dispatch_start_ns is None:
            queue_us, dispatch_us, persist_us = latency_us, 0.0, 0.0
        else:
            queue_us = min(max(
                (dispatch_start_ns - fut.submit_ns) / 1e3, 0.0), latency_us)
            persist_us = min(max(persist_share_us, 0.0),
                             latency_us - queue_us)
            dispatch_us = latency_us - queue_us - persist_us
        self.stats.record_completion(
            latency, status, latency_us=latency_us, queue_us=queue_us,
            dispatch_us=dispatch_us, persist_us=persist_us,
            retry_waves=retry_waves)
        if tracing_enabled():
            instant("op.complete", op_id=fut.op_id, status=status,
                    latency_us=round(latency_us, 1),
                    queue_us=round(queue_us, 1),
                    dispatch_us=round(dispatch_us, 1),
                    persist_us=round(persist_us, 1),
                    retry_waves=retry_waves, step=self.stats.steps)

    # -- online key-range migration --------------------------------------------
    def _covering_migration(self, op: KVOp) -> Optional[_Migration]:
        """The in-flight migration that must hold this op, if any.
        Scans are held by ANY migration: their count sums every shard,
        and during a copy a key is (correctly) present on two shards."""
        for m in self._migrations:
            if m.covers(op.key) or op.kind == SCAN:
                return m
        return None

    def start_migration(self, lo: int, hi: int, dst: int) -> str:
        """Decide: persist the MIGRATING record and start holding the
        range.  The copy then proceeds one chunk per ``step`` wave; the
        swing (route flip + cleanup + held-op release) runs in the wave
        the copy drains.  Returns the migration id."""
        if not lo < hi:
            raise ValueError(f"empty key range [{lo}, {hi})")
        if not 0 <= dst < len(self.structs):
            raise ValueError(f"shard {dst} out of range")
        for m in self._migrations:
            if lo < m.hi and m.lo < hi:
                raise RuntimeError(
                    f"range [{lo}, {hi}) overlaps in-flight migration "
                    f"{m.mig_id}")
        if self.mig_log is None and any(
                getattr(b, "pool", None) is not None for b in self.backends):
            # crash-capable shards without a decision log would lose the
            # route table on crash while keeping the moved keys — silent
            # misrouting; make it a loud configuration error instead
            raise ValueError(
                "durable shards need a migration decision log: pass "
                "migration_pool= or durable_root= to KVService")
        mig_id = f"mig{self._mig_seq:04d}"
        self._mig_seq += 1
        if self.mig_log is not None:
            self.mig_log.decide(mig_id, lo, hi, dst)    # decide persist
        m = _Migration(mig_id, lo, hi, dst, self.stats.steps)
        self._migrations.append(m)
        self.stats.migrations += 1
        # ops already queued for the range (and all scans) park too
        for s in range(len(self._queues)):
            keep = []
            for pending in self._queues[s]:
                op = pending.future.op
                if m.covers(op.key) or op.kind == SCAN:
                    m.held.append(pending)
                else:
                    keep.append(pending)
            self._queues[s] = keep
        m.held.sort(key=lambda p: p.future.seq)
        return mig_id

    def migrate_range(self, lo: int, hi: int, dst: int,
                      max_steps: int = 10_000) -> str:
        """Synchronous convenience: start a migration and step the
        service until it (and everything it held) completes."""
        mig_id = self.start_migration(lo, hi, dst)
        for _ in range(max_steps):
            if not any(m.mig_id == mig_id for m in self._migrations):
                return mig_id
            self.step()
        raise RuntimeError(f"migration {mig_id} did not converge in "
                           f"{max_steps} steps")

    def _advance_migrations(self) -> None:
        for m in list(self._migrations):
            with span("service.migration_chunk", mig=m.mig_id):
                copied = self._copy_chunk(m)
            if copied == 0:
                self._swing_migration(m)
                self._migrations.remove(m)

    def _copy_chunk(self, m: _Migration) -> int:
        """Materialize: copy up to ``migration_chunk`` in-range keys to
        the destination in one batched-MwCAS ``apply``.  Returns keys
        copied; 0 means the copy has drained."""
        dst_struct = self.structs[m.dst]
        already = set(dst_struct.items())
        batch: List[KVOp] = []
        for s, struct in enumerate(self.structs):
            if s == m.dst:
                continue
            for k, v in sorted(struct.items().items()):
                if m.covers(k) and k not in already:
                    batch.append(KVOp(INSERT, k, v))
                    if len(batch) >= self.migration_chunk:
                        break
            if len(batch) >= self.migration_chunk:
                break
        if not batch:
            return 0
        moved = 0
        for r in dst_struct.apply(batch):
            if r.status == FULL:
                raise RuntimeError(
                    f"migration {m.mig_id}: destination shard {m.dst} is "
                    "full — size it for the range or make it elastic")
            if r.status == OK:
                moved += 1
        self.stats.keys_moved += moved
        return len(batch)

    def _swing_migration(self, m: _Migration) -> None:
        """Swing: ROUTED record persist (the linearization point), then
        the route table, then cleanup + release.  A crash after the
        first persist rolls forward; before it, back."""
        with span("service.migration_swing", mig=m.mig_id):
            # the ROUTED record redirects reads to the destination, so
            # every copied key must be durable there FIRST — close the
            # destination's open epoch before the linearization point
            sync = getattr(self.backends[m.dst], "sync", None)
            if sync is not None:
                sync()
            if self.mig_log is not None:
                self.mig_log.mark_routed(m.mig_id)
            self.router.set_range(m.lo, m.hi, m.dst)
            if self.mig_log is not None:
                self.mig_log.save_routes(self.router.ranges)
            self._cleanup_range(m.lo, m.hi, m.dst)
            if self.mig_log is not None:
                self.mig_log.complete(m.mig_id)
        self.stats.mig_pause_waves.append(
            max(1, self.stats.steps - m.start_step))
        self.stats.mig_pause_us.record(
            (time.perf_counter_ns() - m.start_ns) / 1e3)
        # release: held ops re-route (the override now wins) and rejoin
        # the wave loop in submission order
        for pending in sorted(m.held, key=lambda p: p.future.seq):
            shard = self.router.shard_of_key(pending.future.op.key)
            pending.future.shard = shard
            self._requeue(shard, [pending])

    def _cleanup_range(self, lo: int, hi: int, dst: int) -> None:
        """Delete now-unroutable source copies of [lo, hi): in-range
        keys living where the CURRENT route table does not send them.
        At swing time that is every source copy; at recovery-redo time
        the routing check also protects keys a LATER migration has
        since legitimately moved elsewhere."""
        for s, struct in enumerate(self.structs):
            if s == dst:
                continue
            dels = [KVOp(DELETE, k) for k in sorted(struct.items())
                    if lo <= k < hi and self.router.shard_of_key(k) != s]
            if dels:
                struct.apply(dels)

    def _recover_migrations(self) -> None:
        """Redo/rollback from the decision log (constructor + crash).

        MIGRATING records roll BACK: the migration never routed, so
        in-range keys on the destination that do not route there are
        half-copied residue — delete them, drop the record.  ROUTED
        records roll FORWARD: re-install the override, re-persist the
        route table, redo the cleanup, mark COMPLETED.  Every redo step
        is idempotent, so a crash during recovery just recovers again.
        """
        if self.mig_log is None:
            return
        self.router.ranges = self.mig_log.load_routes()
        seqs = [int(r["id"][3:]) for r in self.mig_log.records()
                if r["id"].startswith("mig") and r["id"][3:].isdigit()]
        self._mig_seq = 1 + max(seqs) if seqs else 0
        pend = self.mig_log.pending()
        # install every pending ROUTED override FIRST, in decision order
        # (ids are monotone, records() sorts by them): COMPLETED marks
        # are lazy, so several routed migrations may replay at once, and
        # each cleanup below must judge against the FINAL route table —
        # an earlier record's redo must not delete keys a later
        # migration has since moved onto their rightful shard
        routed = [r for r in pend if r["state"] == MIG_ROUTED]
        for rec in routed:
            self.router.set_range(rec["lo"], rec["hi"], rec["dst"])
        if routed:
            self.mig_log.save_routes(self.router.ranges)
        for rec in pend:
            lo, hi, dst = rec["lo"], rec["hi"], rec["dst"]
            if rec["state"] == MIG_MIGRATING:
                # rollback: half-copied residue is any in-range key on
                # the destination that does not route there
                struct = self.structs[dst]
                dels = [KVOp(DELETE, k) for k in sorted(struct.items())
                        if lo <= k < hi
                        and self.router.shard_of_key(k) != dst]
                if dels:
                    struct.apply(dels)
                self.mig_log.abort(rec["id"])
            else:                                   # ROUTED: roll forward
                self._cleanup_range(lo, hi, dst)
                self.mig_log.complete(rec["id"])

    # -- reads / integrity -----------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        key_shard = self.router.shard_of_key(key)
        return self.structs[key_shard].lookup(key)

    def items(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for struct in self.structs:
            out.update(struct.items())
        return out

    def check_integrity(self) -> Dict[int, int]:
        """Per-shard structure invariants + the routing invariant (no
        key lives on a shard it doesn't route to).  During an in-flight
        migration the destination legitimately holds not-yet-routed
        copies of in-range keys; those are exempt from the routing and
        duplicate checks but must MATCH the source value — held writes
        guarantee the copy can never diverge."""
        out: Dict[int, int] = {}
        copies: Dict[int, int] = {}
        for s, struct in enumerate(self.structs):
            items = struct.check_integrity()
            for k, v in items.items():
                route = self.router.shard_of_key(k)
                if route != s:
                    if any(m.dst == s and m.covers(k)
                           for m in self._migrations):
                        copies[k] = v
                        continue
                    raise RuntimeError(
                        f"key {k} lives on shard {s} but routes to "
                        f"{route}")
                if k in out:
                    raise RuntimeError(f"key {k} live on two shards")
                out[k] = v
        for k, v in copies.items():
            if k in out and out[k] != v:
                raise RuntimeError(
                    f"migration copy of key {k} diverged: source holds "
                    f"{out[k]}, destination copy holds {v}")
        return out

    def gc_regions(self) -> int:
        """Region GC across every tree shard (no-op for hash maps)."""
        return sum(getattr(s, "gc_regions", lambda: 0)()
                   for s in self.structs)

    def reset_stats(self) -> None:
        """Start a fresh measurement window (e.g. after a load phase).

        The global metrics registry resets with the window (it is the
        same measurement — benchmarks read both and compare them), and
        the executor's dispatch counters reset too, but the executor's
        TRACE CACHE survives — a warmed-up service must show zero
        retraces in the new window, and that is exactly what the
        benchmark asserts."""
        self.stats = fresh_stats(len(self.backends), self.round_cap)
        if hasattr(self.executor, "stats"):
            self.executor.stats = DispatchStats()
        reset_metrics()

    def durability_stats(self):
        """Merged committer flush accounting over the durable shards
        (None when no shard is durable)."""
        return collect_durability(self.backends)

    # -- durability ------------------------------------------------------------
    def crash(self) -> "KVService":
        """Durable services only: crash every shard (drop unpersisted
        writes), recover each from its own WAL, and re-attach the
        structure partitions.  Returns the recovered service.

        The measurement window SURVIVES the crash: the recovered service
        keeps this service's ``ServiceStats`` (steps, completions,
        latency windows — all monotone across the cycle; the backends
        likewise carry their ``DurabilityStats`` through
        ``DurableBackend.crash``) and its executor, whose trace cache a
        crash has no reason to invalidate."""
        with span("service.crash_recover", shards=len(self.backends)):
            recovered = []
            for b in self.backends:
                crash = getattr(b, "crash", None)
                if crash is None:
                    raise TypeError(
                        f"backend {b.name} cannot crash/recover")
                recovered.append(crash())
            new = KVService(len(recovered), structure=self.structure,
                            backend=recovered, n_buckets=self.n_buckets,
                            max_doublings=self.max_doublings,
                            **self.tree_shape,
                            round_cap=self.round_cap,
                            max_op_rounds=self.max_op_rounds,
                            wal_prune_every=self.wal_prune_every,
                            epoch_rounds=self.epoch_rounds,
                            checkpoint_every=self.checkpoint_every,
                            migration_pool=(self.mig_pool.crash()
                                            if self.mig_pool is not None
                                            else None),
                            migration_chunk=self.migration_chunk,
                            device=self.device)
            new.stats = self.stats
            new.executor = self.executor
        return new


def load_word_tables(svc: KVService, tables: Sequence) -> None:
    """Install per-shard word tables into ``svc``'s kernel shards.

    ``tables`` holds one uint32 numpy table per shard, in shard order —
    e.g. the reference service's ``[b.values() for b in svc.backends]`` —
    so both packages can continue from the same mid-run state.  The shard
    count and every table's width must match ``svc``."""
    if len(tables) != len(svc.backends):
        raise ValueError(f"{len(tables)} tables for {len(svc.backends)} "
                         "shards")
    for s, (backend, table) in enumerate(zip(svc.backends, tables)):
        if not isinstance(backend, KernelBackend):
            raise TypeError(f"shard {s} backend {backend.name!r} holds no "
                            "word table")
        table = np.asarray(table)
        if table.dtype != np.uint32:
            raise TypeError(f"shard {s}: need a uint32 table, got "
                            f"{table.dtype}")
        if table.shape != (backend.n_words,):
            raise ValueError(f"shard {s}: table shape {table.shape} != "
                             f"({backend.n_words},)")
        backend.set_word_table(words_to_tensor(table, backend.device))
