"""Service instrumentation: per-shard round accounting + op latency.

The vocabulary mirrors the paper's evaluation axes — how many CAS rounds
the substrate actually ran, how full each batch was, and how often ops
were deferred (the service's replacement for a lost CAS) or lost a real
conflict — plus client-visible latency measured in ROUNDS, the
substrate-independent unit (a round is one backend batch; wall time per
round is a property of the backend, not of the service).

Two hot-path waste counters ride along (DESIGN.md Sec. 9): the
executor's :class:`~repro_torch.service.DispatchStats` (shape buckets seen vs
cache hits of the stacked dispatch) attaches after every wave, and
:func:`collect_durability` merges the per-shard committer
:class:`repro_torch.pmwcas.DurabilityStats` (flushes issued vs saved,
commit fences) for durable deployments."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import Histogram, get_registry
from repro_torch.pmwcas import DurabilityStats


def collect_durability(backends: Sequence) -> Optional[DurabilityStats]:
    """Merged flush accounting over every shard whose backend exposes
    ``durability_stats`` (None when no shard is durable)."""
    merged = None
    for b in backends:
        stats = getattr(b, "durability_stats", None)
        if stats is not None:
            merged = DurabilityStats() if merged is None else merged
            merged.merge(stats)
    return merged


@dataclasses.dataclass
class ShardStats:
    """One shard's round accounting."""
    shard: int
    rounds: int = 0              # backend batches executed
    ops_executed: int = 0        # CAS ops submitted across those batches
    ops_won: int = 0             # CAS ops that committed
    defers: int = 0              # conflict-deferred (duplicate target in round)
    overflows: int = 0           # deferred because the round hit round_cap
    out_of_regions: int = 0      # allocator-exhausted FULL verdicts (trees)

    @property
    def conflict_losses(self) -> int:
        return self.ops_executed - self.ops_won


@dataclasses.dataclass
class ServiceStats:
    """Aggregate service instrumentation (scheduler and KV front)."""
    round_cap: int
    shards: List[ShardStats]
    steps: int = 0               # round waves driven (shards run in parallel)
    submitted: int = 0           # client submissions accepted
    completed: int = 0           # futures completed (any status)
    cross_rounds: int = 0        # serialized global rounds
    cross_ops: int = 0           # cross-shard ops executed in them
    journal_pruned: int = 0      # cross-shard records GC'd on cadence
    wal_pruned: int = 0          # spent per-shard WAL records GC'd on cadence
    migrations: int = 0          # key-range migrations decided
    keys_moved: int = 0          # keys copied to their new shard
    # epoch durability (DESIGN.md Sec. 14): acks withheld behind an open
    # epoch, and explicit sync_epochs() barriers that flushed something
    acks_held: int = 0
    epoch_syncs: int = 0
    # per-migration pause: how long the range was held, in service waves
    # (substrate-independent) and wall microseconds (this backend)
    mig_pause_waves: List[int] = dataclasses.field(default_factory=list)
    mig_pause_us: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.mig_pause_us"))
    # the executor's trace-cache accounting, attached after every wave
    # (None until a wave ran or the executor carries no stats)
    dispatch: Optional[object] = None
    latencies: List[int] = dataclasses.field(default_factory=list)
    # wall-clock completion latency alongside the round-based one: rounds
    # stay the substrate-independent unit, microseconds answer "what did a
    # client actually wait" on THIS backend
    latency_us: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.latency_us"))
    # the op-lifecycle breakdown (DESIGN §13): latency_us decomposes as
    # queue_us (submit -> wave dispatch start) + dispatch_us (device +
    # host scheduling) + persist_us (this op's share of the wave's fence
    # wall-clock) — the three sum to latency_us per op BY CONSTRUCTION,
    # so the histograms' means must reconcile (bench-asserted).
    queue_us: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.queue_us"))
    dispatch_us: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.dispatch_us"))
    persist_us: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.persist_us"))
    # waves an op was scheduled into before completing (0 = first try)
    retry_waves: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.retry_waves"))
    by_status: Dict[str, int] = dataclasses.field(default_factory=dict)

    # percentile window: a long-running service would otherwise grow the
    # sample list without bound; the percentiles describe recent traffic
    MAX_LATENCY_SAMPLES = 4096

    # -- recorders -------------------------------------------------------------
    def record_completion(self, latency_rounds: int, status: str,
                          latency_us: Optional[float] = None,
                          queue_us: Optional[float] = None,
                          dispatch_us: Optional[float] = None,
                          persist_us: Optional[float] = None,
                          retry_waves: Optional[int] = None) -> None:
        self.completed += 1
        self.latencies.append(int(latency_rounds))
        if len(self.latencies) > self.MAX_LATENCY_SAMPLES:
            del self.latencies[:len(self.latencies)
                               - self.MAX_LATENCY_SAMPLES]
        if latency_us is not None:
            self.latency_us.record(latency_us)
        # mirror the breakdown into the global registry (same series the
        # benchmark windows and obs_report read) alongside the dataclass
        reg = get_registry()
        if queue_us is not None:
            self.queue_us.record(queue_us)
            reg.histogram("queue_us", component="service").record(queue_us)
        if dispatch_us is not None:
            self.dispatch_us.record(dispatch_us)
            reg.histogram("dispatch_us",
                          component="service").record(dispatch_us)
        if persist_us is not None:
            self.persist_us.record(persist_us)
            reg.histogram("persist_us",
                          component="service").record(persist_us)
        if retry_waves is not None:
            self.retry_waves.record(retry_waves)
            reg.histogram("retry_waves",
                          component="service").record(retry_waves)
        self.by_status[status] = self.by_status.get(status, 0) + 1

    # -- aggregates ------------------------------------------------------------
    @property
    def rounds(self) -> int:
        return sum(s.rounds for s in self.shards) + self.cross_rounds

    @property
    def ops_executed(self) -> int:
        return sum(s.ops_executed for s in self.shards) + self.cross_ops

    @property
    def defers(self) -> int:
        return sum(s.defers for s in self.shards)

    @property
    def defer_rate(self) -> float:
        """Conflict-defers per scheduling decision (deferred ops come up
        for scheduling again, so the denominator counts attempts)."""
        attempts = self.ops_executed + self.defers \
            + sum(s.overflows for s in self.shards)
        return self.defers / attempts if attempts else 0.0

    @property
    def conflict_rate(self) -> float:
        """Executed CAS ops that lost their round."""
        if not self.ops_executed:
            return 0.0
        return sum(s.conflict_losses for s in self.shards) \
            / self.ops_executed

    @property
    def occupancy(self) -> float:
        """Mean batch fill across every executed shard round."""
        rounds = sum(s.rounds for s in self.shards)
        if not rounds or not self.round_cap:
            return 0.0
        return sum(s.ops_executed for s in self.shards) \
            / (rounds * self.round_cap)

    @property
    def ops_per_step(self) -> float:
        """Aggregate round throughput: completions per round wave —
        the quantity that must scale with shard count."""
        return self.completed / self.steps if self.steps else 0.0

    def latency_rounds(self, q: float) -> float:
        """Client-visible latency percentile, in rounds-to-completion,
        over the most recent ``MAX_LATENCY_SAMPLES`` completions."""
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies), q))

    @property
    def p50_latency_rounds(self) -> float:
        return self.latency_rounds(50.0)

    @property
    def p99_latency_rounds(self) -> float:
        return self.latency_rounds(99.0)

    @property
    def p50_latency_us(self) -> float:
        return self.latency_us.p50_us

    @property
    def p99_latency_us(self) -> float:
        return self.latency_us.p99_us

    # -- reporting -------------------------------------------------------------
    def as_row(self) -> Dict[str, float]:
        """Flat record for the benchmark JSON."""
        row = {
            "steps": self.steps, "rounds": self.rounds,
            "completed": self.completed,
            "ops_per_step": round(self.ops_per_step, 3),
            "occupancy": round(self.occupancy, 3),
            "defer_rate": round(self.defer_rate, 3),
            "conflict_rate": round(self.conflict_rate, 3),
            "cross_rounds": self.cross_rounds,
            "wal_pruned": self.wal_pruned,
            "p50_latency_rounds": self.p50_latency_rounds,
            "p99_latency_rounds": self.p99_latency_rounds,
            "p50_latency_us": round(self.p50_latency_us, 3),
            "p99_latency_us": round(self.p99_latency_us, 3),
        }
        if self.queue_us.count:
            row.update({
                "queue_us_p50": round(self.queue_us.p50_us, 3),
                "queue_us_p99": round(self.queue_us.p99_us, 3),
                "dispatch_us_p50": round(self.dispatch_us.p50_us, 3),
                "dispatch_us_p99": round(self.dispatch_us.p99_us, 3),
                "persist_us_p50": round(self.persist_us.p50_us, 3),
                "persist_us_p99": round(self.persist_us.p99_us, 3),
                # means reconcile with latency_us_mean exactly (the
                # three components partition each op's latency)
                "queue_us_mean": round(self.queue_us.mean_us, 3),
                "dispatch_us_mean": round(self.dispatch_us.mean_us, 3),
                "persist_us_mean": round(self.persist_us.mean_us, 3),
                "latency_us_mean": round(self.latency_us.mean_us, 3),
                "retry_waves_max": int(self.retry_waves.max_us),
            })
        if self.acks_held or self.epoch_syncs:
            row.update({
                "acks_held": self.acks_held,
                "epoch_syncs": self.epoch_syncs,
            })
        if self.migrations:
            row.update({
                "migrations": self.migrations,
                "keys_moved": self.keys_moved,
                "mig_pause_waves_max": max(self.mig_pause_waves, default=0),
                "mig_pause_us_p99": round(self.mig_pause_us.p99_us, 3),
            })
        if self.dispatch is not None:
            row.update({
                "traces": self.dispatch.traces,
                "dispatch_hits": self.dispatch.hits,
                "stacked_dispatches": self.dispatch.dispatches,
                "serial_rounds": self.dispatch.serial_rounds,
                "bytes_padded": self.dispatch.bytes_padded,
            })
        return row

    def summary(self) -> str:
        lines = [f"service: {self.completed}/{self.submitted} ops in "
                 f"{self.steps} steps ({self.ops_per_step:.1f} ops/step), "
                 f"{self.rounds} rounds "
                 f"(occupancy {self.occupancy:.2f}, defer rate "
                 f"{self.defer_rate:.3f}, conflict rate "
                 f"{self.conflict_rate:.3f})",
                 f"  latency p50={self.p50_latency_rounds:.0f} "
                 f"p99={self.p99_latency_rounds:.0f} rounds; "
                 f"cross-shard: {self.cross_ops} ops in "
                 f"{self.cross_rounds} serialized rounds"]
        for s in self.shards:
            lines.append(
                f"  shard {s.shard}: rounds={s.rounds} "
                f"cas={s.ops_executed} won={s.ops_won} "
                f"defers={s.defers} overflows={s.overflows}")
        return "\n".join(lines)


def fresh_stats(n_shards: int, round_cap: int) -> ServiceStats:
    return ServiceStats(round_cap=round_cap,
                        shards=[ShardStats(i) for i in range(n_shards)])
