"""Concrete statechart machines: workload clients and fault injectors.

:class:`ClientMachine` is one logical client session: it thinks for a
few waves, issues one KV op, awaits the verdict, and repeats.  Its
key-distribution state is itself part of the statechart — a Zipf rank
permutation whose hot end *drifts* on a cadence, and an optional
shard-targeted storm mode where draws concentrate on keys routing to one
victim shard (the router's own hash decides which keys those are).

:class:`FaultMachine` produces adversarial *directives* the driver
applies to the service: arm a crash a few persists ahead on some shard
(the ``crash_after_persists`` trap the structure crash sweeps use),
crash specifically while a scan is in flight, stall a straggler client,
or start/stop a shard-targeted storm.  Directives accumulate in
``machine.directives`` and are drained by the driver each wave — the
machine never touches the service itself, which keeps fault scheduling
replayable from the trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.pmwcas import zipf_probs
from repro_torch.structures import KVOp, key_shard

from .statechart import Machine, Transition

DELETE, INSERT, READ, SCAN, UPDATE = ("delete", "insert", "read", "scan",
                                      "update")


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    """Mix + skew + pacing of one client session (fractions sum to 1)."""
    n_keys: int = 32
    read: float = 0.4
    update: float = 0.25
    insert: float = 0.2
    delete: float = 0.1
    scan: float = 0.05
    alpha: float = 0.9             # Zipf skew of key popularity
    think_lo: int = 0              # waves between verdict and next issue
    think_hi: int = 2
    drift_every: int = 0           # rotate the hot ranks every N waves
    drift_step: int = 0
    storm_bias: float = 0.85       # P(draw a victim-shard key) in a storm
    n_shards: int = 1              # router fan-out (for storm targeting)

    def __post_init__(self):
        total = self.read + self.update + self.insert + self.delete \
            + self.scan
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"mix fractions sum to {total}, need 1.0")


class ClientMachine(Machine):
    """think --issue--> await --done/crashed--> think, forever.

    The op the machine wants executed this wave sits in ``outbox`` after
    a ``tick`` fires the issue transition; the driver submits it and
    posts ``done`` (with the verdict) or ``crashed`` (verdict lost) when
    the service answers.  Key draws follow a seeded Zipf over a private
    rank permutation; ``drift_every``/``drift_step`` rotate which keys
    are hot, and a fault-machine storm re-biases draws onto one shard.
    """

    KINDS = (READ, UPDATE, INSERT, DELETE, SCAN)

    def __init__(self, name: str, spec: ClientSpec, seed: int):
        self.spec = spec
        transitions = [
            Transition("think", "tick", "await",
                       guard=lambda m, e: m.think_left <= 0,
                       action=ClientMachine._issue),
            Transition("think", "tick", "think",
                       action=ClientMachine._idle_tick),
            Transition("await", "tick", "await",
                       action=ClientMachine._idle_tick),
            Transition("await", "done", "think",
                       action=ClientMachine._done),
            Transition("await", "crashed", "think",
                       action=ClientMachine._crashed),
            Transition("think", "storm", "think",
                       action=ClientMachine._storm),
            Transition("await", "storm", "await",
                       action=ClientMachine._storm),
            Transition("think", "calm", "think",
                       action=ClientMachine._calm),
            Transition("await", "calm", "await",
                       action=ClientMachine._calm),
            Transition("think", "stall", "think",
                       action=ClientMachine._stall),
            Transition("await", "stall", "await",
                       action=ClientMachine._stall),
        ]
        super().__init__(name, "think", transitions, seed)
        self._probs = zipf_probs(spec.n_keys, spec.alpha)
        self._perm = self.rng.permutation(spec.n_keys)
        self._mix = [spec.read, spec.update, spec.insert, spec.delete,
                     spec.scan]
        # keys (1-based) owned by each shard, for storm targeting
        self._shard_keys: List[List[int]] = [[] for _ in range(spec.n_shards)]
        for key in range(1, spec.n_keys + 1):
            self._shard_keys[key_shard(key, spec.n_shards)].append(key)
        self.hot_offset = 0
        self.storm_shard: Optional[int] = None
        self.stall_bonus = 0
        self.think_left = int(self.rng.integers(spec.think_lo,
                                                spec.think_hi + 1))
        self.outbox: Optional[KVOp] = None
        self.issued = 0
        self.lost_to_crash = 0

    # -- draws -----------------------------------------------------------------
    def _draw_key(self) -> int:
        if self.storm_shard is not None and \
                self._shard_keys[self.storm_shard] and \
                self.rng.random() < self.spec.storm_bias:
            victims = self._shard_keys[self.storm_shard]
            return victims[int(self.rng.integers(len(victims)))]
        rank = int(self.rng.choice(self.spec.n_keys, p=self._probs))
        return int((self._perm[rank] + self.hot_offset)
                   % self.spec.n_keys) + 1

    def _draw_op(self) -> KVOp:
        kind = self.KINDS[int(self.rng.choice(5, p=self._mix))]
        key = self._draw_key()
        value = int(self.rng.integers(1, 1 << 20))
        return KVOp(kind, key, value if kind in (INSERT, UPDATE) else 0)

    def _drift(self, ev) -> None:
        sp = self.spec
        if sp.drift_every and ev["wave"] % sp.drift_every == 0:
            self.hot_offset = (self.hot_offset + sp.drift_step) % sp.n_keys

    # -- transition actions ----------------------------------------------------
    def _issue(self, ev) -> None:
        self._drift(ev)
        self.outbox = self._draw_op()
        self.issued += 1

    def _idle_tick(self, ev) -> None:
        self._drift(ev)
        if self.state == "think":
            self.think_left -= 1

    def _rethink(self) -> None:
        sp = self.spec
        self.think_left = int(self.rng.integers(
            sp.think_lo, sp.think_hi + 1)) + self.stall_bonus
        self.stall_bonus = 0

    def _done(self, ev) -> None:
        self._rethink()

    def _crashed(self, ev) -> None:
        self.lost_to_crash += 1
        self._rethink()

    def _storm(self, ev) -> None:
        self.storm_shard = int(ev["shard"])

    def _calm(self, ev) -> None:
        self.storm_shard = None

    def _stall(self, ev) -> None:
        self.stall_bonus += int(ev["waves"])


# ---------------------------------------------------------------------------
# Fault machines
# ---------------------------------------------------------------------------

# directive vocabulary the driver consumes (first tuple element)
ARM_CRASH = "arm_crash"        # (ARM_CRASH, shard, persists_ahead)
STALL = "stall"                # (STALL, client_index, waves)
STORM = "storm"                # (STORM, shard)
CALM = "calm"                  # (CALM,)
MIGRATE = "migrate"            # (MIGRATE, lo, hi, dst_shard)
ARM_MIG_CRASH = "arm_mig_crash"  # (ARM_MIG_CRASH, persists_ahead)

CRASH_AT_PERSIST = "crash_at_persist"
CRASH_MID_SCAN = "crash_mid_scan"
STRAGGLER = "straggler"
SHARD_STORM = "shard_storm"
CRASH_MID_MIGRATION = "crash_mid_migration"
# same trap mechanics as CRASH_AT_PERSIST, but meant for scenarios with
# epoch durability on: with rounds buffered under one coalesced fence,
# nearly every persist a shard issues IS an epoch-close or checkpoint
# fence, so a small persists_ahead budget lands the crash exactly on an
# epoch boundary — the bounded-loss window the protocol must contain
EPOCH_BOUNDARY = "epoch_boundary"
FAULT_KINDS = (CRASH_AT_PERSIST, CRASH_MID_SCAN, STRAGGLER, SHARD_STORM,
               CRASH_MID_MIGRATION, EPOCH_BOUNDARY)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Scheduling knobs shared by the fault kinds."""
    kind: str = CRASH_AT_PERSIST
    n_shards: int = 1
    n_clients: int = 1
    first_wave: int = 6            # earliest wave the fault may trigger
    gap_lo: int = 8                # waves between triggers
    gap_hi: int = 16
    persists_lo: int = 1           # crash trap: persists ahead of now
    persists_hi: int = 12
    stall_waves: int = 6           # straggler: added think time
    storm_len: int = 8             # storm duration in waves
    n_keys: int = 32               # keyspace (migration range drawing)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultMachine(Machine):
    """Statechart fault injector; emits driver directives (see module
    docstring).  One machine = one fault process; a scenario may run
    several concurrently (e.g. a shard storm plus a crash schedule)."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        self.directives: List[Tuple] = []
        self.fired = 0
        if spec.kind in (CRASH_AT_PERSIST, CRASH_MID_SCAN, EPOCH_BOUNDARY):
            guard = (self._may_crash_scan if spec.kind == CRASH_MID_SCAN
                     else self._may_crash)
            transitions = [
                Transition("idle", "tick", "armed", guard=guard,
                           action=FaultMachine._arm),
                Transition("idle", "tick", "idle"),
                Transition("armed", "tick", "armed"),
                Transition("armed", "crash", "idle",
                           action=FaultMachine._sprung),
            ]
        elif spec.kind == CRASH_MID_MIGRATION:
            transitions = [
                Transition("idle", "tick", "armed", guard=self._due,
                           action=FaultMachine._arm_migration),
                Transition("idle", "tick", "idle"),
                Transition("armed", "tick", "idle",
                           guard=lambda m, e: e["wave"] >= m.until,
                           action=FaultMachine._reschedule),
                Transition("armed", "tick", "armed"),
                Transition("armed", "crash", "idle",
                           action=FaultMachine._sprung),
            ]
        elif spec.kind == STRAGGLER:
            transitions = [
                Transition("idle", "tick", "stalling", guard=self._due,
                           action=FaultMachine._pick_victim),
                Transition("idle", "tick", "idle"),
                Transition("stalling", "tick", "idle",
                           action=FaultMachine._reschedule),
            ]
        else:                                           # SHARD_STORM
            transitions = [
                Transition("calm", "tick", "storming", guard=self._due,
                           action=FaultMachine._start_storm),
                Transition("calm", "tick", "calm"),
                Transition("storming", "tick", "calm",
                           guard=lambda m, e: e["wave"] >= m.until,
                           action=FaultMachine._end_storm),
                Transition("storming", "tick", "storming"),
            ]
        initial = "calm" if spec.kind == SHARD_STORM else "idle"
        super().__init__(f"fault:{spec.kind}", initial, transitions, seed)
        self.next_wave = spec.first_wave
        self.until = 0

    # -- guards ----------------------------------------------------------------
    def _due(self, m, ev) -> bool:
        return ev["wave"] >= self.next_wave

    def _may_crash(self, m, ev) -> bool:
        return self._due(m, ev)

    def _may_crash_scan(self, m, ev) -> bool:
        # crash-mid-scan: only spring the trap on a wave with a scan in
        # flight, so the lost verdict is a range read
        return self._due(m, ev) and ev.get("scans_pending", 0) > 0

    # -- actions ---------------------------------------------------------------
    def _reschedule(self, ev) -> None:
        self.next_wave = ev["wave"] + int(
            self.rng.integers(self.spec.gap_lo, self.spec.gap_hi + 1))

    def _arm(self, ev) -> None:
        sp = self.spec
        shard = int(self.rng.integers(sp.n_shards))
        ahead = int(self.rng.integers(sp.persists_lo, sp.persists_hi + 1))
        if sp.kind == CRASH_MID_SCAN:
            ahead = int(self.rng.integers(0, 4))   # spring it this wave
        self.directives.append((ARM_CRASH, shard, ahead))

    def _sprung(self, ev) -> None:
        self.fired += 1
        self._reschedule(ev)

    def _arm_migration(self, ev) -> None:
        """Start a key-range migration and schedule a crash into it:
        half the draws trap the migration decision log (the swing's own
        persists), half trap a shard WAL pool (mid-copy)."""
        sp = self.spec
        lo = 1 + int(self.rng.integers(sp.n_keys))
        hi = lo + 1 + int(self.rng.integers(max(2, sp.n_keys // 3)))
        dst = int(self.rng.integers(sp.n_shards))
        self.directives.append((MIGRATE, lo, hi, dst))
        if self.rng.random() < 0.5:
            self.directives.append(
                (ARM_MIG_CRASH, 1 + int(self.rng.integers(3))))
        else:
            shard = int(self.rng.integers(sp.n_shards))
            ahead = int(self.rng.integers(sp.persists_lo,
                                          sp.persists_hi + 1))
            self.directives.append((ARM_CRASH, shard, ahead))
        self.until = ev["wave"] + sp.storm_len
        self.fired += 1

    def _pick_victim(self, ev) -> None:
        victim = int(self.rng.integers(self.spec.n_clients))
        self.directives.append((STALL, victim, self.spec.stall_waves))
        self.fired += 1

    def _start_storm(self, ev) -> None:
        shard = int(self.rng.integers(self.spec.n_shards))
        self.until = ev["wave"] + self.spec.storm_len
        self.directives.append((STORM, shard))
        self.fired += 1

    def _end_storm(self, ev) -> None:
        self.directives.append((CALM,))
        self._reschedule(ev)

    def drain_directives(self) -> List[Tuple]:
        out, self.directives = self.directives, []
        return out
