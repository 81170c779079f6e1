"""ScenarioDriver: statechart machines x KVService x fault injection.

One scenario run is a synchronous wave loop.  Each wave the driver

1. ticks every client machine (ops land in their outboxes),
2. ticks the fault machines and applies their directives — crash traps
   arm a shard pool's ``crash_after_persists`` budget (the exact idiom
   the structure crash sweeps use), stalls and storms post events back
   to the client machines,
3. submits the outbox ops (recording invocations in the history),
4. runs ONE ``KVService.step()`` wave inside a ``SimulatedCrash``
   handler: on a normal wave newly-completed futures are recorded and
   their owners get ``done`` events; on a crash the service recovers
   in place (``KVService.crash()``: every shard replays its WAL), the
   recovered state is re-adopted into the history, and every in-flight
   client gets a ``crashed`` event (its verdict is lost, not wrong).

After the scheduled waves the driver disarms all traps, drains the
in-flight tail, and hands the history to the linearizability checker.
Every source of nondeterminism is a seeded machine PRNG, so the same
scenario seed reproduces the run event-for-event — the determinism
regression asserts byte-identical traces and final state, and the port's
traces equal the reference's (``tests/test_torch_chaos_scenarios.py``).

``device`` (default ``"cuda"``) is the service's: kernel shards run the
PMwCAS kernel on the card and sim shards the simulator kernel, one
launch a round; durable shards are host code.  It is checked when the
driver is made, for every backend kind: ``"cuda"`` without a card
raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import SimulatedCrash
from repro_torch.obs import SloEngine, SloSpec, instant, span
from repro_torch.pmwcas import resolve_device
from repro_torch.service import KVService
from repro_torch.structures import KVOp, SCAN

from .history import CheckStats, HistoryRecorder, check_history
from .machines import (ARM_CRASH, ARM_MIG_CRASH, CALM, ClientMachine,
                       ClientSpec, FaultMachine, FaultSpec, MIGRATE,
                       STALL, STORM)


# the degradation objectives every scenario is judged against WHILE its
# faults fire (one observation per wave; multi-window burn semantics in
# repro_torch.obs.slo).  Bounds are deliberately loose — chaos runs
# measure degradation, not steady-state speed — and the per-family
# verdict lands in ``ChaosReport.slo``.
CHAOS_SLOS = (
    SloSpec("p99_latency_ceiling", "p99_latency_us", 5_000_000.0,
            "ceiling", error_budget=0.2,
            description="client p99 completion latency stays under 5s "
                        "through crashes and storms"),
    SloSpec("throughput_floor", "ops_per_s", 1.0, "floor",
            error_budget=0.34,
            description="completed ops per wall second stays above 1"),
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible chaos scenario (see
    :mod:`repro_torch.chaos.scenarios` for the named families)."""
    name: str
    family: str
    client: ClientSpec
    faults: Tuple[FaultSpec, ...] = ()
    n_clients: int = 6
    waves: int = 60
    n_shards: int = 2
    n_buckets: int = 32
    backend: str = "durable"
    structure: str = "hashmap"
    load_keys: int = 12            # deterministic pre-populated keys
    round_cap: int = 8
    # prune cadence in waves; the step counter survives crashes (the
    # recovered service carries its ServiceStats), so the cadence fires
    # on schedule regardless of crash spacing
    wal_prune_every: int = 6
    # epoch durability knobs (KVService pass-through): rounds per shared
    # fence and epochs per WAL checkpoint (1/0 = classic per-round mode)
    epoch_rounds: int = 1
    checkpoint_every: int = 0
    seed: int = 0


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one scenario run."""
    scenario: Scenario
    waves_run: int = 0
    ops_invoked: int = 0
    ops_completed: int = 0
    crashes: int = 0
    faults_fired: int = 0
    migrations: int = 0            # key-range migrations decided
    wal_records: int = 0           # descriptor records left across shards
    wal_pruned: int = 0
    elapsed_s: float = 0.0
    p99_latency_us: float = 0.0    # final client p99 (stats survive crashes)
    # per-family degradation verdict: the SLO report evaluated DURING
    # the fault schedule (None only if the run never reached the loop)
    slo: Optional[Dict] = None
    check: Optional[CheckStats] = None
    trace_lines: List[str] = dataclasses.field(default_factory=list)
    final_items: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def ops_per_s(self) -> float:
        return self.ops_completed / self.elapsed_s if self.elapsed_s else 0.0

    def summary(self) -> str:
        c = self.check
        verdict = ("LINEARIZABLE" if c is not None and c.ok else "UNCHECKED")
        return (f"{self.scenario.name}: {verdict} — "
                f"{self.ops_completed}/{self.ops_invoked} ops in "
                f"{self.waves_run} waves, {self.crashes} crashes, "
                f"{self.faults_fired} faults fired"
                + (f"; checked {c.immediates} immediates + {c.mutations} "
                   f"mutations, {c.indeterminate} indeterminate"
                   if c is not None else ""))


class ScenarioDriver:
    """Run one :class:`Scenario` to completion (see module docstring)."""

    # drain budget after the scheduled waves: in-flight ops retry under
    # the service's own EXHAUSTED bound, so this only guards a stuck loop
    DRAIN_CAP = 512

    def __init__(self, scenario: Scenario, durable_root=None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.scenario = scenario
        self.device = resolve_device(device)
        self._tmpdir = None
        if durable_root is None and scenario.backend == "durable":
            # durable scenarios need a root the DRIVER owns: the
            # migration decision log derives from it, and a crash must
            # find the same pools again (auto-cleaned on GC)
            self._tmpdir = tempfile.TemporaryDirectory(prefix="chaos_run_")
            durable_root = self._tmpdir.name
        self.durable_root = durable_root
        sc = scenario
        self.clients = [
            ClientMachine(f"c{i}", sc.client, seed=sc.seed * 1000 + i)
            for i in range(sc.n_clients)]
        self.faults = [
            FaultMachine(fs, seed=sc.seed * 1000 + 500 + j)
            for j, fs in enumerate(sc.faults)]
        self.recorder = HistoryRecorder()
        self.report = ChaosReport(scenario=sc)
        self.svc: Optional[KVService] = None
        # outstanding futures: (future, owning client, driver-global seq)
        # — the driver numbers ops itself because KVService.crash()
        # rebuilds the service and restarts its internal sequence
        self._outstanding: List[Tuple[object, ClientMachine, int]] = []
        self._seq = 0
        # service-step -> driver-wave map: with epoch durability, an ack
        # can be withheld for waves after its verdict was decided; the
        # history records the DECIDED wave (fut.done_step), where the
        # op's effect became visible to later reads
        self._wave_of_step: Dict[int, int] = {}

    # -- service plumbing ------------------------------------------------------
    def _build_service(self) -> KVService:
        sc = self.scenario
        return KVService(sc.n_shards, structure=sc.structure,
                         backend=sc.backend, n_buckets=sc.n_buckets,
                         round_cap=sc.round_cap,
                         durable_root=self.durable_root,
                         wal_prune_every=sc.wal_prune_every,
                         epoch_rounds=sc.epoch_rounds,
                         checkpoint_every=sc.checkpoint_every,
                         device=self.device)

    def _load_phase(self) -> None:
        """Deterministic pre-population, recorded as the checker's base."""
        sc = self.scenario
        rng = np.random.default_rng(sc.seed + 0xC0A5)
        keys = rng.permutation(sc.client.n_keys)[:sc.load_keys]
        ops = [KVOp("insert", int(k) + 1, int(rng.integers(1, 1 << 20)))
               for k in keys]
        self.svc.apply(ops)
        self.recorder.base(self.svc.check_integrity())

    def _arm_crash(self, shard: int, persists_ahead: int) -> None:
        pool = getattr(self.svc.backends[shard], "pool", None)
        if pool is not None:                   # durable shards only
            pool.crash_after = pool.persist_count + persists_ahead

    def _disarm_all(self) -> None:
        for b in self.svc.backends:
            pool = getattr(b, "pool", None)
            if pool is not None:
                pool.crash_after = None
        if self.svc.mig_pool is not None:
            self.svc.mig_pool.crash_after = None

    def _wal_record_count(self) -> int:
        total = 0
        for b in self.svc.backends:
            pool = getattr(b, "pool", None)
            if pool is not None:
                total += len(pool.listdir("wal"))
        return total

    # -- wave mechanics --------------------------------------------------------
    def _apply_directives(self) -> None:
        for fm in self.faults:
            for d in fm.drain_directives():
                # every injected fault is an instant event: the chaos
                # trace shows faults inline with the service waves
                if d[0] == ARM_CRASH:
                    instant("chaos.fault", kind="crash_trap", shard=d[1],
                            persists_ahead=d[2])
                    self._arm_crash(d[1], d[2])
                elif d[0] == STALL:
                    instant("chaos.fault", kind="stall", client=d[1],
                            waves=d[2])
                    self.clients[d[1]].post("stall", waves=d[2])
                elif d[0] == STORM:
                    instant("chaos.fault", kind="storm", shard=d[1])
                    for c in self.clients:
                        c.post("storm", shard=d[1])
                elif d[0] == CALM:
                    instant("chaos.fault", kind="calm")
                    for c in self.clients:
                        c.post("calm")
                elif d[0] == MIGRATE:
                    instant("chaos.fault", kind="migrate", lo=d[1],
                            hi=d[2], dst=d[3])
                    try:
                        # the decide persist runs here; an armed trap may
                        # spring on it (caller handles SimulatedCrash)
                        self.svc.start_migration(d[1], d[2], d[3])
                        self.report.migrations += 1
                    except RuntimeError:
                        pass       # overlaps an in-flight migration: skip
                elif d[0] == ARM_MIG_CRASH:
                    instant("chaos.fault", kind="mig_crash_trap",
                            persists_ahead=d[1])
                    pool = self.svc.mig_pool
                    if pool is not None:
                        pool.crash_after = pool.persist_count + d[1]

    def _submit_outboxes(self, wave: int) -> int:
        scans = 0
        for c in self.clients:
            if c.outbox is None:
                continue
            op, c.outbox = c.outbox, None
            fut = self.svc.submit(op, client=c.name)
            self._seq += 1
            self.recorder.invoke(wave, c.name, self._seq, op.kind,
                                 op.key, op.value)
            self.report.ops_invoked += 1
            self._outstanding.append((fut, c, self._seq))
            if op.kind == SCAN:
                scans += 1
        return scans

    def _collect_completions(self, wave: int) -> int:
        done = 0
        still = []
        for fut, c, seq in self._outstanding:
            if fut.done:
                decided = self._wave_of_step.get(
                    getattr(fut, "done_step", None), wave)
                self.recorder.complete(decided, seq, fut.result.status,
                                       fut.result.value)
                c.post("done", status=fut.result.status)
                c.process()
                self.report.ops_completed += 1
                done += 1
            else:
                still.append((fut, c, seq))
        self._outstanding = still
        return done

    def _handle_crash(self, wave: int) -> None:
        self.report.crashes += 1
        instant("chaos.fault", kind="crash", wave=wave)
        self.recorder.crash(wave)
        # the recovered service carries its stats (monotone counters),
        # so the prune count is read once, at end of run
        with span("chaos.crash_recover", wave=wave):
            self.svc = self.svc.crash()        # per-shard WAL replay
        self._disarm_all()                     # fresh pools carry no trap
        self.recorder.adopt(wave, self.svc.check_integrity())
        for _fut, c, _seq in self._outstanding:  # verdicts lost, not wrong
            c.post("crashed")
            c.process()
        self._outstanding = []
        for fm in self.faults:
            fm.post("crash", wave=wave)
            fm.process()

    def _step_wave(self, wave: int, scans_pending: int) -> None:
        for fm in self.faults:
            fm.post("tick", wave=wave, scans_pending=scans_pending)
            fm.process()
        try:
            # directive application can itself persist (a MIGRATE's
            # decide record) and spring a previously-armed trap
            self._apply_directives()
            self.svc.step()
        except SimulatedCrash:
            self._handle_crash(wave)
            return
        self._wave_of_step.setdefault(self.svc.stats.steps, wave)
        self._collect_completions(wave)

    # -- entry point -----------------------------------------------------------
    def run(self) -> ChaosReport:
        sc = self.scenario
        t0 = time.monotonic()
        # SLOs are judged DURING the fault schedule, one observation per
        # wave — degradation inside the windows is the measurement
        slo_engine = SloEngine(CHAOS_SLOS, short_window=8, long_window=32)
        with span("chaos.scenario", scenario=sc.name,
                  family=sc.family) as sp:
            self.svc = self._build_service()
            self._load_phase()
            wave = 0
            for wave in range(1, sc.waves + 1):
                for c in self.clients:
                    c.post("tick", wave=wave)
                    c.process()
                scans = self._submit_outboxes(wave)
                self._step_wave(wave, scans)
                elapsed = time.monotonic() - t0
                slo_engine.observe({
                    "p99_latency_us": self.svc.stats.p99_latency_us,
                    "ops_per_s": (self.report.ops_completed / elapsed
                                  if elapsed > 0 else 0.0)})
            # drain the in-flight tail with faults disarmed (clients
            # issue nothing new; the EXHAUSTED bound caps retries)
            self._disarm_all()
            for extra in range(self.DRAIN_CAP):
                if not self._outstanding and not self.svc._migrations:
                    break
                wave += 1
                try:
                    self.svc.step()
                except SimulatedCrash:         # a pre-armed trap's tail
                    self._handle_crash(wave)
                    continue
                self._wave_of_step.setdefault(self.svc.stats.steps, wave)
                self._collect_completions(wave)
            if self._outstanding:
                raise RuntimeError(
                    f"{sc.name}: {len(self._outstanding)} ops still in "
                    f"flight after {self.DRAIN_CAP} drain waves")
            self.report.waves_run = wave
            self.report.final_items = self.svc.check_integrity()
            self.recorder.final(self.report.final_items)
            self.report.faults_fired = sum(fm.fired for fm in self.faults)
            self.report.wal_records = self._wal_record_count()
            self.report.wal_pruned += self.svc.stats.wal_pruned
            self.report.p99_latency_us = self.svc.stats.p99_latency_us
            self.report.slo = slo_engine.report(
                section=f"chaos.{sc.family}")
            sp.set(waves=wave, crashes=self.report.crashes,
                   slo_ok=self.report.slo["ok"])
        self.report.elapsed_s = time.monotonic() - t0
        self.report.trace_lines = self.trace_lines()
        self.report.check = check_history(self.recorder.events)
        return self.report

    def trace_lines(self) -> List[str]:
        """Canonical text trace: every machine's statechart trace plus
        the history events, byte-comparable across runs."""
        lines: List[str] = []
        for m in self.clients + self.faults:
            lines.extend(m.trace_lines())
        lines.extend(self.recorder.canonical_lines())
        return lines
