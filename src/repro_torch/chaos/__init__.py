"""repro_torch.chaos — statechart-driven workload & fault harness with
linearizability checking, the port of ``repro.chaos``.

The layer above :mod:`repro_torch.service`: adversarial *scenarios*
instead of static workloads.  Seeded statechart machines drive client
sessions (drifting Zipf skew, storm targeting, think/await pacing) and
fault processes (crash-at-persist traps, crash-mid-scan, stragglers,
shard storms, crashes into migrations and epoch boundaries); a
:class:`ScenarioDriver` runs them against a live
:class:`repro_torch.service.KVService` wave by wave, injecting crashes
and recovering in place; every completed verdict lands in a history the
linearizability checker validates against a sequential oracle (wave
order makes that check linear-time; see :mod:`.history`).

Public surface::

    from repro_torch.chaos import chaos_sweep
    for report in chaos_sweep(seed=1, device="cuda"):
        print(report.summary())

Everything is deterministic per scenario seed — byte-identical traces
and final state across runs, including across crash/recover cycles, and
equal to the reference's on the CPU and on the card.  This layer is
host code: its machines draw from numpy generators, and the device work
is the service's (kernel and sim shards launch the port's kernels).
"""
from .statechart import Event, Machine, Transition
from .machines import (ARM_CRASH, ARM_MIG_CRASH, CALM, CRASH_AT_PERSIST,
                       CRASH_MID_MIGRATION, CRASH_MID_SCAN, ClientMachine,
                       ClientSpec, EPOCH_BOUNDARY, FAULT_KINDS,
                       FaultMachine, FaultSpec, MIGRATE, SHARD_STORM,
                       STALL, STORM, STRAGGLER)
from .history import (CheckStats, HistoryRecorder, LinearizabilityError,
                      check_history)
from .driver import ChaosReport, Scenario, ScenarioDriver
from .scenarios import (FAMILIES, chaos_sweep, crash_mid_migration,
                        crash_mid_scan, default_scenarios, drifting_skew,
                        epoch_boundary, hot_key_storm, run_scenario,
                        sim_native, straggler)

__all__ = [
    "Event", "Machine", "Transition",
    "ClientMachine", "ClientSpec", "FaultMachine", "FaultSpec",
    "FAULT_KINDS", "CRASH_AT_PERSIST", "CRASH_MID_SCAN", "STRAGGLER",
    "SHARD_STORM", "CRASH_MID_MIGRATION", "EPOCH_BOUNDARY",
    "ARM_CRASH", "STALL", "STORM", "CALM", "MIGRATE", "ARM_MIG_CRASH",
    "HistoryRecorder", "check_history", "CheckStats",
    "LinearizabilityError",
    "Scenario", "ScenarioDriver", "ChaosReport",
    "FAMILIES", "default_scenarios", "run_scenario", "chaos_sweep",
    "hot_key_storm", "crash_mid_scan", "straggler", "drifting_skew",
    "crash_mid_migration", "epoch_boundary", "sim_native",
]
