"""The named scenario families and the chaos sweep entry point.

Each family is a factory returning a :class:`repro_torch.chaos.Scenario`;
the durable-backed families all carry a crash schedule (the acceptance
bar: crash/recover cycles under every workload shape), plus their own
twist:

- :func:`hot_key_storm` — a shard-targeted storm migrates between
  shards while crashes land mid-storm (contention + recovery).
- :func:`crash_mid_scan` — scan-heavy clients; the trap only springs on
  waves with a scan in flight, so lost verdicts include range reads.
- :func:`straggler` — a fault machine keeps stalling one client, so
  in-flight windows span many waves when the crash lands.
- :func:`drifting_skew` — the Zipf-hot keys rotate through the keyspace
  on a cadence (the skew the paper's static Eq. 1 workloads never move).
- :func:`crash_mid_migration` — online key-range shard migrations under
  live traffic, with crashes scheduled into the copy and the swing; the
  decision log must leave every migration invisible or completed.
- :func:`epoch_boundary` — epoch durability on (rounds share one fence,
  acks held behind open epochs), with crashes aimed at the epoch-close
  and checkpoint persists; acked ops must survive every landing.
- :func:`sim_native` — the same client machines on SIM-backed shards:
  full KV ops on the cycle-accurate micro-op machines (native desired
  values), no crash faults (the simulator models cores, not pools).

``chaos_sweep`` runs a list of scenarios (default: all seven) and
returns their reports; every history must check out linearizable.  The
families are the reference's, field for field; ``device`` (default
``"cuda"``) is where the service's kernel and sim shards run.
"""
from __future__ import annotations

import tempfile
from typing import List, Optional, Sequence, Union

import torch

from .driver import ChaosReport, Scenario, ScenarioDriver
from .machines import (CRASH_AT_PERSIST, CRASH_MID_MIGRATION,
                       CRASH_MID_SCAN, ClientSpec, EPOCH_BOUNDARY,
                       FaultSpec, SHARD_STORM, STRAGGLER)


def _crash(n_shards: int, *, first_wave: int = 8, gap_lo: int = 10,
           gap_hi: int = 18, persists_hi: int = 14) -> FaultSpec:
    return FaultSpec(kind=CRASH_AT_PERSIST, n_shards=n_shards,
                     first_wave=first_wave, gap_lo=gap_lo, gap_hi=gap_hi,
                     persists_hi=persists_hi)


def hot_key_storm(seed: int = 0, waves: int = 60) -> Scenario:
    n_shards = 2
    client = ClientSpec(n_keys=32, alpha=1.1, read=0.35, update=0.3,
                        insert=0.2, delete=0.1, scan=0.05,
                        storm_bias=0.9, n_shards=n_shards)
    return Scenario(
        name=f"hot_key_storm/s{seed}", family="hot_key_storm",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        faults=(FaultSpec(kind=SHARD_STORM, n_shards=n_shards,
                          first_wave=5, storm_len=10, gap_lo=6, gap_hi=10),
                _crash(n_shards, first_wave=12)))


def crash_mid_scan(seed: int = 0, waves: int = 60) -> Scenario:
    n_shards = 2
    client = ClientSpec(n_keys=32, alpha=0.6, read=0.25, update=0.2,
                        insert=0.15, delete=0.1, scan=0.3,
                        n_shards=n_shards)
    return Scenario(
        name=f"crash_mid_scan/s{seed}", family="crash_mid_scan",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        faults=(FaultSpec(kind=CRASH_MID_SCAN, n_shards=n_shards,
                          first_wave=6, gap_lo=10, gap_hi=16),))


def straggler(seed: int = 0, waves: int = 60) -> Scenario:
    n_shards = 2
    client = ClientSpec(n_keys=32, alpha=0.9, read=0.4, update=0.25,
                        insert=0.2, delete=0.1, scan=0.05,
                        think_hi=3, n_shards=n_shards)
    return Scenario(
        name=f"straggler/s{seed}", family="straggler",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        faults=(FaultSpec(kind=STRAGGLER, n_shards=n_shards,
                          n_clients=6, first_wave=4, gap_lo=4, gap_hi=8,
                          stall_waves=8),
                _crash(n_shards, first_wave=14)))


def drifting_skew(seed: int = 0, waves: int = 60) -> Scenario:
    n_shards = 2
    client = ClientSpec(n_keys=32, alpha=1.2, read=0.4, update=0.25,
                        insert=0.2, delete=0.1, scan=0.05,
                        drift_every=6, drift_step=5, n_shards=n_shards)
    return Scenario(
        name=f"drifting_skew/s{seed}", family="drifting_skew",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        faults=(_crash(n_shards, first_wave=10),))


def crash_mid_migration(seed: int = 0, waves: int = 60) -> Scenario:
    """Online key-range shard migrations under client traffic, with
    crashes scheduled INTO the migration: half trap the decision log's
    own persists (decide / swing), half a shard WAL pool (mid-copy).
    Recovery must leave each migration invisible or completed — the
    history stays linearizable either way (a migration moves keys, it
    never changes a value)."""
    n_shards = 3
    client = ClientSpec(n_keys=32, alpha=0.9, read=0.4, update=0.25,
                        insert=0.2, delete=0.1, scan=0.05,
                        n_shards=n_shards)
    return Scenario(
        name=f"crash_mid_migration/s{seed}", family="crash_mid_migration",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        faults=(FaultSpec(kind=CRASH_MID_MIGRATION, n_shards=n_shards,
                          n_keys=32, first_wave=6, gap_lo=8, gap_hi=14,
                          persists_lo=2, persists_hi=10, storm_len=10),))


def epoch_boundary(seed: int = 0, waves: int = 60) -> Scenario:
    """Crashes aimed at epoch-close/checkpoint fences, with epoch
    durability ON (``epoch_rounds=4``, ``checkpoint_every=2``).  Under
    the epoch protocol nearly every persist a shard issues IS an epoch
    boundary, so a small ``persists_ahead`` budget (1..3) lands the
    crash exactly on one.  The service withholds acks behind open
    epochs, so every acked op must survive — the checker sees lost
    in-flight verdicts as indeterminate, never a revoked ack — and the
    epoch checkpoints must keep the WAL bounded despite the crashes."""
    n_shards = 2
    client = ClientSpec(n_keys=32, alpha=0.9, read=0.4, update=0.25,
                        insert=0.2, delete=0.1, scan=0.05,
                        n_shards=n_shards)
    return Scenario(
        name=f"epoch_boundary/s{seed}", family="epoch_boundary",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        epoch_rounds=4, checkpoint_every=2, wal_prune_every=0,
        faults=(FaultSpec(kind=EPOCH_BOUNDARY, n_shards=n_shards,
                          first_wave=8, gap_lo=10, gap_hi=16,
                          persists_lo=1, persists_hi=3),))


def sim_native(seed: int = 0, waves: int = 40) -> Scenario:
    """KV chaos on SIM-backed shards: the native-desired-value path —
    real inserts/updates/deletes (keys, values, TOMBSTONEs) running on
    the cycle-accurate state machines, no shadow words."""
    n_shards = 2
    client = ClientSpec(n_keys=24, alpha=0.9, read=0.4, update=0.25,
                        insert=0.2, delete=0.1, scan=0.05,
                        drift_every=8, drift_step=3, n_shards=n_shards)
    return Scenario(
        name=f"sim_native/s{seed}", family="sim_native",
        client=client, waves=waves, n_shards=n_shards, seed=seed,
        backend="sim", n_buckets=24, wal_prune_every=0)


FAMILIES = {
    "hot_key_storm": hot_key_storm,
    "crash_mid_scan": crash_mid_scan,
    "straggler": straggler,
    "drifting_skew": drifting_skew,
    "crash_mid_migration": crash_mid_migration,
    "epoch_boundary": epoch_boundary,
    "sim_native": sim_native,
}


def default_scenarios(seed: int = 0, waves: int = 60) -> List[Scenario]:
    out = [make(seed=seed, waves=waves) for name, make in FAMILIES.items()
           if name != "sim_native"]
    out.append(sim_native(seed=seed, waves=max(20, waves // 2)))
    return out


def run_scenario(scenario: Scenario, durable_root=None, *,
                 device: Union[str, torch.device] = "cuda"
                 ) -> ChaosReport:
    """Run one scenario; durable scenarios get a temp root when none is
    given (auto-cleaned per-shard pools)."""
    return ScenarioDriver(scenario, durable_root=durable_root,
                          device=device).run()


def chaos_sweep(scenarios: Optional[Sequence[Scenario]] = None, *,
                seed: int = 0, waves: int = 60,
                durable_root=None,
                device: Union[str, torch.device] = "cuda"
                ) -> List[ChaosReport]:
    """Run every scenario (default: every family) and check every
    history.  Raises :class:`LinearizabilityError` on the
    first violation — a passing sweep IS the correctness claim."""
    scenarios = (default_scenarios(seed=seed, waves=waves)
                 if scenarios is None else list(scenarios))
    reports = []
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
        for i, sc in enumerate(scenarios):
            root = (None if durable_root is None and sc.backend != "durable"
                    else f"{durable_root or tmp}/run{i}")
            reports.append(run_scenario(sc, durable_root=root,
                                        device=device))
    return reports
