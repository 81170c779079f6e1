"""Fold the stack's existing ``*Stats`` dataclasses into the registry.

Five disconnected stats objects grew up with the stack —
``DurabilityStats`` (checkpoint), ``DispatchStats`` (executor),
``ServiceStats`` (service), ``CheckStats`` (chaos checker) and
``WorkloadStats`` (structures).  These folds translate each into
labeled registry series WITHOUT importing any of those layers: every
fold duck-types on attribute names, so ``repro_torch.obs`` stays at the
bottom of the port's import graph (it imports nothing of
``repro_torch`` outside ``obs``).

Folds are SNAPSHOTS, so they write gauges: folding the same stats
object twice leaves the same values (idempotent), unlike counters which
would double-count.  Live accounting (the committer's per-commit flush
counters) uses registry counters directly and is a different stream —
fold names are prefixed by their source (``durability.*``,
``dispatch.*``, ``service.*``, ``check.*``, ``workload.*``) so the two
never collide.
"""
from __future__ import annotations

from typing import Optional

from .metrics import MetricsRegistry, get_registry

_DURABILITY_FIELDS = ("flushes_issued", "flushes_saved", "fences",
                      "round_commits", "op_commits", "ops_committed")
_DISPATCH_FIELDS = ("traces", "hits", "dispatches", "serial_rounds",
                    "bytes_padded")
_SHARD_FIELDS = ("rounds", "ops_executed", "ops_won", "defers",
                 "overflows", "out_of_regions")
_CHECK_FIELDS = ("immediates", "mutations", "unchecked", "crashes",
                 "indeterminate")
_WORKLOAD_FIELDS = ("n_ops", "rounds", "mwcas_submitted", "mwcas_won")


def _gauges(registry: MetricsRegistry, prefix: str, obj, fields,
            **labels) -> None:
    for f in fields:
        registry.gauge(f"{prefix}.{f}", **labels).set(getattr(obj, f))


def fold_durability(stats, registry: Optional[MetricsRegistry] = None,
                    **labels) -> MetricsRegistry:
    """``repro_torch.checkpoint.DurabilityStats`` -> ``durability.*``
    gauges."""
    registry = registry or get_registry()
    _gauges(registry, "durability", stats, _DURABILITY_FIELDS, **labels)
    registry.gauge("durability.flushes_per_commit", **labels).set(
        stats.flushes_per_commit)
    return registry


def fold_dispatch(stats, registry: Optional[MetricsRegistry] = None,
                  **labels) -> MetricsRegistry:
    """``repro_torch.service.DispatchStats`` -> ``dispatch.*`` gauges."""
    registry = registry or get_registry()
    _gauges(registry, "dispatch", stats, _DISPATCH_FIELDS, **labels)
    return registry


def fold_service(stats, registry: Optional[MetricsRegistry] = None,
                 **labels) -> MetricsRegistry:
    """``repro_torch.service.ServiceStats`` -> ``service.*`` gauges, the
    per-shard breakdown as ``shard=<i>``-labeled series, plus the
    latency percentiles (rounds AND microseconds)."""
    registry = registry or get_registry()
    _gauges(registry, "service", stats,
            ("steps", "submitted", "completed", "cross_rounds",
             "cross_ops", "journal_pruned", "wal_pruned"), **labels)
    for name, value in (
            ("rounds", stats.rounds),
            ("ops_executed", stats.ops_executed),
            ("occupancy", stats.occupancy),
            ("defer_rate", stats.defer_rate),
            ("conflict_rate", stats.conflict_rate),
            ("ops_per_step", stats.ops_per_step),
            ("p50_latency_rounds", stats.p50_latency_rounds),
            ("p99_latency_rounds", stats.p99_latency_rounds),
            ("p50_latency_us", stats.p50_latency_us),
            ("p99_latency_us", stats.p99_latency_us)):
        registry.gauge(f"service.{name}", **labels).set(value)
    for shard in stats.shards:
        _gauges(registry, "service.shard", shard, _SHARD_FIELDS,
                shard=shard.shard, **labels)
    for status, n in stats.by_status.items():
        registry.gauge("service.by_status", status=status,
                       **labels).set(n)
    if stats.dispatch is not None:
        fold_dispatch(stats.dispatch, registry, **labels)
    return registry


def fold_check(stats, registry: Optional[MetricsRegistry] = None,
               **labels) -> MetricsRegistry:
    """``repro_torch.chaos.CheckStats`` -> ``check.*`` gauges."""
    registry = registry or get_registry()
    _gauges(registry, "check", stats, _CHECK_FIELDS, **labels)
    registry.gauge("check.ok", **labels).set(int(stats.ok))
    return registry


def fold_workload(stats, registry: Optional[MetricsRegistry] = None,
                  **labels) -> MetricsRegistry:
    """``repro_torch.structures.WorkloadStats`` -> ``workload.*``
    gauges."""
    registry = registry or get_registry()
    _gauges(registry, "workload", stats, _WORKLOAD_FIELDS, **labels)
    registry.gauge("workload.retries_per_op", **labels).set(
        stats.retries_per_op)
    registry.gauge("workload.cas_ops_per_op", **labels).set(
        stats.cas_ops_per_op)
    for status, n in stats.by_status.items():
        registry.gauge("workload.by_status", status=status,
                       **labels).set(n)
    return registry
