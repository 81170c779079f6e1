"""repro_torch — the PyTorch / CUDA port of the PMwCAS system.

A second package beside the JAX reference ``repro``, with the same
layout and names, so each module's counterpart is found at the same
path.  It imports ``torch``, numpy and the standard library, never
``jax`` and nothing of ``repro``.

Public surface (import from here or from the subpackages):

- ``repro_torch.pmwcas`` — operation model (``Target``/``MwCASOp``/
  ``OpResult``), ``SimBackend``, ``KernelBackend``, ``DurableBackend``
  and the backend registry, the algorithm strategies (``OURS``,
  ``OURS_DF``, ``ORIGINAL``, ``PCAS``), ``SimSession`` and the simulator
  surface (``run_sim``/``run_until``/``run_sims``, recovery and its
  crash invariant), ``run_differential`` (sim, kernel and durable), and
  the batched primitives ``pmwcas_apply``/``pmwcas_apply_stacked``/
  ``reserve_slots``: a CUDA tensor runs the hand-written Hopper kernel,
  a CPU tensor its plain PyTorch version.
- ``repro_torch.core`` — the cycle-accurate PMwCAS simulator (the
  paper's contribution): state model, the four algorithms' micro-op
  machines, the driver that runs many simulations in one launch of
  ``csrc/pmwcas_sim.cu``, and crash recovery.
- ``repro_torch.structures`` — ``HashMap`` (directory doubling
  included), the BzTree node and multi-node ``BzTreeIndex``, the
  ``FreeListAllocator``, the YCSB-style workload compiler, the durable
  crash-at-every-persist sweeps (map, elastic map, tree), the
  simulator's crash sweep and ``run_struct_differential`` (kernel
  against durable, every round replayed on the simulator).
- ``repro_torch.service`` — ``KVService`` on sharded kernel or durable
  backends with hash-map or BzTree shards (group commit, epochs, WAL
  pruning, crash/recover, region GC), the raw-op ``BatchScheduler`` with
  its journaled cross-shard rounds, the stacked executor, router,
  migration log and ``ServiceStats``.
- checkpoint layer: ``Committer`` (the descriptor-WAL committer),
  ``MarkerCommitter`` (the dirty-flag baseline), ``CommitError``,
  ``PMemPool``, ``SimulatedCrash``.
- ``repro_torch.obs`` — metrics registry, span tracer, flush provenance.
- ``repro_torch.configs`` / ``repro_torch.models`` — the architecture
  registry and the dense attention model stack (forward, bf16 KV
  cache); ``attn_impl="pallas"`` runs the hand-written Hopper
  flash-attention kernel on a CUDA tensor.
- ``repro_torch.launch.serve`` — batched LM serving: KV-page admission
  through ``reserve_slots``, prefill and greedy decode.

Entry points take ``device=`` and default to ``"cuda"``; ``"cpu"`` is
an explicit request.  Word tables hold uint32 words as int32 bit
patterns (torch's uint32 lacks ``index_put``).
"""
from __future__ import annotations

import importlib
from typing import Any

__version__ = "0.1.0"

_SUBPACKAGES = ("checkpoint", "configs", "core", "kernels", "launch",
                "models", "obs", "pmwcas", "service", "structures")
_LAZY = {name: "repro_torch.pmwcas" for name in (
    "Target", "MwCASOp", "OpResult", "KernelBackend", "DurableBackend",
    "DurabilityStats", "make_backend", "run_differential",
    "increment_batch", "DifferentialReport",
    "pmwcas_apply", "pmwcas_apply_stacked", "reserve_slots",
    "SimBackend", "UnsupportedBatch", "SimSession", "SimConfig",
    "SimResult", "CostModel", "run_sim", "run_until", "run_sims",
    "recover", "committed_histogram", "check_crash_consistency",
    "RecoveryError", "generate_ops", "generate_schedule",
    "Algorithm", "OURS", "OURS_DF", "ORIGINAL", "PCAS", "STRATEGIES")}
_LAZY.update({name: "repro_torch.structures" for name in (
    "HashMap", "KVOp", "StructResult", "WorkloadSpec",
    "BzTreeIndex", "SortedNode", "FreeListAllocator",
    "check_durable_crash_sweep", "check_hashmap_resize_sweep",
    "check_tree_crash_sweep", "check_sim_crash_sweep",
    "run_struct_differential",
    "CrashCheckError")})
_LAZY.update({name: "repro_torch.service" for name in (
    "KVService", "KVFuture", "ServiceStats", "load_word_tables",
    "BatchScheduler", "OpFuture")})
_LAZY.update({name: "repro_torch.checkpoint" for name in (
    "Committer", "MarkerCommitter", "CommitError", "PMemPool",
    "SimulatedCrash", "data_rel")})

__all__ = sorted(_LAZY) + list(_SUBPACKAGES)


def __getattr__(name: str) -> Any:
    if name in _SUBPACKAGES:
        return importlib.import_module(f"repro_torch.{name}")
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
