"""repro_torch — the PyTorch / CUDA port of the PMwCAS system.

A second package beside the JAX reference ``repro``, with the same
layout and names, so each module's counterpart is found at the same
path.  It imports ``torch``, numpy and the standard library, never
``jax`` and nothing of ``repro``.

Public surface (import from here or from the subpackages):

- ``repro_torch.pmwcas`` — operation model (``Target``/``MwCASOp``/
  ``OpResult``), ``KernelBackend`` and the backend registry, and the
  batched primitives ``pmwcas_apply``/``pmwcas_apply_stacked``/
  ``reserve_slots``: a CUDA tensor runs the hand-written Hopper kernel,
  a CPU tensor its plain PyTorch version.
- ``repro_torch.structures`` — ``HashMap`` (directory doubling
  included) and the YCSB-style workload compiler.
- ``repro_torch.service`` — ``KVService`` on sharded kernel backends,
  the stacked executor, router, migration log and ``ServiceStats``.
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
    "Target", "MwCASOp", "OpResult", "KernelBackend", "make_backend",
    "pmwcas_apply", "pmwcas_apply_stacked", "reserve_slots")}
_LAZY.update({name: "repro_torch.structures" for name in (
    "HashMap", "KVOp", "StructResult", "WorkloadSpec")})
_LAZY.update({name: "repro_torch.service" for name in (
    "KVService", "KVFuture", "ServiceStats", "load_word_tables")})
_LAZY.update({"PMemPool": "repro_torch.checkpoint"})

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
