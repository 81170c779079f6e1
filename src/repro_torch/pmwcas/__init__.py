"""PMwCAS API of the port: one operation model, a pluggable backend.

- operation model: :class:`Target`, :class:`MwCASOp`, :class:`Descriptor`,
  :class:`OpResult` and the array wire form (``ops_to_arrays``)
- :class:`Backend` protocol with :class:`SimBackend` (the cycle-accurate
  simulator: its Hopper kernel on CUDA, its plain version on the CPU),
  :class:`KernelBackend` (the Hopper PMwCAS kernel on CUDA, its plain
  PyTorch version on the CPU) and :class:`DurableBackend` (the
  descriptor-WAL committer, host code), the backend registry, and
  ``resolve_device``
- algorithm strategies :data:`OURS`, :data:`OURS_DF`, :data:`ORIGINAL`,
  :data:`PCAS`
- the fluent :class:`SimSession` builder over the simulator, ``run_sim``
  / ``run_until`` / ``run_sims``, crash recovery and its invariant
- :func:`run_differential` for sim/kernel/durable agreement checks
- the batched primitives ``pmwcas_apply``, ``pmwcas_apply_stacked``,
  ``reserve_slots``, dispatched by the tensors' device, with their plain
  versions (``pmwcas_success_ref``, ``pmwcas_apply_ref``) and the numpy
  ``sequential_oracle``
"""
from repro_torch.checkpoint.committer import DurabilityStats
from repro_torch.core import (CostModel, RecoveryError, SimConfig, SimResult,
                              check_crash_consistency, committed_histogram,
                              recover, run_sim, run_sims, run_until)
# Instrumentation vocabulary (counter slots / tag bits)
from repro_torch.core.model import (ALGORITHMS, CNT_CAS, CNT_CYCLES,
                                    CNT_FAILS, CNT_FLUSH, CNT_HELPS,
                                    CNT_INVAL, CNT_LOAD, CNT_OPS, CNT_STORE,
                                    TAG_DESC, TAG_DESC_DIRTY, TAG_DIRTY,
                                    TAG_MASK, TAG_PAYLOAD, TAG_SHIFT,
                                    generate_ops, generate_schedule,
                                    zipf_probs)
from repro_torch.kernels.pmwcas_apply.kernel import pmwcas_apply_cuda
from repro_torch.kernels.pmwcas_apply.ops import (pmwcas_apply,
                                                  pmwcas_apply_stacked,
                                                  reserve_slots,
                                                  tensor_to_words,
                                                  words_to_tensor)
from repro_torch.kernels.pmwcas_apply.ref import (
    pmwcas_apply as pmwcas_apply_ref,
    pmwcas_apply_stacked as pmwcas_apply_stacked_ref,
    pmwcas_success as pmwcas_success_ref, sequential_oracle)

from .algorithms import (Algorithm, ORIGINAL, OURS, OURS_DF, PCAS,
                         STRATEGIES, resolve)
from .backends import (BACKEND_FACTORIES, Backend, DurableBackend,
                       KernelBackend, SimBackend, UnsupportedBatch,
                       make_backend, register_backend, resolve_device)
from .descriptor import (Addr, Descriptor, MwCASOp, OpResult, Target,
                         batch_width, ops_from_arrays, ops_to_arrays,
                         results_from_mask)
from .differential import (DifferentialReport, increment_batch,
                           run_differential)
from .session import SimSession

__all__ = [
    # operation model
    "Addr", "Target", "MwCASOp", "Descriptor", "OpResult",
    "batch_width", "ops_to_arrays", "ops_from_arrays", "results_from_mask",
    # strategies
    "Algorithm", "OURS", "OURS_DF", "ORIGINAL", "PCAS", "STRATEGIES",
    "resolve", "ALGORITHMS",
    # backends
    "Backend", "SimBackend", "KernelBackend", "DurableBackend",
    "UnsupportedBatch", "DurabilityStats",
    "make_backend", "register_backend", "BACKEND_FACTORIES",
    "resolve_device",
    # session + sim surface
    "SimSession", "SimConfig", "SimResult", "CostModel",
    "run_sim", "run_until", "run_sims", "generate_ops", "generate_schedule",
    "zipf_probs",
    # recovery
    "recover", "committed_histogram", "check_crash_consistency",
    "RecoveryError",
    # differential
    "run_differential", "increment_batch", "DifferentialReport",
    # batched primitives
    "pmwcas_apply", "pmwcas_apply_stacked", "reserve_slots",
    "pmwcas_apply_cuda", "words_to_tensor",
    "tensor_to_words",
    "pmwcas_apply_ref", "pmwcas_apply_stacked_ref", "pmwcas_success_ref",
    "sequential_oracle",
    # instrumentation vocabulary
    "CNT_CAS", "CNT_CYCLES", "CNT_FAILS", "CNT_FLUSH", "CNT_HELPS",
    "CNT_INVAL", "CNT_LOAD", "CNT_OPS", "CNT_STORE",
    "TAG_DESC", "TAG_DESC_DIRTY", "TAG_DIRTY", "TAG_MASK", "TAG_PAYLOAD",
    "TAG_SHIFT",
]
