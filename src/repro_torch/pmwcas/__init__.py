"""PMwCAS API of the port: one operation model, a pluggable backend.

- operation model: :class:`Target`, :class:`MwCASOp`, :class:`Descriptor`,
  :class:`OpResult` and the array wire form (``ops_to_arrays``)
- :class:`Backend` protocol with :class:`KernelBackend` (the Hopper
  kernel on CUDA, its plain PyTorch version on the CPU) and
  :class:`DurableBackend` (the descriptor-WAL committer, host code), the
  backend registry, and ``resolve_device``
- :func:`run_differential` for kernel-against-durable agreement checks
- the batched primitives ``pmwcas_apply``, ``pmwcas_apply_stacked``,
  ``reserve_slots``, dispatched by the tensors' device, with their plain
  versions (``pmwcas_success_ref``, ``pmwcas_apply_ref``) and the numpy
  ``sequential_oracle``

The simulator, its strategies and sessions, and the simulator's entry in
the differential come with a later slice (ROADMAP Queue 1 #7).
"""
from repro_torch.checkpoint.committer import DurabilityStats
from repro_torch.core.model import zipf_probs
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

from .backends import (BACKEND_FACTORIES, Backend, DurableBackend,
                       KernelBackend, make_backend, register_backend,
                       resolve_device)
from .descriptor import (Addr, Descriptor, MwCASOp, OpResult, Target,
                         batch_width, ops_from_arrays, ops_to_arrays,
                         results_from_mask)
from .differential import (DifferentialReport, increment_batch,
                           run_differential)

__all__ = [
    # operation model
    "Addr", "Target", "MwCASOp", "Descriptor", "OpResult",
    "batch_width", "ops_to_arrays", "ops_from_arrays", "results_from_mask",
    # backends
    "Backend", "KernelBackend", "DurableBackend", "DurabilityStats",
    "make_backend", "register_backend", "BACKEND_FACTORIES",
    "resolve_device", "zipf_probs",
    # differential
    "run_differential", "increment_batch", "DifferentialReport",
    # batched primitives
    "pmwcas_apply", "pmwcas_apply_stacked", "reserve_slots",
    "pmwcas_apply_cuda", "words_to_tensor",
    "tensor_to_words",
    "pmwcas_apply_ref", "pmwcas_apply_stacked_ref", "pmwcas_success_ref",
    "sequential_oracle",
]
