"""The paper's primary contribution: practical persistent multi-word CAS.

- ``model``     state + configuration for the many-core simulator
- ``engine``    the four algorithms as micro-op state machines (the plain
  version of the simulator kernel)
- ``sim``       the simulation driver + instrumentation: ``run_sims``
  runs many simulations in one launch of ``csrc/pmwcas_sim.cu`` on the
  card, or through the plain version on the CPU
- ``recovery``  crash recovery from persisted descriptors (the WAL insight)
"""
from .model import (ALG_ORIGINAL, ALG_OURS, ALG_OURS_DF, ALG_PCAS, ALGORITHMS,
                    CostModel, SimConfig, generate_ops, generate_schedule,
                    init_state, state_from_arrays, state_to_arrays,
                    zipf_probs)
from .recovery import (RecoveryError, check_crash_consistency,
                       committed_histogram, recover)
from .sim import SimResult, run_sim, run_sims, run_state, run_until

__all__ = [
    "ALG_ORIGINAL", "ALG_OURS", "ALG_OURS_DF", "ALG_PCAS", "ALGORITHMS",
    "CostModel", "SimConfig", "SimResult", "generate_ops",
    "generate_schedule", "init_state", "run_sim", "run_until", "recover",
    "committed_histogram", "check_crash_consistency", "RecoveryError",
    "run_sims", "run_state", "state_from_arrays", "state_to_arrays",
    "zipf_probs",
]
