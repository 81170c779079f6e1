"""The cycle-accurate simulator's Hopper kernel: many independent
simulations interpreted in one launch (``kernel.pmwcas_sim_cuda``).  Its
plain version is ``repro_torch.core.engine.Machine`` driven by
``repro_torch.core.sim``."""
