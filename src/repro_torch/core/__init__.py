"""The port's share of ``repro.core``: so far only the workload model's
Zipf popularity law.  The cycle-accurate simulator (engine, sim,
recovery) is ROADMAP Queue 1 #7."""
from .model import zipf_probs

__all__ = ["zipf_probs"]
