"""Workload model shared by the simulator benchmark and the structures
workloads.  Only the popularity law is ported so far; the simulator's
state model waits for ROADMAP Queue 1 #7."""
from __future__ import annotations

import numpy as np


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    """Eq. (1): f(k; alpha, |W|) over word ranks 1..n."""
    if alpha == 0.0:
        return np.full(n, 1.0 / n)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()
