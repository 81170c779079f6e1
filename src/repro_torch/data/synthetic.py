"""Deterministic, sharded, checkpointable synthetic token pipeline.

A copy of the reference's ``repro/data/synthetic.py`` (numpy only): the
same batches, bit for bit, for the same config, step and host.  A
stateless function of (seed, step, host) — so the "iterator state" that
must be committed atomically with params/opt is just {seed, step}.  The
stream is a mixture of Zipf-distributed tokens with Markov structure so
cross-entropy is learnable."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_alpha: float = 1.1


class SyntheticStream:
    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        c = cfg
        ranks = np.arange(1, c.vocab + 1, dtype=np.float64)
        p = ranks ** (-c.zipf_alpha)
        self._p = p / p.sum()
        # fixed "grammar": each token deterministically prefers a successor
        g = np.random.default_rng(c.seed ^ 0xBADC0DE)
        self._succ = g.integers(0, c.vocab, size=c.vocab)

    @property
    def local_batch(self) -> int:
        assert self.cfg.global_batch % self.cfg.n_hosts == 0
        return self.cfg.global_batch // self.cfg.n_hosts

    def state(self) -> Dict[str, int]:
        return {"seed": self.cfg.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg: DataConfig, state) -> "SyntheticStream":
        return cls(dataclasses.replace(cfg, seed=int(state["seed"])),
                   step=int(state["step"]))

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, self.step, c.host_id))
        B, S = self.local_batch, c.seq_len
        toks = rng.choice(c.vocab, size=(B, S), p=self._p)
        # 75% of positions follow the grammar: predictable successor
        follow = rng.random((B, S - 1)) < 0.75
        nxt = self._succ[toks[:, :-1]]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        batch = {
            "tokens": toks.astype(np.int32),
            "labels": np.concatenate(
                [toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32),
        }
        self.step += 1
        return batch
