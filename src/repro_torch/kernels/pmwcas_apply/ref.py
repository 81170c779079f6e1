"""Plain PyTorch versions of the batched deterministic MwCAS primitive.

Semantics ("conservative one-shot", DESIGN.md Sec. 2.2): descriptor i
succeeds iff
  (a) every target's current value equals its expected value, and
  (b) for every target address, no lower-index descriptor that also
      passes (a) targets the same address (index order = linearization).
Each address is written at most once per batch; losers retry next round.
Padded slots have address < 0.

Words are the uint32 bit patterns held in int32 tensors (torch's uint32
lacks ``index_put``); equality is all the verdict needs, so the sign is
irrelevant here.  These functions are what the CPU runs and what the
CUDA kernel is held against on the card; the pairwise O((BK)^2) form of
condition (b) lives here only.
"""
from __future__ import annotations

import numpy as np
import torch


def pmwcas_success(addr: torch.Tensor, cur: torch.Tensor,
                   exp: torch.Tensor) -> torch.Tensor:
    """addr int32[..., B, K] (<0 = padding), cur/exp int32[..., B, K]
    -> bool[..., B] (leading dims are independent batches)."""
    *lead, B, K = addr.shape
    valid = addr >= 0
    row_pass = torch.where(valid, cur == exp, True).all(dim=-1)       # (a)

    fa = addr.reshape(*lead, B * K)
    fvalid = valid.reshape(*lead, B * K)
    fpass = row_pass.repeat_interleave(K, dim=-1)     # row (a) per slot
    idx = torch.arange(B, device=addr.device).repeat_interleave(K)

    same = (fa[..., :, None] == fa[..., None, :]) \
        & fvalid[..., :, None] & fvalid[..., None, :]
    lower = idx[None, :] < idx[:, None]
    lose = (same & lower & fpass[..., None, :]).any(dim=-1)            # (b)
    row_lose = lose.reshape(*lead, B, K).any(dim=-1)
    return row_pass & ~row_lose


def _shadowed(addr: torch.Tensor) -> torch.Tensor:
    """Slots whose address repeats at a LATER slot of the same row: a
    winning row with a duplicate id keeps the last slot's desired value
    (the kernel writes a row's slots in order)."""
    K = addr.shape[-1]
    later = torch.ones(K, K, dtype=torch.bool, device=addr.device).triu(1)
    return ((addr[..., :, None] == addr[..., None, :]) & later).any(dim=-1)


def pmwcas_apply_stacked(words: torch.Tensor, addr: torch.Tensor,
                         exp: torch.Tensor, des: torch.Tensor):
    """``S`` shard rounds against ``words int32[S, W]``, updated IN PLACE;
    ``addr/exp/des [S, B, K]``.  Returns ``(words, success bool[S, B])``."""
    S, W = words.shape
    cur = torch.gather(words, 1, addr.clamp(min=0).reshape(S, -1)
                       ).reshape(addr.shape)
    success = pmwcas_success(addr, cur, exp)
    write = (addr >= 0) & success[..., None] & ~_shadowed(addr)
    base = torch.arange(S, device=words.device).reshape(S, 1, 1) * W
    words.view(-1)[(base + addr)[write]] = des[write]
    return words, success


def pmwcas_apply(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
                 des: torch.Tensor):
    """One round against ``words int32[W]`` (updated in place); returns
    ``(words, success bool[B])``."""
    _, success = pmwcas_apply_stacked(words[None], addr[None], exp[None],
                                      des[None])
    return words, success[0]


def sequential_oracle(words, addr, exp, des):
    """True sequential one-touch application (numpy).  The conservative
    parallel semantics must be a SUBSET of these successes, and must agree
    wherever it succeeds."""
    words = np.asarray(words).copy()
    B, K = addr.shape
    touched = set()
    success = np.zeros(B, bool)
    for i in range(B):
        tgts = [(int(addr[i, k]), int(exp[i, k]), int(des[i, k]))
                for k in range(K) if addr[i, k] >= 0]
        if any(a in touched for a, _, _ in tgts):
            continue
        if all(words[a] == e for a, e, _ in tgts):
            for a, _, d in tgts:
                words[a] = d
                touched.add(a)
            success[i] = True
    return words, success
