"""Public op: batched MwCAS apply against word tables, dispatched by device.

A CUDA tensor goes to the hand-written Hopper kernel
(:func:`.kernel.pmwcas_apply_cuda`); a CPU tensor goes to the plain
PyTorch version (:mod:`.ref`).  There is no switch between the two: the
tensors' device decides, so the card never runs the plain version.

Unlike the reference (pure functions that return a new table), the port
updates the word table IN PLACE and returns it beside the verdicts.
Word tables hold the uint32 bit patterns in int32 tensors (torch's
uint32 lacks ``index_put``); :func:`words_to_tensor` and
:func:`tensor_to_words` convert at the numpy boundary.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import ref
from .kernel import CLAIM_FREE, check_batch, pmwcas_apply_cuda


def words_to_tensor(values, device) -> torch.Tensor:
    """numpy uint32 (or int32) words -> int32 tensor of the same bits."""
    arr = np.ascontiguousarray(values)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype != np.int32:
        raise TypeError(f"word arrays must be uint32 or int32, got "
                        f"{arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> a fresh numpy uint32 array of the same bits."""
    return t.to("cpu", copy=True).numpy().view(np.uint32)


def claim_scratch(words: torch.Tensor) -> Optional[torch.Tensor]:
    """The kernel's ``int32[S, W]`` claim table for ``words [S, W]``
    (``None`` on the CPU, whose plain version needs none).  Callers that
    launch repeatedly keep one and pass it back in."""
    if not words.is_cuda:
        return None
    return torch.full(words.shape, CLAIM_FREE, dtype=torch.int32,
                      device=words.device)


def pmwcas_apply_stacked(words: torch.Tensor, addr: torch.Tensor,
                         exp: torch.Tensor, des: torch.Tensor, *,
                         claim: Optional[torch.Tensor] = None):
    """``S`` shard rounds in ONE launch.

    ``words`` int32[S, W] stacked shard tables, updated in place;
    ``addr`` int32[S, B, K] (<0 pad); ``exp``/``des`` int32[S, B, K].
    Returns ``(words, success bool[S, B])``.  ``claim`` is the kernel's
    scratch from :func:`claim_scratch` (allocated per call if omitted).
    """
    if words.is_cuda:
        if claim is None:
            claim = claim_scratch(words)
        return words, pmwcas_apply_cuda(words, addr, exp, des, claim)
    if words.device.type != "cpu":
        raise ValueError(f"no pmwcas_apply for device {words.device}")
    check_batch(words, addr, exp, des)
    return ref.pmwcas_apply_stacked(words, addr, exp, des)


def pmwcas_apply(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
                 des: torch.Tensor, *, claim: Optional[torch.Tensor] = None):
    """One round: ``words`` int32[W] (updated in place); ``addr`` int32
    [B, K] (<0 pad); ``exp``/``des`` int32[B, K].  Returns
    ``(words, success bool[B])``.  ``claim`` is an ``int32[1, W]``
    scratch (see :func:`claim_scratch`)."""
    _, success = pmwcas_apply_stacked(words[None], addr[None], exp[None],
                                      des[None], claim=claim)
    return words, success[0]


def reserve_slots(free_mask: torch.Tensor, requests: torch.Tensor, *,
                  claim: Optional[torch.Tensor] = None):
    """KV-cache slot reservation: request i atomically claims
    ``requests[i]`` slots (a K-word MwCAS on a free-bitmap word table).

    free_mask: int32[W] (1 = free), updated in place; requests: int32
    [B, K] candidate slot ids (<0 pad).  Returns ``(free_mask,
    granted[B])``.

    Semantics corner cases (held kernel == plain in the tests):
    - duplicate slot ids within one request claim the slot once and still
      grant the request;
    - an all-padded request is vacuously granted (claims nothing);
    - overlapping requests are linearized by batch index (lower wins).
    """
    exp = torch.ones_like(requests)      # expect free
    des = torch.zeros_like(requests)     # claim
    return pmwcas_apply(free_mask, requests.contiguous(), exp, des,
                        claim=claim)
