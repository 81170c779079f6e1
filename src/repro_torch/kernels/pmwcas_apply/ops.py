"""Public op: batched MwCAS apply against word tables, dispatched by device.

A CUDA tensor goes to the hand-written Hopper kernel
(:func:`.kernel.pmwcas_apply_cuda`, on the route its ``plan`` picks from
the round's ``[B, K]``); a CPU tensor goes to the plain
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
from .kernel import check_batch, pmwcas_apply_cuda


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


def pmwcas_apply_stacked(words: torch.Tensor, addr: torch.Tensor,
                         exp: torch.Tensor, des: torch.Tensor, *,
                         addr_max: Optional[int] = None):
    """``S`` shard rounds in ONE launch.

    ``words`` int32[S, W] stacked shard tables, updated in place;
    ``addr`` int32[S, B, K] (<0 pad); ``exp``/``des`` int32[S, B, K].
    Returns ``(words, success bool[S, B])``.  ``addr_max``: the batch's
    largest address where the caller holds it on the host, so the range
    check waits for nothing.
    """
    if words.is_cuda:
        return words, pmwcas_apply_cuda(words, addr, exp, des,
                                        addr_max=addr_max)
    if words.device.type != "cpu":
        raise ValueError(f"no pmwcas_apply for device {words.device}")
    check_batch(words, addr, exp, des, addr_max)
    return ref.pmwcas_apply_stacked(words, addr, exp, des)


def pmwcas_apply(words: torch.Tensor, addr: torch.Tensor, exp: torch.Tensor,
                 des: torch.Tensor):
    """One round: ``words`` int32[W] (updated in place); ``addr`` int32
    [B, K] (<0 pad); ``exp``/``des`` int32[B, K].  Returns
    ``(words, success bool[B])``."""
    _, success = pmwcas_apply_stacked(words[None], addr[None], exp[None],
                                      des[None])
    return words, success[0]


def reserve_slots(free_mask: torch.Tensor, requests: torch.Tensor):
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
    return pmwcas_apply(free_mask, requests.contiguous(), exp, des)
