"""Free-list allocator layered on the batched ``reserve_slots`` primitive.

The serving layer already had atomic K-slot reservation on a free-bitmap
(``repro_torch.pmwcas.reserve_slots``); this wraps it into an allocator
object the other structures can compose with (e.g. a BzTree split asking
for two fresh node regions).  Allocation requests are themselves MwCAS
ops — request ``i`` atomically claims all of its candidate slots or
none — so concurrent requests linearize by batch index exactly like
every other op in this repo.

The allocator state is the free bitmap (uint32[n_slots], 1 = free),
held as an int32 tensor on an explicit device: on a CUDA device
``reserve`` and ``free`` run the hand-written PMwCAS kernel, on the CPU
its plain PyTorch version (the tensor's device decides; there is no
switch).  A slot id maps to a word *region* ``region_base + slot *
region_words`` when ``region_words`` is set, which is how callers turn
slot grants into fresh zeroed address ranges for node construction.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.pmwcas import (pmwcas_apply, reserve_slots, resolve_device,
                                tensor_to_words, words_to_tensor)


class DoubleFree(ValueError):
    """A freed slot was already free — allocator misuse."""


class OutOfRegions(RuntimeError):
    """Allocation failed because the free list is EXHAUSTED — there are
    fewer free slots than the request needs — as opposed to a transient
    contention loss (which retries, or surfaces as a ``None`` grant).

    The sharded service layer relies on this distinction: an exhausted
    shard is FULL (reject / grow / re-route), a contended shard just
    retries next round.  ``requests`` holds the indices of the
    unservable requests; ``grants`` holds whatever the same ``alloc``
    call already claimed for other requests — the caller owns those
    slots and must ``free`` them if it no longer wants them.
    """

    def __init__(self, msg: str, requests: Sequence[int] = (),
                 grants: Optional[List[Optional[List[int]]]] = None):
        super().__init__(msg)
        self.requests = tuple(requests)
        self.grants = grants


class FreeListAllocator:
    def __init__(self, n_slots: int, *, region_base: int = 0,
                 region_words: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.region_base = region_base
        self.region_words = region_words
        self.device = resolve_device(device)
        self._mask = torch.ones(n_slots, dtype=torch.int32,
                                device=self.device)

    # -- views -----------------------------------------------------------------
    def mask(self) -> np.ndarray:
        return tensor_to_words(self._mask)

    @property
    def n_free(self) -> int:
        return int(self.mask().sum())

    def region(self, slot: int) -> int:
        """First word of the region owned by ``slot``."""
        if not self.region_words:
            raise ValueError("allocator built without region mapping")
        return self.region_base + slot * self.region_words

    # -- allocation ------------------------------------------------------------
    def reserve(self, candidates: Sequence[Sequence[int]]) -> List[bool]:
        """Raw path: request i atomically claims exactly its candidate
        slots (all-or-nothing, batch index order).  Exposes the
        contention semantics of ``reserve_slots`` directly."""
        K = max((len(c) for c in candidates), default=0)
        if K == 0:
            return [True] * len(candidates)
        reqs = np.full((len(candidates), K), -1, np.int32)
        for i, c in enumerate(candidates):
            reqs[i, :len(c)] = sorted(c)
        _, granted = reserve_slots(self._mask,
                                   words_to_tensor(reqs, self.device))
        return [bool(g) for g in granted.cpu().numpy()]

    def alloc(self, counts: Sequence[int], max_rounds: int = 4, *,
              on_exhausted: str = "raise") -> List[Optional[List[int]]]:
        """Grant ``counts[i]`` slots to request i.

        Each round partitions the currently-free slots into disjoint
        candidate sets (so a round with enough supply grants everything
        at once); a request denied by contention retries with fresh
        candidates next round.

        Requests that cannot be served because the free list is
        *exhausted* (``count > n_free`` once every servable request got
        its grant) raise :class:`OutOfRegions` — the typed FULL signal
        the service layer distinguishes from conflict.  Pass
        ``on_exhausted="none"`` for the legacy behavior (a ``None``
        grant); a ``None`` under the default mode means the request was
        still losing reservation races after ``max_rounds`` (possible
        only with a concurrent caller mutating the bitmap).
        """
        if on_exhausted not in ("raise", "none"):
            raise ValueError(f"on_exhausted={on_exhausted!r}")
        grants: List[Optional[List[int]]] = [None] * len(counts)
        pending = [i for i, c in enumerate(counts) if c > 0]
        for i, c in enumerate(counts):
            if c == 0:
                grants[i] = []
        for _ in range(max_rounds):
            if not pending:
                break
            free_ids = np.nonzero(self.mask())[0].tolist()
            candidates, owners, cursor = [], [], 0
            for i in pending:
                want = counts[i]
                if cursor + want > len(free_ids):
                    continue               # not enough supply this round
                candidates.append(free_ids[cursor:cursor + want])
                owners.append(i)
                cursor += want
            if not candidates:
                break
            granted = self.reserve(candidates)
            still = [i for i in pending if i not in owners]
            for cand, owner, ok in zip(candidates, owners, granted):
                if ok:
                    grants[owner] = cand
                else:
                    still.append(owner)
            pending = sorted(still)
        exhausted = [i for i in pending if counts[i] > self.n_free]
        if exhausted and on_exhausted == "raise":
            raise OutOfRegions(
                f"free list exhausted: requests {exhausted} need "
                f"{[counts[i] for i in exhausted]} slots but only "
                f"{self.n_free} remain free", requests=exhausted,
                grants=grants)
        return grants

    def free(self, slots: Sequence[int]) -> None:
        """Atomically return a set of slots to the free list (one MwCAS
        flipping every bit 0 -> 1); freeing a free slot is an error."""
        if not slots:
            return
        ids = sorted(set(slots))
        if len(ids) != len(slots):
            raise DoubleFree(f"duplicate slot ids in free(): {slots}")
        addr = np.asarray(ids, np.int32).reshape(1, -1)
        exp = np.zeros_like(addr)                      # expect claimed
        des = np.ones_like(addr)                       # back to free
        # a losing op writes nothing, so the mask is untouched on failure
        _, success = pmwcas_apply(
            self._mask, *(words_to_tensor(a, self.device)
                          for a in (addr, exp, des)))
        if not bool(success.cpu()[0]):
            raise DoubleFree(f"free() of already-free slot among {ids}")
