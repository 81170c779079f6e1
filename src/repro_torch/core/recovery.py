"""Crash recovery (paper Sec. 3/4 consistency arguments, Figs. 6/7).

A crash discards all CPU caches and every thread register; what survives is
``pmem`` plus the *persisted* descriptor table (``d_*_p`` fields).  Recovery
rolls every descriptor-referencing word forward (state Succeeded) or back
(Failed / Undecided) using only that persisted information, and clears dirty
flags — exactly the procedure the paper's state machines justify.

``committed_histogram`` computes, from the pre-crash simulator state, the set
of operations whose effects MUST survive (their Succeeded state reached
pmem — the durability linearization point, Fig. 4 line 15).  The central
crash-consistency property tested is::

    recovered_value(w) == initial(w) + #committed ops covering w

Host code over a state's numpy arrays (a ``SimResult.state``); a state
of tensors is copied to the host first.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .model import (ALG_PCAS, PC, ST_SUCCEEDED, SimConfig, TAG_DESC,
                    TAG_DESC_DIRTY, TAG_DIRTY, TAG_MASK, TAG_RDCSS, TAG_SHIFT,
                    state_to_arrays)

_REF_TAGS = (int(TAG_DESC), int(TAG_DESC_DIRTY), int(TAG_RDCSS))


class RecoveryError(AssertionError):
    """A pmem state recovery cannot explain — must never happen."""


def _host(st: Mapping[str, Any]) -> Mapping[str, Any]:
    if any(isinstance(v, torch.Tensor) for v in st.values()):
        return state_to_arrays(st)
    return st


def recover(cfg: SimConfig, st: Dict[str, Any]) -> np.ndarray:
    """Return the recovered (consistent, payload-only) pmem word array."""
    st = _host(st)
    pmem = np.asarray(st["pmem"]).astype(np.uint32)
    tags = pmem & int(TAG_MASK)
    vals = pmem >> TAG_SHIFT

    # 1. dirty payloads: the value is present; clear the flag (Tables 3/4).
    dirty = tags == int(TAG_DIRTY)
    pmem[dirty] = (vals[dirty] << TAG_SHIFT).astype(pmem.dtype)

    # 2. descriptor references: roll forward/back from the persisted WAL.
    d_state_p = np.asarray(st["d_state_p"])
    d_ver_p = np.asarray(st["d_ver_p"])
    d_addr_p = np.asarray(st["d_addr_p"])
    d_exp_p = np.asarray(st["d_exp_p"])
    d_des_p = np.asarray(st["d_des_p"])
    T = cfg.n_threads

    ref_addrs = np.nonzero(np.isin(tags, _REF_TAGS))[0]
    for addr in ref_addrs:
        ptr = int(vals[addr])
        t = ptr % T
        if d_ver_p[t] * T + t != ptr:
            raise RecoveryError(
                f"word {addr} references descriptor generation {ptr}, but "
                f"thread {t}'s persisted descriptor is generation "
                f"{d_ver_p[t] * T + t} — stale reference escaped to pmem")
        (slots,) = np.nonzero(d_addr_p[t] == addr)
        if len(slots) != 1:
            raise RecoveryError(
                f"word {addr} not among thread {t}'s persisted targets")
        j = int(slots[0])
        if d_state_p[t] == ST_SUCCEEDED:
            pmem[addr] = d_des_p[t, j]   # roll forward
        else:
            pmem[addr] = d_exp_p[t, j]   # roll back (Failed/Undecided)

    # Recovery is idempotent by construction: the result is payload-only.
    if not (pmem & int(TAG_MASK) == 0).all():
        raise RecoveryError("recovered words still carry tags")
    return pmem


def committed_histogram(cfg: SimConfig, st: Dict[str, Any]) -> np.ndarray:
    """Per-word increment counts that MUST survive the crash.

    committed(t) = all fully completed ops (op_idx of them; ops retry until
    success) + the in-flight op iff its Succeeded state was persisted for the
    *current* descriptor generation (for PCAS: iff the dirty value was
    flushed, i.e. the thread passed P_PERSIST).
    """
    st = _host(st)
    ops = np.asarray(st["ops"])
    op_idx = np.asarray(st["op_idx"])
    pc = np.asarray(st["pc"])
    d_state_p = np.asarray(st["d_state_p"])
    d_ver_p = np.asarray(st["d_ver_p"])
    d_ver = np.asarray(st["d_ver"])
    hist = np.zeros(cfg.n_words, dtype=np.int64)
    for t in range(cfg.n_threads):
        n = int(op_idx[t])
        full, part = divmod(n, cfg.max_ops)
        if full:
            np.add.at(hist, ops[t].reshape(-1), full)
        if part:
            np.add.at(hist, ops[t, :part].reshape(-1), 1)
        # in-flight op of thread t
        if cfg.algorithm == ALG_PCAS:
            # committed once the dirty value is flushed (past P_PERSIST);
            # the op is not yet in op_idx until OP_DONE executes
            inflight_committed = int(pc[t]) in (PC.P_CLEAR, PC.OP_DONE)
        else:
            inflight_committed = (int(d_state_p[t]) == ST_SUCCEEDED
                                  and int(d_ver_p[t]) == int(d_ver[t]))
        if inflight_committed:
            cur = ops[t, n % cfg.max_ops]
            np.add.at(hist, cur, 1)
    return hist


def check_crash_consistency(cfg: SimConfig, st: Dict[str, Any]
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Recover and verify the central crash invariant.  Returns (rec, hist)."""
    rec = recover(cfg, st)
    hist = committed_histogram(cfg, st)
    got = (rec >> TAG_SHIFT).astype(np.int64)
    if not np.array_equal(got, hist):
        bad = np.nonzero(got != hist)[0][:10]
        raise RecoveryError(
            f"crash invariant violated at words {bad}: "
            f"recovered={got[bad]} expected={hist[bad]}")
    return rec, hist
