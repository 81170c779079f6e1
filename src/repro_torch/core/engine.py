"""Micro-op state machines for the four PMwCAS algorithms: the plain
version of the simulator kernel.

Every simulator step executes exactly ONE memory event (load / CAS / store /
persist) of ONE thread, so interleavings are modeled at the same atomicity
granularity the algorithms reason about.  :class:`Machine` steps a state
held in CPU tensors, in place, through numpy views of them; it is what the
CPU tests and ``chip_smoke.py`` hold the Hopper kernel
(``csrc/pmwcas_sim.cu``, a line-by-line translation of this file) against,
and it never runs on the card's path.

Fidelity notes:
- CAS always acquires line ownership (x86 ``lock cmpxchg`` issues an RFO even
  when the comparison fails) -- this is what makes failed-CAS storms expensive
  and is the contention mechanism behind the paper's Fig. 2.
- ``persist`` models ``clflushopt`` (their Cascade Lake Xeon): the line is
  written back AND evicted (ownership cleared).
- Helper threads in the original algorithm pay their install-persist and
  dirty-clear as a fused step (one scheduler slot, both events counted);
  everything else is one event per step.

Arithmetic follows the reference's dtypes: words are uint32 (every shift
and sum masked to 32 bits), ``%`` on thread ids is floor-mod, and a PC an
algorithm never reaches runs that algorithm's first branch (the
reference's switch table sends it to index 0).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import (ALG_ORIGINAL, ALG_OURS, ALG_OURS_DF, ALG_PCAS,
                    C_CAS_OWNED, C_CAS_REMOTE, C_FLUSH,
                    C_LOAD_HIT, C_LOAD_MISS, C_LOCAL, C_STORE_OWNED,
                    C_STORE_REMOTE, C_WAIT, CNT_CAS, CNT_CYCLES, CNT_FAILS,
                    CNT_FLUSH, CNT_HELPS, CNT_INVAL, CNT_LOAD, CNT_OPS,
                    CNT_STORE, DES_INCREMENT, FIELDS, PC, ST_COMPLETED,
                    ST_FAILED, ST_SUCCEEDED, ST_UNDECIDED, SimConfig,
                    TAG_DESC, TAG_DESC_DIRTY, TAG_DIRTY, TAG_RDCSS,
                    TAG_SHIFT, U32_FIELDS, start_pc)

M32 = 0xFFFFFFFF
_MASK = 0b111
_PAYLOAD = 0xFFFFFFFF & ~_MASK
_DIRTY, _DESC, _DESC_DIRTY, _RDCSS = (int(TAG_DIRTY), int(TAG_DESC),
                                      int(TAG_DESC_DIRTY), int(TAG_RDCSS))
_DES_INC = int(DES_INCREMENT)

# Which PCs each algorithm can actually reach; the first is where any
# other PC goes (the reference's remap table sends it to branch 0).
ALG_PCS = {
    ALG_OURS: (PC.READ_TGT, PC.READ_WAIT, PC.INIT_DESC, PC.PERSIST_DESC,
               PC.RESERVE_TEST, PC.RESERVE_WAIT, PC.RESERVE_CAS,
               PC.PERSIST_TGT, PC.SET_SUCC, PC.PERSIST_STATE, PC.FIN_STORE,
               PC.FIN_PERSIST, PC.OP_DONE),
    ALG_OURS_DF: (PC.READ_TGT, PC.READ_WAIT, PC.INIT_DESC, PC.PERSIST_DESC,
                  PC.RESERVE_TEST, PC.RESERVE_WAIT, PC.RESERVE_CAS,
                  PC.PERSIST_TGT, PC.SET_SUCC, PC.PERSIST_STATE,
                  PC.FIN_STORE_DIRTY, PC.FIN_PERSIST_DIRTY, PC.FIN_STORE,
                  PC.FIN_PERSIST, PC.OP_DONE),
    ALG_ORIGINAL: (PC.READ_TGT, PC.INIT_DESC, PC.PERSIST_DESC,
                   PC.O_RDCSS_CAS, PC.O_PROMOTE_CAS, PC.O_PERSIST_TGT,
                   PC.O_CLEAR_TGT, PC.O_STATUS_CAS, PC.O_STATUS_PERSIST,
                   PC.O_STATUS_CLEAR, PC.O_FIN_CAS, PC.O_FIN_PERSIST,
                   PC.O_FIN_CLEAR, PC.OP_DONE, PC.H_TEST, PC.H_CAS,
                   PC.H_STATUS_CAS, PC.H_FIN_CAS, PC.H_FIN_PERSIST,
                   PC.H_FIN_CLEAR),
    ALG_PCAS: (PC.P_READ, PC.READ_WAIT, PC.P_CAS, PC.P_PERSIST, PC.P_CLEAR,
               PC.OP_DONE),
}


def pc_remap(algorithm: str) -> tuple:
    """The PC each of the ``PC.COUNT`` values runs as under ``algorithm``:
    itself where the algorithm reaches it, else the algorithm's first
    branch."""
    pcs = ALG_PCS[algorithm]
    return tuple(pc if pc in pcs else pcs[0] for pc in range(PC.COUNT))


def host_views(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """numpy views (no copies) of a state's CPU tensors; uint32 fields are
    viewed as uint32."""
    out = {}
    for name in FIELDS:
        t = st[name]
        if t.device.type != "cpu":
            raise ValueError(f"the plain simulator steps CPU tensors; "
                             f"{name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"state field {name} must be contiguous")
        a = t.numpy()
        out[name] = a.view(np.uint32) if name in U32_FIELDS else a
    return out


class Machine:
    """The four algorithms' micro-op machines over one state (numpy views
    of CPU tensors, updated in place)."""

    def __init__(self, cfg: SimConfig, v: Dict[str, np.ndarray]):
        cfg.validate()
        self.T, self.k = cfg.n_threads, cfg.k
        self.wpl = cfg.words_per_line
        self.nwl, self.dl = cfg.n_word_lines, cfg.desc_lines
        self.max_ops = cfg.max_ops
        self.binit, self.bcap = cfg.backoff_init, cfg.backoff_cap
        self.c = [int(x) for x in cfg.cost.as_array()]
        self.start = start_pc(cfg.algorithm)
        self.df = cfg.algorithm == ALG_OURS_DF
        self.orig = cfg.algorithm == ALG_ORIGINAL
        for name in FIELDS:
            setattr(self, name, v[name])
        self.cnt = v["counters"]
        self.lo = v["line_owner"]
        remap = pc_remap(cfg.algorithm)
        table = {
            PC.READ_TGT: self.br_read_tgt, PC.READ_WAIT: self.br_read_wait,
            PC.INIT_DESC: self.br_init_desc,
            PC.PERSIST_DESC: self.br_persist_desc,
            PC.RESERVE_TEST: self.br_reserve_test,
            PC.RESERVE_WAIT: self.br_read_wait,     # shared wait body
            PC.RESERVE_CAS: self.br_reserve_cas,
            PC.PERSIST_TGT: self.br_persist_tgt,
            PC.SET_SUCC: self.br_set_succ,
            PC.PERSIST_STATE: self.br_persist_state,
            PC.FIN_STORE_DIRTY: self.br_fin_store_dirty,
            PC.FIN_PERSIST_DIRTY: self.br_fin_persist_dirty,
            PC.FIN_STORE: self.br_fin_store,
            PC.FIN_PERSIST: self.br_fin_persist,
            PC.OP_DONE: self.br_op_done,
            PC.O_RDCSS_CAS: self.br_o_rdcss_cas,
            PC.O_PROMOTE_CAS: self.br_o_promote_cas,
            PC.O_PERSIST_TGT: self.br_o_persist_tgt,
            PC.O_CLEAR_TGT: self.br_o_clear_tgt,
            PC.O_STATUS_CAS: self.br_o_status_cas,
            PC.O_STATUS_PERSIST: self.br_o_status_persist,
            PC.O_STATUS_CLEAR: self.br_o_status_clear,
            PC.O_FIN_CAS: self.br_o_fin_cas,
            PC.O_FIN_PERSIST: self.br_o_fin_persist,
            PC.O_FIN_CLEAR: self.br_o_fin_clear,
            PC.H_TEST: self.br_h_test, PC.H_CAS: self.br_h_cas,
            PC.H_STATUS_CAS: self.br_h_status_cas,
            PC.H_FIN_CAS: self.br_h_fin_cas,
            PC.H_FIN_PERSIST: self.br_h_fin_persist,
            PC.H_FIN_CLEAR: self.br_h_fin_clear,
            PC.P_READ: self.br_p_read, PC.P_CAS: self.br_p_cas,
            PC.P_PERSIST: self.br_p_persist, PC.P_CLEAR: self.br_p_clear,
        }
        self._branch = [table[remap[pc]] for pc in range(PC.COUNT)]

    # -- dispatch ---------------------------------------------------------------
    def step(self, tid: int) -> None:
        """Execute one micro-op of thread ``tid``."""
        pc = int(self.pc[tid])
        if pc < 0:                       # the reference's gather: a
            pc += PC.COUNT               # negative index wraps once,
        pc = min(max(pc, 0), PC.COUNT - 1)   # then clamps
        self._branch[pc](tid)

    def clean(self, t: int) -> bool:
        """No in-flight memory side effects: at an op boundary, or waiting
        to start one (``sim._clean_mask``)."""
        pc = int(self.pc[t])
        return pc == self.start or (pc == PC.READ_WAIT
                                    and int(self.ret_pc[t]) == self.start)

    # -- small state utilities --------------------------------------------------
    def cost(self, t, cycles):
        self.cnt[t, CNT_CYCLES] += cycles

    def op_addr(self, t, j):
        """Target ``j`` of the thread's current operation (ops wrap)."""
        return int(self.ops[t, int(self.op_idx[t]) % self.max_ops, j])

    def desc_ptr(self, t):
        """The tagged-word payload naming this thread's live descriptor
        (uint32 arithmetic)."""
        return (int(self.d_ver[t]) * self.T + t) & M32

    def desc_tid(self, val):
        return int(val) % self.T          # floor-mod, as jnp's %

    def line_of(self, addr):
        return addr // self.wpl           # floor division, as jnp's //

    def desc_line(self, dt):
        return self.nwl + dt * self.dl

    # -- memory events ----------------------------------------------------------
    def ev_load(self, t, line):
        owned = int(self.lo[line]) == t
        self.cnt[t, CNT_LOAD] += 1
        self.cost(t, self.c[C_LOAD_HIT] if owned else self.c[C_LOAD_MISS])

    def take_line(self, t, line):
        """Write-side ownership transfer; returns whether the line was
        already ours.  An invalidation counts only a line stolen from
        another thread's cache."""
        owner = int(self.lo[line])
        if owner != t and owner >= 0:
            self.cnt[t, CNT_INVAL] += 1
        self.lo[line] = t
        return owner == t

    @staticmethod
    def is_ref(word):
        tag = word & _MASK
        return tag == _DESC or tag == _DESC_DIRTY or tag == _RDCSS

    def ref_update(self, field, old, new):
        """Outstanding descriptor references per owner thread, in cache
        (``ref_cache``) and pmem (``ref_pmem``): the ORIGINAL machine's
        reuse barrier, and the paper's claim that its own algorithms hold
        none at an op boundary."""
        if self.is_ref(old):
            field[(old >> TAG_SHIFT) % self.T] -= 1
        if self.is_ref(new):
            field[(new >> TAG_SHIFT) % self.T] += 1

    def ev_cas_word(self, t, addr, expected, desired):
        """CAS on a data word; returns success.  Always acquires the line."""
        line = self.line_of(addr)
        cur = int(self.cache[addr])
        ok = cur == expected
        new = desired if ok else cur
        self.ref_update(self.ref_cache, cur, new)
        self.cache[addr] = new
        owned = self.take_line(t, line)
        self.cnt[t, CNT_CAS] += 1
        self.cost(t, self.c[C_CAS_OWNED] if owned else self.c[C_CAS_REMOTE])
        return ok

    def ev_store_word(self, t, addr, value, cas_class=False):
        """Plain store to a data word (atomic 8-byte store on x86)."""
        line = self.line_of(addr)
        self.ref_update(self.ref_cache, int(self.cache[addr]), value)
        self.cache[addr] = value
        owned = self.take_line(t, line)
        self.cnt[t, CNT_CAS if cas_class else CNT_STORE] += 1
        self.cost(t, self.c[C_STORE_OWNED] if owned
                  else self.c[C_STORE_REMOTE])

    def ev_persist_word(self, t, addr):
        """clflushopt: write back cache->pmem and evict the line."""
        line = self.line_of(addr)
        word = int(self.cache[addr])
        self.ref_update(self.ref_pmem, int(self.pmem[addr]), word)
        self.pmem[addr] = word
        self.lo[line] = -1
        self.cnt[t, CNT_FLUSH] += 1
        self.cost(t, self.c[C_FLUSH])

    def ev_persist_desc(self, t, dt):
        """Persist thread dt's whole descriptor (state+ver+targets)."""
        self.d_state_p[dt] = self.d_state[dt]
        self.d_ver_p[dt] = self.d_ver[dt]
        self.d_addr_p[dt] = self.d_addr[dt]
        self.d_exp_p[dt] = self.d_exp[dt]
        self.d_des_p[dt] = self.d_des[dt]
        self.lo[self.desc_line(dt)] = -1
        self.cnt[t, CNT_FLUSH] += self.dl
        self.cost(t, self.c[C_FLUSH] * self.dl)

    def ev_persist_desc_state(self, t, dt):
        """Persist only the state word of dt's descriptor (one line)."""
        self.d_state_p[dt] = self.d_state[dt]
        self.d_ver_p[dt] = self.d_ver[dt]
        self.lo[self.desc_line(dt)] = -1
        self.cnt[t, CNT_FLUSH] += 1
        self.cost(t, self.c[C_FLUSH])

    def ev_desc_store(self, t, dt, cas_class=False):
        """Cost/ownership accounting for a write to dt's descriptor line."""
        owned = self.take_line(t, self.desc_line(dt))
        self.cnt[t, CNT_CAS if cas_class else CNT_STORE] += 1
        if cas_class:
            self.cost(t, self.c[C_CAS_OWNED] if owned
                      else self.c[C_CAS_REMOTE])
        else:
            self.cost(t, self.c[C_STORE_OWNED] if owned
                      else self.c[C_STORE_REMOTE])

    def ev_desc_load(self, t, dt):
        self.ev_load(t, self.desc_line(dt))

    # -- shared helpers for branch bodies ---------------------------------------
    def enter_wait(self, t, ret_pc):
        """Exponential back-off (paper Sec. 3 implementation details)."""
        be = int(self.backoff_exp[t])
        self.backoff[t] = be
        self.backoff_exp[t] = min(be * 2, self.bcap)
        self.ret_pc[t] = ret_pc
        self.pc[t] = PC.READ_WAIT

    def advance(self, t, field, j, last_pc, next_pc):
        """Target ``j`` done: the next one, or ``last_pc`` after the k-th."""
        done = j + 1 >= self.k
        field[t] = 0 if done else j + 1
        self.pc[t] = last_pc if done else next_pc

    def final_word(self, t, j):
        """Fig. 4 line 19: desired on success, expected on abort."""
        return int(self.d_des[t, j] if self.success[t] else self.d_exp[t, j])

    def holds_my_desc(self, t, word):
        tag = word & _MASK
        return ((tag == _DESC or tag == _DESC_DIRTY)
                and (word >> TAG_SHIFT) == self.desc_ptr(t))

    def first_fin(self):
        return PC.FIN_STORE_DIRTY if self.df else PC.FIN_STORE

    # ===========================================================================
    # Branches shared by OURS / OURS_DF (paper Fig. 4) and partially ORIGINAL
    # ===========================================================================
    def br_read_tgt(self, t):
        """Benchmark front-end: read current value of target tgt_idx (Fig. 5)."""
        j = int(self.tgt_idx[t])
        addr = self.op_addr(t, j)
        self.ev_load(t, self.line_of(addr))
        word = int(self.cache[addr])
        tag = word & _MASK
        if tag != 0:
            if not self.orig:
                self.enter_wait(t, PC.READ_TGT)
            elif tag == _DIRTY:
                # Wang et al.: readers flush dirty words, then clear the flag
                self.ev_persist_word(t, addr)
                self.ev_store_word(t, addr, word & _PAYLOAD)
            else:                        # the original algorithm HELPS
                self.cnt[t, CNT_HELPS] += 1
                self.help_desc[t] = word >> TAG_SHIFT
                self.help_tgt[t] = 0
                self.help_ok[t] = True
                self.ret_pc[t] = PC.READ_TGT
                self.pc[t] = PC.H_TEST
            return
        self.exp[t, j] = word >> TAG_SHIFT
        self.backoff_exp[t] = self.binit
        self.advance(t, self.tgt_idx, j, PC.INIT_DESC, PC.READ_TGT)

    def br_read_wait(self, t):
        b = int(self.backoff[t])
        self.cost(t, self.c[C_WAIT])
        self.backoff[t] = b - 1
        if b - 1 <= 0:
            self.pc[t] = self.ret_pc[t]

    def br_init_desc(self, t):
        """Fig. 4 line 1 + filling target info (state Failed acts as the WAL)."""
        idx = int(self.op_idx[t]) % self.max_ops
        self.d_state[t] = ST_UNDECIDED if self.orig else ST_FAILED
        self.d_state_dirty[t] = 0
        for j in range(self.k):
            e = int(self.exp[t, j])
            d = int(self.ops_des[t, idx, j])
            if d == _DES_INC:
                d = (e + 1) & M32
            self.d_addr[t, j] = self.ops[t, idx, j]
            self.d_exp[t, j] = (e << TAG_SHIFT) & M32
            self.d_des[t, j] = (d << TAG_SHIFT) & M32
        self.success[t] = True
        self.ev_desc_store(t, t)
        self.tgt_idx[t] = 0
        self.pc[t] = PC.PERSIST_DESC

    def br_persist_desc(self, t):
        """Fig. 4 line 2: the descriptor IS the write-ahead log."""
        self.ev_persist_desc(t, t)
        self.pc[t] = PC.O_RDCSS_CAS if self.orig else PC.RESERVE_TEST

    def br_reserve_test(self, t):
        """TTAS pre-check before the reserve CAS (ours / ours_df)."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        self.ev_load(t, self.line_of(addr))
        word = int(self.cache[addr])
        if word & _MASK:         # another PMwCAS in flight (or dirty): wait
            self.enter_wait(t, PC.RESERVE_TEST)
        elif word == int(self.d_exp[t, j]):
            self.pc[t] = PC.RESERVE_CAS
        else:                    # Fig. 4 lines 8-10: failed, go abort
            self.success[t] = False
            self.tgt_idx[t] = 0
            self.pc[t] = self.first_fin()

    def br_reserve_cas(self, t):
        """Fig. 4 line 6: embed the descriptor address."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        desc_word = ((self.desc_ptr(t) << TAG_SHIFT) & M32) | _DESC
        if self.ev_cas_word(t, addr, int(self.d_exp[t, j]), desc_word):
            self.backoff_exp[t] = self.binit
            self.advance(t, self.tgt_idx, j, PC.PERSIST_TGT, PC.RESERVE_TEST)
        else:    # re-test: the word may now hold a descriptor or another value
            self.pc[t] = PC.RESERVE_TEST

    def br_persist_tgt(self, t):
        """Fig. 4 lines 12-13: persist every embedded descriptor address."""
        j = int(self.tgt_idx[t])
        self.ev_persist_word(t, int(self.d_addr[t, j]))
        self.advance(t, self.tgt_idx, j, PC.SET_SUCC, PC.PERSIST_TGT)

    def br_set_succ(self, t):
        self.d_state[t] = ST_SUCCEEDED
        self.ev_desc_store(t, t)
        self.pc[t] = PC.PERSIST_STATE

    def br_persist_state(self, t):
        """Fig. 4 line 15 -- the durability linearization point."""
        self.ev_persist_desc_state(t, t)
        self.tgt_idx[t] = 0
        self.pc[t] = self.first_fin()

    def br_fin_store_dirty(self, t):
        """Fig. 4 lines 17-21 (ours_df): store final value WITH the dirty flag."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        if self.holds_my_desc(t, int(self.cache[addr])):
            self.ev_store_word(t, addr, self.final_word(t, j) | _DIRTY,
                               cas_class=True)
            self.pc[t] = PC.FIN_PERSIST_DIRTY
        else:    # line 18: first non-reserved target ends the abort sweep
            self.pc[t] = PC.OP_DONE

    def br_fin_persist_dirty(self, t):
        j = int(self.tgt_idx[t])
        self.ev_persist_word(t, int(self.d_addr[t, j]))
        self.pc[t] = PC.FIN_STORE

    def br_fin_store(self, t):
        """Fig. 4 line 23: store the clean final value (in ours also the
        abort sweep's check for the first non-reserved target)."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        word = int(self.cache[addr])
        clean = self.final_word(t, j)
        if self.df:          # arrived via the dirty path
            self.ev_store_word(t, addr, clean, cas_class=False)
            self.pc[t] = PC.FIN_PERSIST
        elif self.holds_my_desc(t, word):
            self.ev_store_word(t, addr, clean, cas_class=True)
            self.pc[t] = PC.FIN_PERSIST
        else:
            self.pc[t] = PC.OP_DONE

    def br_fin_persist(self, t):
        """Fig. 4 line 24."""
        j = int(self.tgt_idx[t])
        self.ev_persist_word(t, int(self.d_addr[t, j]))
        self.advance(t, self.tgt_idx, j, PC.OP_DONE, self.first_fin())

    def br_op_done(self, t):
        """Fig. 4 line 25 + benchmark bookkeeping (retry failed ops)."""
        if self.orig:
            # Epoch-GC stand-in: the original algorithm may not recycle a
            # descriptor while helpers/words still reference it.
            if int(self.ref_cache[t]) + int(self.ref_pmem[t]) > 0:
                self.cost(t, self.c[C_WAIT])
                return
            # the descriptor status word is the authoritative outcome
            ok = int(self.d_state[t]) == ST_SUCCEEDED
        else:
            ok = bool(self.success[t])
        self.d_state[t] = ST_COMPLETED
        self.cost(t, self.c[C_LOCAL])
        self.cnt[t, CNT_OPS if ok else CNT_FAILS] += 1
        self.op_idx[t] += int(ok)
        self.d_ver[t] += 1       # stale pointers become detectable
        self.tgt_idx[t] = 0
        self.pc[t] = self.start

    # ===========================================================================
    # ORIGINAL (Wang et al. ICDE'18): RDCSS install + dirty flags + helping
    # ===========================================================================
    def enter_help(self, t, word, ret_pc):
        self.cnt[t, CNT_HELPS] += 1
        self.help_desc[t] = word >> TAG_SHIFT
        self.help_tgt[t] = 0
        self.help_ok[t] = True
        self.ret_pc[t] = ret_pc
        self.pc[t] = PC.H_TEST

    def br_o_rdcss_cas(self, t):
        """Install phase, CAS #1: place the RDCSS intermediate descriptor."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        self.ev_load(t, self.line_of(addr))
        word = int(self.cache[addr])
        tag = word & _MASK
        if self.holds_my_desc(t, word):  # a helper already installed it
            self.advance(t, self.tgt_idx, j, PC.O_STATUS_CAS, PC.O_RDCSS_CAS)
        elif tag == _DIRTY:              # flush + clear, then retry
            self.ev_persist_word(t, addr)
            self.ev_store_word(t, addr, word & _PAYLOAD)
        elif tag in (_DESC, _DESC_DIRTY, _RDCSS):    # help, then retry
            self.enter_help(t, word, PC.O_RDCSS_CAS)
        elif word == int(self.d_exp[t, j]):
            rdcss = ((self.desc_ptr(t) << TAG_SHIFT) & M32) | _RDCSS
            if self.ev_cas_word(t, addr, word, rdcss):
                self.pc[t] = PC.O_PROMOTE_CAS    # else retry the load
        else:                    # unexpected value -> whole MwCAS fails
            self.success[t] = False
            self.pc[t] = PC.O_STATUS_CAS

    def br_o_promote_cas(self, t):
        """Install phase, CAS #2: RDCSS -> MwCAS descriptor (dirty)."""
        j = int(self.tgt_idx[t])
        ptr = (self.desc_ptr(t) << TAG_SHIFT) & M32
        # promotion can only fail if a helper already promoted it; either
        # way the word now holds our descriptor and must be persisted
        self.ev_cas_word(t, int(self.d_addr[t, j]), ptr | _RDCSS,
                         ptr | _DESC_DIRTY)
        self.pc[t] = PC.O_PERSIST_TGT

    def br_o_persist_tgt(self, t):
        j = int(self.tgt_idx[t])
        self.ev_persist_word(t, int(self.d_addr[t, j]))
        self.pc[t] = PC.O_CLEAR_TGT

    def br_o_clear_tgt(self, t):
        """Clear the dirty bit on the installed descriptor word, then flush
        again (Wang et al.'s double flush; one fused step)."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        word = int(self.cache[addr])
        if self.holds_my_desc(t, word):
            self.ev_store_word(t, addr, (word & _PAYLOAD) | _DESC,
                               cas_class=True)
            self.ev_persist_word(t, addr)
        else:
            self.cost(t, self.c[C_LOCAL])
        self.advance(t, self.tgt_idx, j, PC.O_STATUS_CAS, PC.O_RDCSS_CAS)

    def br_o_status_cas(self, t):
        """CAS the status word Undecided -> Succeeded/Failed, with dirty bit."""
        if int(self.d_state[t]) == ST_UNDECIDED:
            self.d_state[t] = ST_SUCCEEDED if self.success[t] else ST_FAILED
        self.d_state_dirty[t] = 1
        self.ev_desc_store(t, t, cas_class=True)
        self.pc[t] = PC.O_STATUS_PERSIST

    def br_o_status_persist(self, t):
        self.ev_persist_desc_state(t, t)
        self.pc[t] = PC.O_STATUS_CLEAR

    def br_o_status_clear(self, t):
        self.d_state_dirty[t] = 0
        self.ev_desc_store(t, t)
        # Wang: the cleared status is flushed again (double flush)
        self.ev_persist_desc_state(t, t)
        self.tgt_idx[t] = 0
        self.pc[t] = PC.O_FIN_CAS

    def br_o_fin_cas(self, t):
        """Finalize phase, CAS #4: descriptor -> final value (dirty)."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        word = int(self.cache[addr])
        if self.holds_my_desc(t, word):
            final = int(self.d_des[t, j] if int(self.d_state[t]) ==
                        ST_SUCCEEDED else self.d_exp[t, j])
            if self.ev_cas_word(t, addr, word, final | _DIRTY):
                self.pc[t] = PC.O_FIN_PERSIST
                return
        # already finalized (possibly by a helper) or never installed
        self.ev_load(t, self.line_of(addr))
        self.advance(t, self.tgt_idx, j, PC.OP_DONE, PC.O_FIN_CAS)

    def br_o_fin_persist(self, t):
        j = int(self.tgt_idx[t])
        self.ev_persist_word(t, int(self.d_addr[t, j]))
        self.pc[t] = PC.O_FIN_CLEAR

    def br_o_fin_clear(self, t):
        """Clear + re-flush the finalized value (Wang's double flush)."""
        j = int(self.tgt_idx[t])
        addr = int(self.d_addr[t, j])
        word = int(self.cache[addr])
        if word & _MASK == _DIRTY:
            self.ev_store_word(t, addr, word & _PAYLOAD)
            self.ev_persist_word(t, addr)
        else:
            self.cost(t, self.c[C_LOCAL])
        self.advance(t, self.tgt_idx, j, PC.OP_DONE, PC.O_FIN_CAS)

    # --------------------------- helping machinery -----------------------------
    def help_valid(self, t):
        """ABA guard: is the helped descriptor still the generation we saw?"""
        h = int(self.help_desc[t])
        dt = self.desc_tid(h)
        return ((int(self.d_ver[dt]) * self.T + dt) & M32) == (h & M32)

    def abandon(self, t):
        self.help_desc[t] = -1
        self.pc[t] = self.ret_pc[t]

    def br_h_test(self, t):
        """Helper install loop over the helped descriptor's targets."""
        h = int(self.help_desc[t])
        dt = self.desc_tid(h)
        self.ev_desc_load(t, dt)
        if not self.help_valid(t):
            self.abandon(t)
        elif int(self.d_state[dt]) != ST_UNDECIDED:
            self.help_tgt[t] = 0
            self.pc[t] = PC.H_FIN_CAS
        elif int(self.help_tgt[t]) >= self.k:
            self.pc[t] = PC.H_STATUS_CAS
        else:
            j = int(self.help_tgt[t])
            addr = int(self.d_addr[dt, j])
            self.ev_load(t, self.line_of(addr))
            word = int(self.cache[addr])
            tag = word & _MASK
            mine = (word >> TAG_SHIFT) == (h & M32)
            # ONLY a (possibly dirty) MwCAS descriptor counts as installed;
            # an RDCSS intermediate must still be PROMOTED first
            if mine and (tag == _DESC or tag == _DESC_DIRTY):
                self.help_tgt[t] = j + 1         # stay in H_TEST
            elif (mine and tag == _RDCSS) or word == int(self.d_exp[dt, j]):
                self.pc[t] = PC.H_CAS
            else:   # value mismatch or a third descriptor: drive to Failed
                self.help_ok[t] = False
                self.pc[t] = PC.H_STATUS_CAS

    def br_h_cas(self, t):
        """Helper CAS-install (+fused persist & dirty-clear)."""
        if not self.help_valid(t):
            self.abandon(t)
            return
        h = int(self.help_desc[t])
        dt = self.desc_tid(h)
        j = int(self.help_tgt[t])
        addr = int(self.d_addr[dt, j])
        word = int(self.cache[addr])
        hp = ((h & M32) << TAG_SHIFT) & M32
        # install from the expected value OR promote our own RDCSS
        d_exp = int(self.d_exp[dt, j])
        eligible = word == d_exp or word == hp | _RDCSS
        ok = self.ev_cas_word(t, addr, word if eligible else d_exp,
                              hp | _DESC_DIRTY) and eligible
        if ok:
            self.ev_persist_word(t, addr)
            self.ev_store_word(t, addr, hp | _DESC)
            self.help_tgt[t] = j + 1
        self.pc[t] = PC.H_TEST

    def br_h_status_cas(self, t):
        """Helper decides the helped op's status (racing the owner)."""
        if not self.help_valid(t):
            self.abandon(t)
            return
        dt = self.desc_tid(int(self.help_desc[t]))
        if int(self.d_state[dt]) == ST_UNDECIDED:
            self.d_state[dt] = (ST_SUCCEEDED if self.help_ok[t]
                                else ST_FAILED)
        self.ev_desc_store(t, dt, cas_class=True)
        # helper persists the (possibly dirty) status before acting on it
        self.ev_persist_desc_state(t, dt)
        self.help_tgt[t] = 0
        self.pc[t] = PC.H_FIN_CAS

    def br_h_fin_cas(self, t):
        if not self.help_valid(t):
            self.abandon(t)
            return
        h = int(self.help_desc[t])
        dt = self.desc_tid(h)
        j = int(self.help_tgt[t])
        if j >= self.k:
            self.abandon(t)               # done: back to the own op
            return
        addr = int(self.d_addr[dt, j])
        word = int(self.cache[addr])
        tag = word & _MASK
        if (word >> TAG_SHIFT) == (h & M32) and (tag == _DESC
                                                 or tag == _DESC_DIRTY):
            final = int(self.d_des[dt, j] if int(self.d_state[dt]) ==
                        ST_SUCCEEDED else self.d_exp[dt, j])
            if self.ev_cas_word(t, addr, word, final | _DIRTY):
                self.pc[t] = PC.H_FIN_PERSIST
            else:
                self.help_tgt[t] = j + 1
        else:
            self.ev_load(t, self.line_of(addr))
            self.help_tgt[t] = j + 1

    def br_h_fin_persist(self, t):
        dt = self.desc_tid(int(self.help_desc[t]))
        j = int(self.help_tgt[t])
        self.ev_persist_word(t, int(self.d_addr[dt, j]))
        self.pc[t] = PC.H_FIN_CLEAR

    def br_h_fin_clear(self, t):
        dt = self.desc_tid(int(self.help_desc[t]))
        j = int(self.help_tgt[t])
        addr = int(self.d_addr[dt, j])
        word = int(self.cache[addr])
        if word & _MASK == _DIRTY:
            self.ev_store_word(t, addr, word & _PAYLOAD)
        else:
            self.cost(t, self.c[C_LOCAL])
        self.help_tgt[t] = j + 1
        self.pc[t] = PC.H_FIN_CAS

    # ===========================================================================
    # PCAS (Wang et al.'s persistent single-word CAS, with TTAS + back-off)
    # ===========================================================================
    def br_p_read(self, t):
        addr = self.op_addr(t, 0)
        self.ev_load(t, self.line_of(addr))
        word = int(self.cache[addr])
        if word & _MASK:
            self.enter_wait(t, PC.P_READ)
        else:
            self.exp[t, 0] = word >> TAG_SHIFT
            self.backoff_exp[t] = self.binit
            self.pc[t] = PC.P_CAS

    def br_p_cas(self, t):
        addr = self.op_addr(t, 0)
        v = int(self.exp[t, 0])
        ok = self.ev_cas_word(t, addr, (v << TAG_SHIFT) & M32,
                              (((v + 1) << TAG_SHIFT) & M32) | _DIRTY)
        if not ok:
            self.cnt[t, CNT_FAILS] += 1
        self.pc[t] = PC.P_PERSIST if ok else PC.P_READ

    def br_p_persist(self, t):
        self.ev_persist_word(t, self.op_addr(t, 0))
        self.pc[t] = PC.P_CLEAR

    def br_p_clear(self, t):
        addr = self.op_addr(t, 0)
        clean = ((int(self.exp[t, 0]) + 1) << TAG_SHIFT) & M32
        self.ev_store_word(t, addr, clean, cas_class=True)
        self.success[t] = True
        self.pc[t] = PC.OP_DONE


def step(cfg: SimConfig, st: Dict[str, torch.Tensor], tid: int
         ) -> Dict[str, torch.Tensor]:
    """Execute one micro-op of thread ``tid`` on a state of CPU tensors,
    in place; returns ``st``."""
    Machine(cfg, host_views(st)).step(int(tid))
    return st

