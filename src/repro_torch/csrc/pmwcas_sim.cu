// The cycle-accurate PMwCAS simulator on Hopper (sm_90a): whole schedules
// of micro-ops interpreted on the card, many independent simulations in
// one launch.
//
// Replaces: the reference's jitted lax.scan over engine.step
// (src/repro/core/sim.py:33-42 and _compiled_runner at :175; the step's
// lax.switch on the PC at src/repro/core/engine.py:1025-1031), which has
// no Pallas kernel.  This file is a branch-by-branch translation of the
// port's plain version, repro_torch.core.engine.Machine; the two are held
// equal bit for bit on the whole state (tests/test_torch_cuda.py,
// chip_smoke.py phase 9).
//
// Design.  One warp per simulation (one block of 32 threads), lane 0
// stepping: a simulation is sequential, and simulations sharing a warp
// would diverge on their switch (pc) and run one after another.  Each
// simulation reads a record of R_LEN int64s (its algorithm, geometry,
// back-off, ten costs, mode, schedule, cut, drain flag and caps, then one
// device pointer per state field, in core.model.FIELDS order), so one
// launch mixes algorithms, thread counts, k and word counts.  The state
// stays in the global memory of the caller's tensors and is updated in
// place; moving the registers or the descriptor table into shared memory
// is later work.
//
// Bound: latency.  A step is a short chain of dependent 4-byte loads and
// stores (PC, registers, the op's address, the word, the line's owner)
// with a data-dependent branch between each; nothing hides that chain but
// other simulations on other SMs.
//
// Words are uint32 (shifts and sums wrap); thread ids from words use
// floor-mod; a PC the algorithm never reaches runs the algorithm's first
// branch, as the reference's remap table sends it to index 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// record layout: kernels/pmwcas_sim/kernel.py holds the same numbers
enum : int {
  R_ALG = 0, R_T, R_K, R_NWORDS, R_WPL, R_NWL, R_DL, R_MAXOPS, R_BINIT,
  R_BCAP, R_COST = 10, R_MODE = 20, R_NSCHED, R_CUT, R_DRAIN, R_CAP,
  R_SCHED, R_FIELD
};
enum : int {
  F_CACHE, F_PMEM, F_LINE_OWNER, F_D_STATE, F_D_STATE_P, F_D_STATE_DIRTY,
  F_D_ADDR, F_D_EXP, F_D_DES, F_D_ADDR_P, F_D_EXP_P, F_D_DES_P, F_D_VER,
  F_D_VER_P, F_PC, F_OP_IDX, F_TGT_IDX, F_SUCCESS, F_BACKOFF,
  F_BACKOFF_EXP, F_EXP, F_HELP_DESC, F_HELP_TGT, F_HELP_OK, F_RET_PC,
  F_REF_CACHE, F_REF_PMEM, F_COUNTERS, F_OPS, F_OPS_DES, N_FIELDS
};
constexpr int R_LEN = R_FIELD + N_FIELDS;
constexpr int OUT_LEN = 4;                 // rounds, err, err thread, steps
constexpr int MODE_SCHEDULE = 0, MODE_BACKEND = 1;
constexpr int ERR_READ_PHASE = 1, ERR_ATTEMPT = 2;
// the reference's _drain(max_rounds=); kernel.py's MAX_DRAIN_ROUNDS
constexpr long long kMaxDrainRounds = 100000;

enum : int { ALG_OURS = 0, ALG_OURS_DF = 1, ALG_ORIGINAL = 2, ALG_PCAS = 3 };

enum : int {
  READ_TGT = 0, READ_WAIT, INIT_DESC, PERSIST_DESC, RESERVE_TEST,
  RESERVE_WAIT, RESERVE_CAS, PERSIST_TGT, SET_SUCC, PERSIST_STATE,
  FIN_STORE_DIRTY, FIN_PERSIST_DIRTY, FIN_STORE, FIN_PERSIST, OP_DONE,
  O_RDCSS_CAS, O_PROMOTE_CAS, O_PERSIST_TGT, O_CLEAR_TGT, O_STATUS_CAS,
  O_STATUS_PERSIST, O_STATUS_CLEAR, O_FIN_CAS, O_FIN_PERSIST, O_FIN_CLEAR,
  H_TEST, H_CAS, H_STATUS_CAS, H_FIN_CAS, H_FIN_PERSIST, H_FIN_CLEAR,
  P_READ, P_CAS, P_PERSIST, P_CLEAR, PC_COUNT
};

enum : int {
  CNT_CAS = 0, CNT_FLUSH, CNT_LOAD, CNT_STORE, CNT_INVAL, CNT_OPS,
  CNT_FAILS, CNT_CYCLES, CNT_HELPS, N_COUNTERS
};
enum : int {
  C_LOCAL = 0, C_LOAD_HIT, C_LOAD_MISS, C_CAS_OWNED, C_CAS_REMOTE,
  C_STORE_OWNED, C_STORE_REMOTE, C_FLUSH, C_FLUSH_CLEAN, C_WAIT
};

enum : int { ST_COMPLETED = 0, ST_FAILED, ST_SUCCEEDED, ST_UNDECIDED };

constexpr uint32_t TAG_SHIFT = 3, TAG_MASK = 7u, PAYLOAD = ~7u;
constexpr uint32_t TAG_DIRTY = 1u, TAG_DESC = 2u, TAG_DESC_DIRTY = 3u,
                   TAG_RDCSS = 4u;
constexpr uint32_t DES_INCREMENT = 0xFFFFFFFFu;

constexpr unsigned long long bit(int pc) { return 1ull << pc; }
// the PCs each algorithm reaches (core/engine.py ALG_PCS)
constexpr unsigned long long REACH_OURS =
    bit(READ_TGT) | bit(READ_WAIT) | bit(INIT_DESC) | bit(PERSIST_DESC) |
    bit(RESERVE_TEST) | bit(RESERVE_WAIT) | bit(RESERVE_CAS) |
    bit(PERSIST_TGT) | bit(SET_SUCC) | bit(PERSIST_STATE) | bit(FIN_STORE) |
    bit(FIN_PERSIST) | bit(OP_DONE);
constexpr unsigned long long REACH_OURS_DF =
    REACH_OURS | bit(FIN_STORE_DIRTY) | bit(FIN_PERSIST_DIRTY);
constexpr unsigned long long REACH_ORIGINAL =
    bit(READ_TGT) | bit(INIT_DESC) | bit(PERSIST_DESC) | bit(O_RDCSS_CAS) |
    bit(O_PROMOTE_CAS) | bit(O_PERSIST_TGT) | bit(O_CLEAR_TGT) |
    bit(O_STATUS_CAS) | bit(O_STATUS_PERSIST) | bit(O_STATUS_CLEAR) |
    bit(O_FIN_CAS) | bit(O_FIN_PERSIST) | bit(O_FIN_CLEAR) | bit(OP_DONE) |
    bit(H_TEST) | bit(H_CAS) | bit(H_STATUS_CAS) | bit(H_FIN_CAS) |
    bit(H_FIN_PERSIST) | bit(H_FIN_CLEAR);
constexpr unsigned long long REACH_PCAS =
    bit(P_READ) | bit(READ_WAIT) | bit(P_CAS) | bit(P_PERSIST) |
    bit(P_CLEAR) | bit(OP_DONE);

struct Sim {
  int alg, T, k, wpl, nwl, dl, max_ops, binit, bcap, start, first;
  unsigned long long reach;
  long long c[10];
  uint32_t* cache;
  uint32_t* pmem;
  int32_t* lo;
  int32_t* d_state;
  int32_t* d_state_p;
  int32_t* d_state_dirty;
  int32_t* d_addr;
  uint32_t* d_exp;
  uint32_t* d_des;
  int32_t* d_addr_p;
  uint32_t* d_exp_p;
  uint32_t* d_des_p;
  int32_t* d_ver;
  int32_t* d_ver_p;
  int32_t* pc;
  int32_t* op_idx;
  int32_t* tgt_idx;
  uint8_t* success;
  int32_t* backoff;
  int32_t* backoff_exp;
  uint32_t* exp;
  int32_t* help_desc;
  int32_t* help_tgt;
  uint8_t* help_ok;
  int32_t* ret_pc;
  int32_t* ref_cache;
  int32_t* ref_pmem;
  long long* cnt;
  const int32_t* ops;
  const uint32_t* ops_des;
};

template <typename P>
__device__ __forceinline__ P field(const long long* r, int f) {
  return reinterpret_cast<P>(static_cast<uintptr_t>(r[R_FIELD + f]));
}

__device__ void load_sim(Sim& s, const long long* r) {
  s.alg = static_cast<int>(r[R_ALG]);
  s.T = static_cast<int>(r[R_T]);
  s.k = static_cast<int>(r[R_K]);
  s.wpl = static_cast<int>(r[R_WPL]);
  s.nwl = static_cast<int>(r[R_NWL]);
  s.dl = static_cast<int>(r[R_DL]);
  s.max_ops = static_cast<int>(r[R_MAXOPS]);
  s.binit = static_cast<int>(r[R_BINIT]);
  s.bcap = static_cast<int>(r[R_BCAP]);
  for (int i = 0; i < 10; ++i) s.c[i] = r[R_COST + i];
  s.start = s.alg == ALG_PCAS ? P_READ : READ_TGT;
  s.first = s.start;                // the first branch of every list
  switch (s.alg) {
    case ALG_OURS: s.reach = REACH_OURS; break;
    case ALG_OURS_DF: s.reach = REACH_OURS_DF; break;
    case ALG_ORIGINAL: s.reach = REACH_ORIGINAL; break;
    default: s.reach = REACH_PCAS; break;
  }
  s.cache = field<uint32_t*>(r, F_CACHE);
  s.pmem = field<uint32_t*>(r, F_PMEM);
  s.lo = field<int32_t*>(r, F_LINE_OWNER);
  s.d_state = field<int32_t*>(r, F_D_STATE);
  s.d_state_p = field<int32_t*>(r, F_D_STATE_P);
  s.d_state_dirty = field<int32_t*>(r, F_D_STATE_DIRTY);
  s.d_addr = field<int32_t*>(r, F_D_ADDR);
  s.d_exp = field<uint32_t*>(r, F_D_EXP);
  s.d_des = field<uint32_t*>(r, F_D_DES);
  s.d_addr_p = field<int32_t*>(r, F_D_ADDR_P);
  s.d_exp_p = field<uint32_t*>(r, F_D_EXP_P);
  s.d_des_p = field<uint32_t*>(r, F_D_DES_P);
  s.d_ver = field<int32_t*>(r, F_D_VER);
  s.d_ver_p = field<int32_t*>(r, F_D_VER_P);
  s.pc = field<int32_t*>(r, F_PC);
  s.op_idx = field<int32_t*>(r, F_OP_IDX);
  s.tgt_idx = field<int32_t*>(r, F_TGT_IDX);
  s.success = field<uint8_t*>(r, F_SUCCESS);
  s.backoff = field<int32_t*>(r, F_BACKOFF);
  s.backoff_exp = field<int32_t*>(r, F_BACKOFF_EXP);
  s.exp = field<uint32_t*>(r, F_EXP);
  s.help_desc = field<int32_t*>(r, F_HELP_DESC);
  s.help_tgt = field<int32_t*>(r, F_HELP_TGT);
  s.help_ok = field<uint8_t*>(r, F_HELP_OK);
  s.ret_pc = field<int32_t*>(r, F_RET_PC);
  s.ref_cache = field<int32_t*>(r, F_REF_CACHE);
  s.ref_pmem = field<int32_t*>(r, F_REF_PMEM);
  s.cnt = field<long long*>(r, F_COUNTERS);
  s.ops = field<const int32_t*>(r, F_OPS);
  s.ops_des = field<const uint32_t*>(r, F_OPS_DES);
}

// -- small state utilities ---------------------------------------------------

__device__ __forceinline__ long long& cnt(Sim& s, int t, int c) {
  return s.cnt[static_cast<long long>(t) * N_COUNTERS + c];
}
__device__ __forceinline__ void cost(Sim& s, int t, long long cycles) {
  cnt(s, t, CNT_CYCLES) += cycles;
}
__device__ __forceinline__ int tk(const Sim& s, int t, int j) {
  return t * s.k + j;
}
__device__ __forceinline__ int op_row(const Sim& s, int t) {
  // ops wrap around (op_idx >= 0, so % is the reference's lax.rem)
  return (t * s.max_ops + s.op_idx[t] % s.max_ops) * s.k;
}
__device__ __forceinline__ int op_addr(const Sim& s, int t, int j) {
  return s.ops[op_row(s, t) + j];
}
__device__ __forceinline__ uint32_t desc_ptr(const Sim& s, int t) {
  return static_cast<uint32_t>(s.d_ver[t]) * static_cast<uint32_t>(s.T) +
         static_cast<uint32_t>(t);
}
__device__ __forceinline__ int desc_tid(const Sim& s, int val) {
  const int r = val % s.T;                 // floor-mod, as jnp's %
  return r < 0 ? r + s.T : r;
}
__device__ __forceinline__ int line_of(const Sim& s, int addr) {
  int q = addr / s.wpl;                    // floor division, as jnp's //
  if (addr % s.wpl != 0 && addr < 0) --q;
  return q;
}
__device__ __forceinline__ int desc_line(const Sim& s, int dt) {
  return s.nwl + dt * s.dl;
}

// -- memory events -------------------------------------------------------------

__device__ void ev_load(Sim& s, int t, int line) {
  const bool owned = s.lo[line] == t;
  cnt(s, t, CNT_LOAD) += 1;
  cost(s, t, owned ? s.c[C_LOAD_HIT] : s.c[C_LOAD_MISS]);
}

// write-side ownership transfer; true when the line was already ours
__device__ bool take_line(Sim& s, int t, int line) {
  const int owner = s.lo[line];
  if (owner != t && owner >= 0) cnt(s, t, CNT_INVAL) += 1;
  s.lo[line] = t;
  return owner == t;
}

__device__ __forceinline__ bool is_ref(uint32_t word) {
  const uint32_t tag = word & TAG_MASK;
  return tag == TAG_DESC || tag == TAG_DESC_DIRTY || tag == TAG_RDCSS;
}

__device__ void ref_update(Sim& s, int32_t* field, uint32_t old_w,
                           uint32_t new_w) {
  const uint32_t T = static_cast<uint32_t>(s.T);
  if (is_ref(old_w)) field[(old_w >> TAG_SHIFT) % T] -= 1;
  if (is_ref(new_w)) field[(new_w >> TAG_SHIFT) % T] += 1;
}

__device__ bool ev_cas_word(Sim& s, int t, int addr, uint32_t expected,
                            uint32_t desired) {
  const int line = line_of(s, addr);
  const uint32_t cur = s.cache[addr];
  const bool ok = cur == expected;
  const uint32_t nw = ok ? desired : cur;
  ref_update(s, s.ref_cache, cur, nw);
  s.cache[addr] = nw;
  const bool owned = take_line(s, t, line);
  cnt(s, t, CNT_CAS) += 1;
  cost(s, t, owned ? s.c[C_CAS_OWNED] : s.c[C_CAS_REMOTE]);
  return ok;
}

__device__ void ev_store_word(Sim& s, int t, int addr, uint32_t value,
                              bool cas_class = false) {
  const int line = line_of(s, addr);
  ref_update(s, s.ref_cache, s.cache[addr], value);
  s.cache[addr] = value;
  const bool owned = take_line(s, t, line);
  cnt(s, t, cas_class ? CNT_CAS : CNT_STORE) += 1;
  cost(s, t, owned ? s.c[C_STORE_OWNED] : s.c[C_STORE_REMOTE]);
}

__device__ void ev_persist_word(Sim& s, int t, int addr) {
  const int line = line_of(s, addr);
  const uint32_t word = s.cache[addr];
  ref_update(s, s.ref_pmem, s.pmem[addr], word);
  s.pmem[addr] = word;
  s.lo[line] = -1;
  cnt(s, t, CNT_FLUSH) += 1;
  cost(s, t, s.c[C_FLUSH]);
}

__device__ void ev_persist_desc(Sim& s, int t, int dt) {
  s.d_state_p[dt] = s.d_state[dt];
  s.d_ver_p[dt] = s.d_ver[dt];
  for (int j = 0; j < s.k; ++j) {
    s.d_addr_p[tk(s, dt, j)] = s.d_addr[tk(s, dt, j)];
    s.d_exp_p[tk(s, dt, j)] = s.d_exp[tk(s, dt, j)];
    s.d_des_p[tk(s, dt, j)] = s.d_des[tk(s, dt, j)];
  }
  s.lo[desc_line(s, dt)] = -1;
  cnt(s, t, CNT_FLUSH) += s.dl;
  cost(s, t, s.c[C_FLUSH] * s.dl);
}

__device__ void ev_persist_desc_state(Sim& s, int t, int dt) {
  s.d_state_p[dt] = s.d_state[dt];
  s.d_ver_p[dt] = s.d_ver[dt];
  s.lo[desc_line(s, dt)] = -1;
  cnt(s, t, CNT_FLUSH) += 1;
  cost(s, t, s.c[C_FLUSH]);
}

__device__ void ev_desc_store(Sim& s, int t, int dt, bool cas_class = false) {
  const bool owned = take_line(s, t, desc_line(s, dt));
  cnt(s, t, cas_class ? CNT_CAS : CNT_STORE) += 1;
  if (cas_class)
    cost(s, t, owned ? s.c[C_CAS_OWNED] : s.c[C_CAS_REMOTE]);
  else
    cost(s, t, owned ? s.c[C_STORE_OWNED] : s.c[C_STORE_REMOTE]);
}

// -- shared helpers for branch bodies ----------------------------------------

__device__ void enter_wait(Sim& s, int t, int ret_pc) {
  const int be = s.backoff_exp[t];
  s.backoff[t] = be;
  s.backoff_exp[t] = be * 2 < s.bcap ? be * 2 : s.bcap;
  s.ret_pc[t] = ret_pc;
  s.pc[t] = READ_WAIT;
}

// target j done: the next one, or last_pc after the k-th
__device__ void advance(Sim& s, int t, int32_t* fld, int j, int last_pc,
                        int next_pc) {
  const bool done = j + 1 >= s.k;
  fld[t] = done ? 0 : j + 1;
  s.pc[t] = done ? last_pc : next_pc;
}

__device__ __forceinline__ uint32_t final_word(const Sim& s, int t, int j) {
  return s.success[t] ? s.d_des[tk(s, t, j)] : s.d_exp[tk(s, t, j)];
}

__device__ __forceinline__ bool holds_my_desc(const Sim& s, int t,
                                              uint32_t word) {
  const uint32_t tag = word & TAG_MASK;
  return (tag == TAG_DESC || tag == TAG_DESC_DIRTY) &&
         (word >> TAG_SHIFT) == desc_ptr(s, t);
}

__device__ __forceinline__ int first_fin(const Sim& s) {
  return s.alg == ALG_OURS_DF ? FIN_STORE_DIRTY : FIN_STORE;
}

__device__ __forceinline__ bool clean(const Sim& s, int t) {
  const int pc = s.pc[t];
  return pc == s.start || (pc == READ_WAIT && s.ret_pc[t] == s.start);
}

// -- branches: OURS / OURS_DF (paper Fig. 4) and shared with ORIGINAL -------

__device__ void enter_help(Sim& s, int t, uint32_t word, int ret_pc) {
  cnt(s, t, CNT_HELPS) += 1;
  s.help_desc[t] = static_cast<int32_t>(word >> TAG_SHIFT);
  s.help_tgt[t] = 0;
  s.help_ok[t] = 1;
  s.ret_pc[t] = ret_pc;
  s.pc[t] = H_TEST;
}

__device__ void br_read_tgt(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = op_addr(s, t, j);
  ev_load(s, t, line_of(s, addr));
  const uint32_t word = s.cache[addr];
  const uint32_t tag = word & TAG_MASK;
  if (tag != 0) {
    if (s.alg != ALG_ORIGINAL) {
      enter_wait(s, t, READ_TGT);
    } else if (tag == TAG_DIRTY) {   // readers flush dirty words, then clear
      ev_persist_word(s, t, addr);
      ev_store_word(s, t, addr, word & PAYLOAD);
    } else {                         // the original algorithm HELPS
      enter_help(s, t, word, READ_TGT);
    }
    return;
  }
  s.exp[tk(s, t, j)] = word >> TAG_SHIFT;
  s.backoff_exp[t] = s.binit;
  advance(s, t, s.tgt_idx, j, INIT_DESC, READ_TGT);
}

__device__ void br_read_wait(Sim& s, int t) {
  const int b = s.backoff[t];
  cost(s, t, s.c[C_WAIT]);
  s.backoff[t] = b - 1;
  if (b - 1 <= 0) s.pc[t] = s.ret_pc[t];
}

__device__ void br_init_desc(Sim& s, int t) {
  const int row = op_row(s, t);
  s.d_state[t] = s.alg == ALG_ORIGINAL ? ST_UNDECIDED : ST_FAILED;
  s.d_state_dirty[t] = 0;
  for (int j = 0; j < s.k; ++j) {
    const uint32_t e = s.exp[tk(s, t, j)];
    uint32_t d = s.ops_des[row + j];
    if (d == DES_INCREMENT) d = e + 1u;
    s.d_addr[tk(s, t, j)] = s.ops[row + j];
    s.d_exp[tk(s, t, j)] = e << TAG_SHIFT;
    s.d_des[tk(s, t, j)] = d << TAG_SHIFT;
  }
  s.success[t] = 1;
  ev_desc_store(s, t, t);
  s.tgt_idx[t] = 0;
  s.pc[t] = PERSIST_DESC;
}

__device__ void br_persist_desc(Sim& s, int t) {
  ev_persist_desc(s, t, t);
  s.pc[t] = s.alg == ALG_ORIGINAL ? O_RDCSS_CAS : RESERVE_TEST;
}

__device__ void br_reserve_test(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  ev_load(s, t, line_of(s, addr));
  const uint32_t word = s.cache[addr];
  if (word & TAG_MASK) {
    enter_wait(s, t, RESERVE_TEST);
  } else if (word == s.d_exp[tk(s, t, j)]) {
    s.pc[t] = RESERVE_CAS;
  } else {                           // Fig. 4 lines 8-10: failed, abort
    s.success[t] = 0;
    s.tgt_idx[t] = 0;
    s.pc[t] = first_fin(s);
  }
}

__device__ void br_reserve_cas(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t desc_word = (desc_ptr(s, t) << TAG_SHIFT) | TAG_DESC;
  if (ev_cas_word(s, t, addr, s.d_exp[tk(s, t, j)], desc_word)) {
    s.backoff_exp[t] = s.binit;
    advance(s, t, s.tgt_idx, j, PERSIST_TGT, RESERVE_TEST);
  } else {
    s.pc[t] = RESERVE_TEST;
  }
}

__device__ void br_persist_tgt(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  advance(s, t, s.tgt_idx, j, SET_SUCC, PERSIST_TGT);
}

__device__ void br_set_succ(Sim& s, int t) {
  s.d_state[t] = ST_SUCCEEDED;
  ev_desc_store(s, t, t);
  s.pc[t] = PERSIST_STATE;
}

__device__ void br_persist_state(Sim& s, int t) {
  ev_persist_desc_state(s, t, t);
  s.tgt_idx[t] = 0;
  s.pc[t] = first_fin(s);
}

__device__ void br_fin_store_dirty(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  if (holds_my_desc(s, t, s.cache[addr])) {
    ev_store_word(s, t, addr, final_word(s, t, j) | TAG_DIRTY, true);
    s.pc[t] = FIN_PERSIST_DIRTY;
  } else {
    s.pc[t] = OP_DONE;
  }
}

__device__ void br_fin_persist_dirty(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = FIN_STORE;
}

__device__ void br_fin_store(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = s.cache[addr];
  const uint32_t clean_w = final_word(s, t, j);
  if (s.alg == ALG_OURS_DF) {        // arrived via the dirty path
    ev_store_word(s, t, addr, clean_w, false);
    s.pc[t] = FIN_PERSIST;
  } else if (holds_my_desc(s, t, word)) {
    ev_store_word(s, t, addr, clean_w, true);
    s.pc[t] = FIN_PERSIST;
  } else {
    s.pc[t] = OP_DONE;
  }
}

__device__ void br_fin_persist(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  advance(s, t, s.tgt_idx, j, OP_DONE, first_fin(s));
}

__device__ void br_op_done(Sim& s, int t) {
  bool ok;
  if (s.alg == ALG_ORIGINAL) {
    // epoch-GC stand-in: no recycling while references remain
    if (s.ref_cache[t] + s.ref_pmem[t] > 0) {
      cost(s, t, s.c[C_WAIT]);
      return;
    }
    ok = s.d_state[t] == ST_SUCCEEDED;
  } else {
    ok = s.success[t] != 0;
  }
  s.d_state[t] = ST_COMPLETED;
  cost(s, t, s.c[C_LOCAL]);
  cnt(s, t, ok ? CNT_OPS : CNT_FAILS) += 1;
  s.op_idx[t] += ok ? 1 : 0;
  s.d_ver[t] += 1;
  s.tgt_idx[t] = 0;
  s.pc[t] = s.start;
}

// -- branches: ORIGINAL (Wang et al.): RDCSS install, dirty flags, helping ----

__device__ void br_o_rdcss_cas(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  ev_load(s, t, line_of(s, addr));
  const uint32_t word = s.cache[addr];
  const uint32_t tag = word & TAG_MASK;
  if (holds_my_desc(s, t, word)) {   // a helper already installed it
    advance(s, t, s.tgt_idx, j, O_STATUS_CAS, O_RDCSS_CAS);
  } else if (tag == TAG_DIRTY) {     // flush + clear, then retry
    ev_persist_word(s, t, addr);
    ev_store_word(s, t, addr, word & PAYLOAD);
  } else if (tag == TAG_DESC || tag == TAG_DESC_DIRTY || tag == TAG_RDCSS) {
    enter_help(s, t, word, O_RDCSS_CAS);
  } else if (word == s.d_exp[tk(s, t, j)]) {
    const uint32_t rdcss = (desc_ptr(s, t) << TAG_SHIFT) | TAG_RDCSS;
    if (ev_cas_word(s, t, addr, word, rdcss)) s.pc[t] = O_PROMOTE_CAS;
  } else {                           // unexpected value: the MwCAS fails
    s.success[t] = 0;
    s.pc[t] = O_STATUS_CAS;
  }
}

__device__ void br_o_promote_cas(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const uint32_t ptr = desc_ptr(s, t) << TAG_SHIFT;
  ev_cas_word(s, t, s.d_addr[tk(s, t, j)], ptr | TAG_RDCSS,
              ptr | TAG_DESC_DIRTY);
  s.pc[t] = O_PERSIST_TGT;
}

__device__ void br_o_persist_tgt(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = O_CLEAR_TGT;
}

__device__ void br_o_clear_tgt(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = s.cache[addr];
  if (holds_my_desc(s, t, word)) {
    ev_store_word(s, t, addr, (word & PAYLOAD) | TAG_DESC, true);
    ev_persist_word(s, t, addr);
  } else {
    cost(s, t, s.c[C_LOCAL]);
  }
  advance(s, t, s.tgt_idx, j, O_STATUS_CAS, O_RDCSS_CAS);
}

__device__ void br_o_status_cas(Sim& s, int t) {
  if (s.d_state[t] == ST_UNDECIDED)
    s.d_state[t] = s.success[t] ? ST_SUCCEEDED : ST_FAILED;
  s.d_state_dirty[t] = 1;
  ev_desc_store(s, t, t, true);
  s.pc[t] = O_STATUS_PERSIST;
}

__device__ void br_o_status_persist(Sim& s, int t) {
  ev_persist_desc_state(s, t, t);
  s.pc[t] = O_STATUS_CLEAR;
}

__device__ void br_o_status_clear(Sim& s, int t) {
  s.d_state_dirty[t] = 0;
  ev_desc_store(s, t, t);
  ev_persist_desc_state(s, t, t);    // Wang: the double flush
  s.tgt_idx[t] = 0;
  s.pc[t] = O_FIN_CAS;
}

__device__ void br_o_fin_cas(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = s.cache[addr];
  if (holds_my_desc(s, t, word)) {
    const uint32_t fin = s.d_state[t] == ST_SUCCEEDED ? s.d_des[tk(s, t, j)]
                                                      : s.d_exp[tk(s, t, j)];
    if (ev_cas_word(s, t, addr, word, fin | TAG_DIRTY)) {
      s.pc[t] = O_FIN_PERSIST;
      return;
    }
  }
  // already finalized (possibly by a helper) or never installed
  ev_load(s, t, line_of(s, addr));
  advance(s, t, s.tgt_idx, j, OP_DONE, O_FIN_CAS);
}

__device__ void br_o_fin_persist(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = O_FIN_CLEAR;
}

__device__ void br_o_fin_clear(Sim& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = s.cache[addr];
  if ((word & TAG_MASK) == TAG_DIRTY) {
    ev_store_word(s, t, addr, word & PAYLOAD);
    ev_persist_word(s, t, addr);
  } else {
    cost(s, t, s.c[C_LOCAL]);
  }
  advance(s, t, s.tgt_idx, j, OP_DONE, O_FIN_CAS);
}

// ABA guard: is the helped descriptor still the generation we saw?
__device__ bool help_valid(const Sim& s, int t) {
  const int h = s.help_desc[t];
  const int dt = desc_tid(s, h);
  return static_cast<uint32_t>(s.d_ver[dt]) * static_cast<uint32_t>(s.T) +
             static_cast<uint32_t>(dt) ==
         static_cast<uint32_t>(h);
}

__device__ void abandon(Sim& s, int t) {
  s.help_desc[t] = -1;
  s.pc[t] = s.ret_pc[t];
}

__device__ void br_h_test(Sim& s, int t) {
  const int h = s.help_desc[t];
  const int dt = desc_tid(s, h);
  ev_load(s, t, desc_line(s, dt));
  if (!help_valid(s, t)) {
    abandon(s, t);
  } else if (s.d_state[dt] != ST_UNDECIDED) {
    s.help_tgt[t] = 0;
    s.pc[t] = H_FIN_CAS;
  } else if (s.help_tgt[t] >= s.k) {
    s.pc[t] = H_STATUS_CAS;
  } else {
    const int j = s.help_tgt[t];
    const int addr = s.d_addr[tk(s, dt, j)];
    ev_load(s, t, line_of(s, addr));
    const uint32_t word = s.cache[addr];
    const uint32_t tag = word & TAG_MASK;
    const bool mine = (word >> TAG_SHIFT) == static_cast<uint32_t>(h);
    // ONLY a (possibly dirty) MwCAS descriptor counts as installed
    if (mine && (tag == TAG_DESC || tag == TAG_DESC_DIRTY)) {
      s.help_tgt[t] = j + 1;
    } else if ((mine && tag == TAG_RDCSS) || word == s.d_exp[tk(s, dt, j)]) {
      s.pc[t] = H_CAS;
    } else {                         // drive the helped op to Failed
      s.help_ok[t] = 0;
      s.pc[t] = H_STATUS_CAS;
    }
  }
}

__device__ void br_h_cas(Sim& s, int t) {
  if (!help_valid(s, t)) {
    abandon(s, t);
    return;
  }
  const int h = s.help_desc[t];
  const int dt = desc_tid(s, h);
  const int j = s.help_tgt[t];
  const int addr = s.d_addr[tk(s, dt, j)];
  const uint32_t word = s.cache[addr];
  const uint32_t hp = static_cast<uint32_t>(h) << TAG_SHIFT;
  const uint32_t d_exp = s.d_exp[tk(s, dt, j)];
  // install from the expected value OR promote the helped op's RDCSS
  const bool eligible = word == d_exp || word == (hp | TAG_RDCSS);
  const bool ok = ev_cas_word(s, t, addr, eligible ? word : d_exp,
                              hp | TAG_DESC_DIRTY) && eligible;
  if (ok) {
    ev_persist_word(s, t, addr);
    ev_store_word(s, t, addr, hp | TAG_DESC);
    s.help_tgt[t] = j + 1;
  }
  s.pc[t] = H_TEST;
}

__device__ void br_h_status_cas(Sim& s, int t) {
  if (!help_valid(s, t)) {
    abandon(s, t);
    return;
  }
  const int dt = desc_tid(s, s.help_desc[t]);
  if (s.d_state[dt] == ST_UNDECIDED)
    s.d_state[dt] = s.help_ok[t] ? ST_SUCCEEDED : ST_FAILED;
  ev_desc_store(s, t, dt, true);
  ev_persist_desc_state(s, t, dt);   // persisted before acting on it
  s.help_tgt[t] = 0;
  s.pc[t] = H_FIN_CAS;
}

__device__ void br_h_fin_cas(Sim& s, int t) {
  if (!help_valid(s, t)) {
    abandon(s, t);
    return;
  }
  const int h = s.help_desc[t];
  const int dt = desc_tid(s, h);
  const int j = s.help_tgt[t];
  if (j >= s.k) {                    // done: back to the own op
    abandon(s, t);
    return;
  }
  const int addr = s.d_addr[tk(s, dt, j)];
  const uint32_t word = s.cache[addr];
  const uint32_t tag = word & TAG_MASK;
  if ((word >> TAG_SHIFT) == static_cast<uint32_t>(h) &&
      (tag == TAG_DESC || tag == TAG_DESC_DIRTY)) {
    const uint32_t fin = s.d_state[dt] == ST_SUCCEEDED
                             ? s.d_des[tk(s, dt, j)]
                             : s.d_exp[tk(s, dt, j)];
    if (ev_cas_word(s, t, addr, word, fin | TAG_DIRTY))
      s.pc[t] = H_FIN_PERSIST;
    else
      s.help_tgt[t] = j + 1;
  } else {
    ev_load(s, t, line_of(s, addr));
    s.help_tgt[t] = j + 1;
  }
}

__device__ void br_h_fin_persist(Sim& s, int t) {
  const int dt = desc_tid(s, s.help_desc[t]);
  const int j = s.help_tgt[t];
  ev_persist_word(s, t, s.d_addr[tk(s, dt, j)]);
  s.pc[t] = H_FIN_CLEAR;
}

__device__ void br_h_fin_clear(Sim& s, int t) {
  const int dt = desc_tid(s, s.help_desc[t]);
  const int j = s.help_tgt[t];
  const int addr = s.d_addr[tk(s, dt, j)];
  const uint32_t word = s.cache[addr];
  if ((word & TAG_MASK) == TAG_DIRTY)
    ev_store_word(s, t, addr, word & PAYLOAD);
  else
    cost(s, t, s.c[C_LOCAL]);
  s.help_tgt[t] = j + 1;
  s.pc[t] = H_FIN_CAS;
}

// -- branches: PCAS (persistent single-word CAS, TTAS + back-off) ------------

__device__ void br_p_read(Sim& s, int t) {
  const int addr = op_addr(s, t, 0);
  ev_load(s, t, line_of(s, addr));
  const uint32_t word = s.cache[addr];
  if (word & TAG_MASK) {
    enter_wait(s, t, P_READ);
  } else {
    s.exp[tk(s, t, 0)] = word >> TAG_SHIFT;
    s.backoff_exp[t] = s.binit;
    s.pc[t] = P_CAS;
  }
}

__device__ void br_p_cas(Sim& s, int t) {
  const int addr = op_addr(s, t, 0);
  const uint32_t v = s.exp[tk(s, t, 0)];
  const bool ok = ev_cas_word(s, t, addr, v << TAG_SHIFT,
                              ((v + 1u) << TAG_SHIFT) | TAG_DIRTY);
  if (!ok) cnt(s, t, CNT_FAILS) += 1;
  s.pc[t] = ok ? P_PERSIST : P_READ;
}

__device__ void br_p_persist(Sim& s, int t) {
  ev_persist_word(s, t, op_addr(s, t, 0));
  s.pc[t] = P_CLEAR;
}

__device__ void br_p_clear(Sim& s, int t) {
  const int addr = op_addr(s, t, 0);
  ev_store_word(s, t, addr, (s.exp[tk(s, t, 0)] + 1u) << TAG_SHIFT, true);
  s.success[t] = 1;
  s.pc[t] = OP_DONE;
}

// -- dispatch ------------------------------------------------------------------

__device__ void step(Sim& s, int t) {
  int pc = s.pc[t];
  if (pc < 0) pc += PC_COUNT;        // the reference's gather: wrap once,
  pc = pc < 0 ? 0 : (pc >= PC_COUNT ? PC_COUNT - 1 : pc);   // then clamp
  if (!((s.reach >> pc) & 1ull)) pc = s.first;
  switch (pc) {
    case READ_TGT: br_read_tgt(s, t); break;
    case READ_WAIT:
    case RESERVE_WAIT: br_read_wait(s, t); break;
    case INIT_DESC: br_init_desc(s, t); break;
    case PERSIST_DESC: br_persist_desc(s, t); break;
    case RESERVE_TEST: br_reserve_test(s, t); break;
    case RESERVE_CAS: br_reserve_cas(s, t); break;
    case PERSIST_TGT: br_persist_tgt(s, t); break;
    case SET_SUCC: br_set_succ(s, t); break;
    case PERSIST_STATE: br_persist_state(s, t); break;
    case FIN_STORE_DIRTY: br_fin_store_dirty(s, t); break;
    case FIN_PERSIST_DIRTY: br_fin_persist_dirty(s, t); break;
    case FIN_STORE: br_fin_store(s, t); break;
    case FIN_PERSIST: br_fin_persist(s, t); break;
    case OP_DONE: br_op_done(s, t); break;
    case O_RDCSS_CAS: br_o_rdcss_cas(s, t); break;
    case O_PROMOTE_CAS: br_o_promote_cas(s, t); break;
    case O_PERSIST_TGT: br_o_persist_tgt(s, t); break;
    case O_CLEAR_TGT: br_o_clear_tgt(s, t); break;
    case O_STATUS_CAS: br_o_status_cas(s, t); break;
    case O_STATUS_PERSIST: br_o_status_persist(s, t); break;
    case O_STATUS_CLEAR: br_o_status_clear(s, t); break;
    case O_FIN_CAS: br_o_fin_cas(s, t); break;
    case O_FIN_PERSIST: br_o_fin_persist(s, t); break;
    case O_FIN_CLEAR: br_o_fin_clear(s, t); break;
    case H_TEST: br_h_test(s, t); break;
    case H_CAS: br_h_cas(s, t); break;
    case H_STATUS_CAS: br_h_status_cas(s, t); break;
    case H_FIN_CAS: br_h_fin_cas(s, t); break;
    case H_FIN_PERSIST: br_h_fin_persist(s, t); break;
    case H_FIN_CLEAR: br_h_fin_clear(s, t); break;
    case P_READ: br_p_read(s, t); break;
    case P_CAS: br_p_cas(s, t); break;
    case P_PERSIST: br_p_persist(s, t); break;
    default: br_p_clear(s, t); break;    // P_CLEAR
  }
}

__device__ bool in_read_phase(const Sim& s, int t) {
  const int pc = s.pc[t];
  return s.alg == ALG_PCAS ? pc == P_READ
                           : (pc == READ_TGT || pc == READ_WAIT);
}

__global__ void __launch_bounds__(32)
pmwcas_sim_kernel(const long long* rec, long long* out, int n) {
  const int sim = blockIdx.x;
  if (sim >= n || threadIdx.x != 0) return;
  const long long* r = rec + static_cast<long long>(sim) * R_LEN;
  long long* o = out + static_cast<long long>(sim) * OUT_LEN;
  Sim s;
  load_sim(s, r);
  long long steps = 0;
  if (r[R_MODE] == MODE_SCHEDULE) {
    const int32_t* sched =
        reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(r[R_SCHED]));
    long long lim = r[R_NSCHED] < r[R_CUT] ? r[R_NSCHED] : r[R_CUT];
    for (long long i = 0; i < lim; ++i) {
      const int tid = sched[i];      // negative entries are no-ops
      if (tid >= 0) {
        step(s, tid);
        ++steps;
      }
    }
    long long rounds = 0;
    if (r[R_DRAIN]) {
      while (rounds < kMaxDrainRounds) {
        bool all_clean = true;
        for (int t = 0; t < s.T && all_clean; ++t) all_clean = clean(s, t);
        if (all_clean) break;
        for (int t = 0; t < s.T; ++t) {   // each tested at its own turn
          if (!clean(s, t)) {
            step(s, t);
            ++steps;
          }
        }
        ++rounds;
      }
    }
    o[0] = rounds;
  } else if (r[R_MODE] == MODE_BACKEND) {   // SimBackend's two phases
    const long long cap = r[R_CAP];
    for (int phase = 0; phase < 2; ++phase) {
      for (int t = 0; t < s.T; ++t) {
        long long n_steps = 0;
        while (phase == 0 ? in_read_phase(s, t)
                          : (s.op_idx[t] < 1 && cnt(s, t, CNT_FAILS) < 1)) {
          step(s, t);
          ++steps;
          if (++n_steps > cap) {
            o[1] = phase == 0 ? ERR_READ_PHASE : ERR_ATTEMPT;
            o[2] = t;
            o[3] = steps;
            return;
          }
        }
      }
    }
  }
  o[3] = steps;
}

}  // namespace

// rec int64[n, R_LEN], out int64[n, OUT_LEN] (zeroed by the caller); one
// block of one warp per simulation.  Returns cudaGetLastError().
extern "C" int pmwcas_sim_launch(const void* rec, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  pmwcas_sim_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rec), static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmwcas_sim_rec_len() { return R_LEN; }

extern "C" const char* pmwcas_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
