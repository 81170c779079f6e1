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
// is the caller's tensors, updated in place.
//
// Bound: latency.  A step is a chain of dependent steps of one thread of
// one warp: load the schedule entry, load the thread's PC, map it to a
// branch and dispatch (a tree of compares and an indirect jump), then the
// branch's loads and stores of the thread's registers, its op's address,
// the word and its line's owner, with data-dependent branches between.  A
// simulation is sequential, so nothing hides that chain but other
// simulations on other SMs.  On this card a load from shared memory or L1
// costs some 30 cycles, one from L2 some 250, a word's first touch in
// device memory more, and each dependent instruction a few cycles.
// scripts/sim_kernel_probe.py times each branch (clock64) and ablations of
// each choice below.
//
// Two routes, one kernel each, over the same branch code (templated on
// the state's view, Sim or SimS); kernels/pmwcas_sim/kernel.py::plan picks
// one a launch:
// - smem (pmwcas_sim_smem_kernel): each simulation's per-thread state (the
//   [T] and [T, k] registers, the descriptors, the [T, 9] counters and the
//   descriptor lines' owners) is copied into dynamic shared memory at entry
//   by all lanes and written back at the end (also when a SimBackend
//   attempt cap stops it), so only the words (cache, pmem), their lines'
//   owners and the ops stay in device memory.  The schedule streams
//   through a double buffer in shared memory (cp.async, SCHED_CHUNK
//   entries a stage, issued by all lanes while lane 0 steps the other
//   stage).  Each thread's current op (its k addresses and desired values)
//   is staged in shared memory when its op index advances.  A word event
//   loads the word and its line's owner together, before any store.  The
//   divisions a step needs at run time become a shift (the line of a word,
//   at a power-of-two line width) and multiplies (the thread a descriptor
//   names, the op row: fastmod).  The schedule loop has one copy an
//   algorithm, in which the switch's tree of compares covers only that
//   algorithm's PCs and the branches' tests of the algorithm fold.  The
//   launch asks for the SM's split of shared memory and L1 that its blocks
//   need and leaves the rest to L1, which caches the words.  Taken when the
//   largest state of the launch fits the card's 227 KB of shared memory;
// - global (pmwcas_sim_kernel): the state stays in the global memory of
//   the caller's tensors, every field read and written in place.  It takes
//   every state, wide SimBackend rounds (one thread an op) among them.
// Both write each simulation's elapsed %globaltimer nanoseconds into its
// output.
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
// output slots: kernels/pmwcas_sim/kernel.py's O_* of the same order
enum : int { O_ROUNDS = 0, O_ERR, O_ERR_THREAD, O_STEPS, O_NS, OUT_LEN };
constexpr int MODE_SCHEDULE = 0, MODE_BACKEND = 1;
// ERR_SMEM: the smem route was given less shared memory than the state
constexpr int ERR_READ_PHASE = 1, ERR_ATTEMPT = 2, ERR_SMEM = 3;
// schedule entries a stage of the smem route's double buffer
constexpr int SCHED_CHUNK = 512;
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

__host__ __device__ constexpr unsigned long long bit(int pc) {
  return 1ull << pc;
}
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

// the PCs algorithm a reaches (core/engine.py ALG_PCS), and its first
// branch, where a PC it never reaches goes (the first of every list)
__host__ __device__ constexpr unsigned long long reach_of(int a) {
  return a == ALG_OURS       ? REACH_OURS
         : a == ALG_OURS_DF  ? REACH_OURS_DF
         : a == ALG_ORIGINAL ? REACH_ORIGINAL
                             : REACH_PCAS;
}
__host__ __device__ constexpr int first_of(int a) {
  return a == ALG_PCAS ? P_READ : READ_TGT;
}

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

// The smem route's view of a simulation: every per-thread field above
// points into the block's shared memory; cache, pmem, lo (the word lines'
// owners), ops and ops_des stay in device memory.
struct SimS : Sim {
  int32_t* lo_d;                     // the descriptor lines' owners [T * dl]
  int32_t* op_a;                     // each thread's current op: addresses
  uint32_t* op_d;                    // and desired values, [T, k]
  int wpl_shift;                     // log2(wpl), or -1: not a power of 2
  unsigned long long t_magic;        // fastmod's magic of T
  unsigned long long ops_magic;      // and of max_ops
};

// a % d through d's magic ~0ull / d + 1, for every 32-bit a (Lemire,
// Kaser and Kurz, "Faster remainder by direct computation", 2019): a few
// multiplies where a division by a value known only at run time is a
// chain of some twenty dependent instructions
__device__ __forceinline__ uint32_t fastmod(uint32_t a,
                                            unsigned long long magic,
                                            uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * a, d));
}

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
  s.start = s.first = first_of(s.alg);
  s.reach = reach_of(s.alg);
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

template <class S>
__device__ __forceinline__ long long& cnt(S& s, int t, int c) {
  return s.cnt[static_cast<long long>(t) * N_COUNTERS + c];
}
template <class S>
__device__ __forceinline__ void cost(S& s, int t, long long cycles) {
  cnt(s, t, CNT_CYCLES) += cycles;
}
template <class S>
__device__ __forceinline__ int tk(const S& s, int t, int j) {
  return t * s.k + j;
}
template <class S>
__device__ __forceinline__ int op_row(const S& s, int t) {
  // ops wrap around (op_idx >= 0, so % is the reference's lax.rem)
  return (t * s.max_ops + s.op_idx[t] % s.max_ops) * s.k;
}
__device__ __forceinline__ int op_row(const SimS& s, int t) {
  return (t * s.max_ops + static_cast<int>(fastmod(
      static_cast<uint32_t>(s.op_idx[t]), s.ops_magic,
      static_cast<uint32_t>(s.max_ops)))) * s.k;
}
// the thread's current op: its row of ops / ops_des in place (global), or
// the copy staged in shared memory (smem)
struct OpRow {
  const int32_t* addr;
  const uint32_t* des;
};
__device__ __forceinline__ OpRow cur_op(const Sim& s, int t) {
  const int row = op_row(s, t);
  return {s.ops + row, s.ops_des + row};
}
__device__ __forceinline__ OpRow cur_op(const SimS& s, int t) {
  return {s.op_a + tk(s, t, 0), s.op_d + tk(s, t, 0)};
}
template <class S>
__device__ __forceinline__ int op_addr(const S& s, int t, int j) {
  return cur_op(s, t).addr[j];
}
template <class S>
__device__ __forceinline__ uint32_t desc_ptr(const S& s, int t) {
  return static_cast<uint32_t>(s.d_ver[t]) * static_cast<uint32_t>(s.T) +
         static_cast<uint32_t>(t);
}
template <class S>
__device__ __forceinline__ int desc_tid(const S& s, int val) {
  const int r = val % s.T;                 // floor-mod, as jnp's %
  return r < 0 ? r + s.T : r;
}
__device__ __forceinline__ int desc_tid(const SimS& s, int val) {
  return val >= 0 ? static_cast<int>(fastmod(static_cast<uint32_t>(val),
                                             s.t_magic,
                                             static_cast<uint32_t>(s.T)))
                  : desc_tid(static_cast<const Sim&>(s), val);
}
// the thread a descriptor word's payload names (payload % T)
template <class S>
__device__ __forceinline__ uint32_t word_tid(const S& s, uint32_t word) {
  return (word >> TAG_SHIFT) % static_cast<uint32_t>(s.T);
}
__device__ __forceinline__ uint32_t word_tid(const SimS& s, uint32_t word) {
  return fastmod(word >> TAG_SHIFT, s.t_magic, static_cast<uint32_t>(s.T));
}
template <class S>
__device__ __forceinline__ int line_of(const S& s, int addr) {
  int q = addr / s.wpl;                    // floor division, as jnp's //
  if (addr % s.wpl != 0 && addr < 0) --q;
  return q;
}
__device__ __forceinline__ int line_of(const SimS& s, int addr) {
  // an arithmetic shift is floor division by a power of two
  return s.wpl_shift >= 0 ? addr >> s.wpl_shift
                          : line_of(static_cast<const Sim&>(s), addr);
}
template <class S>
__device__ __forceinline__ int desc_line(const S& s, int dt) {
  return s.nwl + dt * s.dl;
}

// a line's owner: in place (global); the smem route keeps the descriptor
// lines' (from nwl on) in shared memory
__device__ __forceinline__ int32_t& owner(Sim& s, int line) {
  return s.lo[line];
}
__device__ __forceinline__ int32_t& owner(SimS& s, int line) {
  return line < s.nwl ? s.lo[line] : s.lo_d[line - s.nwl];
}

// -- memory events -------------------------------------------------------------

template <class S>
__device__ void ev_load(S& s, int t, int line) {
  const bool owned = owner(s, line) == t;
  cnt(s, t, CNT_LOAD) += 1;
  cost(s, t, owned ? s.c[C_LOAD_HIT] : s.c[C_LOAD_MISS]);
}

// write-side ownership transfer; true when the line was already ours
template <class S>
__device__ bool take_line(S& s, int t, int line) {
  int32_t& o = owner(s, line);
  const int prev = o;
  if (prev != t && prev >= 0) cnt(s, t, CNT_INVAL) += 1;
  o = t;
  return prev == t;
}

__device__ __forceinline__ bool is_ref(uint32_t word) {
  const uint32_t tag = word & TAG_MASK;
  return tag == TAG_DESC || tag == TAG_DESC_DIRTY || tag == TAG_RDCSS;
}

template <class S>
__device__ void ref_update(S& s, int32_t* field, uint32_t old_w,
                           uint32_t new_w) {
  if (is_ref(old_w)) field[word_tid(s, old_w)] -= 1;
  if (is_ref(new_w)) field[word_tid(s, new_w)] += 1;
}

template <class S>
__device__ bool ev_cas_word(S& s, int t, int addr, uint32_t expected,
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

template <class S>
__device__ void ev_store_word(S& s, int t, int addr, uint32_t value,
                              bool cas_class = false) {
  const int line = line_of(s, addr);
  ref_update(s, s.ref_cache, s.cache[addr], value);
  s.cache[addr] = value;
  const bool owned = take_line(s, t, line);
  cnt(s, t, cas_class ? CNT_CAS : CNT_STORE) += 1;
  cost(s, t, owned ? s.c[C_STORE_OWNED] : s.c[C_STORE_REMOTE]);
}

// The smem route's word events: a word and its line's owner, both in
// device memory, are loaded together before any store, so the two loads
// cost one round trip and not two; the counts and stores are those above.
template <class S>
__device__ __forceinline__ uint32_t ev_load_word(S& s, int t, int addr) {
  ev_load(s, t, line_of(s, addr));
  return s.cache[addr];
}
__device__ __forceinline__ uint32_t ev_load_word(SimS& s, int t, int addr) {
  const uint32_t word = s.cache[addr];
  const bool owned = s.lo[line_of(s, addr)] == t;
  cnt(s, t, CNT_LOAD) += 1;
  cost(s, t, owned ? s.c[C_LOAD_HIT] : s.c[C_LOAD_MISS]);
  return word;
}

// a word's line taken by thread t whose owner was prev (take_line's count)
__device__ __forceinline__ bool took(SimS& s, int t, int line, int prev) {
  if (prev != t && prev >= 0) cnt(s, t, CNT_INVAL) += 1;
  s.lo[line] = t;
  return prev == t;
}

__device__ bool ev_cas_word(SimS& s, int t, int addr, uint32_t expected,
                            uint32_t desired) {
  const int line = line_of(s, addr);
  const uint32_t cur = s.cache[addr];
  const int prev = s.lo[line];
  const bool ok = cur == expected;
  const uint32_t nw = ok ? desired : cur;
  ref_update(s, s.ref_cache, cur, nw);
  s.cache[addr] = nw;
  const bool owned = took(s, t, line, prev);
  cnt(s, t, CNT_CAS) += 1;
  cost(s, t, owned ? s.c[C_CAS_OWNED] : s.c[C_CAS_REMOTE]);
  return ok;
}

__device__ void ev_store_word(SimS& s, int t, int addr, uint32_t value,
                              bool cas_class = false) {
  const int line = line_of(s, addr);
  const uint32_t old = s.cache[addr];
  const int prev = s.lo[line];
  ref_update(s, s.ref_cache, old, value);
  s.cache[addr] = value;
  const bool owned = took(s, t, line, prev);
  cnt(s, t, cas_class ? CNT_CAS : CNT_STORE) += 1;
  cost(s, t, owned ? s.c[C_STORE_OWNED] : s.c[C_STORE_REMOTE]);
}

template <class S>
__device__ void ev_persist_word(S& s, int t, int addr) {
  const int line = line_of(s, addr);
  const uint32_t word = s.cache[addr];
  ref_update(s, s.ref_pmem, s.pmem[addr], word);
  s.pmem[addr] = word;
  owner(s, line) = -1;
  cnt(s, t, CNT_FLUSH) += 1;
  cost(s, t, s.c[C_FLUSH]);
}

template <class S>
__device__ void ev_persist_desc(S& s, int t, int dt) {
  s.d_state_p[dt] = s.d_state[dt];
  s.d_ver_p[dt] = s.d_ver[dt];
  for (int j = 0; j < s.k; ++j) {
    s.d_addr_p[tk(s, dt, j)] = s.d_addr[tk(s, dt, j)];
    s.d_exp_p[tk(s, dt, j)] = s.d_exp[tk(s, dt, j)];
    s.d_des_p[tk(s, dt, j)] = s.d_des[tk(s, dt, j)];
  }
  owner(s, desc_line(s, dt)) = -1;
  cnt(s, t, CNT_FLUSH) += s.dl;
  cost(s, t, s.c[C_FLUSH] * s.dl);
}

template <class S>
__device__ void ev_persist_desc_state(S& s, int t, int dt) {
  s.d_state_p[dt] = s.d_state[dt];
  s.d_ver_p[dt] = s.d_ver[dt];
  owner(s, desc_line(s, dt)) = -1;
  cnt(s, t, CNT_FLUSH) += 1;
  cost(s, t, s.c[C_FLUSH]);
}

template <class S>
__device__ void ev_desc_store(S& s, int t, int dt, bool cas_class = false) {
  const bool owned = take_line(s, t, desc_line(s, dt));
  cnt(s, t, cas_class ? CNT_CAS : CNT_STORE) += 1;
  if (cas_class)
    cost(s, t, owned ? s.c[C_CAS_OWNED] : s.c[C_CAS_REMOTE]);
  else
    cost(s, t, owned ? s.c[C_STORE_OWNED] : s.c[C_STORE_REMOTE]);
}

// -- the smem route's staged op -----------------------------------------------

// Stage thread t's current op (the row op_idx[t] names) in shared memory.
// (Prefetching the next op's row, or the op's words, their pmem copies and
// their lines' owners, into L1 cost more than it saved:
// scripts/sim_kernel_probe.py, prefetch.)
__device__ void stage_op(SimS& s, int t) {
  const int row = op_row(s, t);
  for (int j = 0; j < s.k; ++j) {
    s.op_a[tk(s, t, j)] = __ldg(s.ops + row + j);
    s.op_d[tk(s, t, j)] = __ldg(s.ops_des + row + j);
  }
}

// called when a thread's op index advances
__device__ __forceinline__ void next_op(Sim&, int) {}
__device__ __forceinline__ void next_op(SimS& s, int t) { stage_op(s, t); }

// -- shared helpers for branch bodies ----------------------------------------

template <class S>
__device__ void enter_wait(S& s, int t, int ret_pc) {
  const int be = s.backoff_exp[t];
  s.backoff[t] = be;
  s.backoff_exp[t] = be * 2 < s.bcap ? be * 2 : s.bcap;
  s.ret_pc[t] = ret_pc;
  s.pc[t] = READ_WAIT;
}

// target j done: the next one, or last_pc after the k-th
template <class S>
__device__ void advance(S& s, int t, int32_t* fld, int j, int last_pc,
                        int next_pc) {
  const bool done = j + 1 >= s.k;
  fld[t] = done ? 0 : j + 1;
  s.pc[t] = done ? last_pc : next_pc;
}

template <class S>
__device__ __forceinline__ uint32_t final_word(const S& s, int t, int j) {
  return s.success[t] ? s.d_des[tk(s, t, j)] : s.d_exp[tk(s, t, j)];
}

template <class S>
__device__ __forceinline__ bool holds_my_desc(const S& s, int t,
                                              uint32_t word) {
  const uint32_t tag = word & TAG_MASK;
  return (tag == TAG_DESC || tag == TAG_DESC_DIRTY) &&
         (word >> TAG_SHIFT) == desc_ptr(s, t);
}

template <class S>
__device__ __forceinline__ int first_fin(const S& s) {
  return s.alg == ALG_OURS_DF ? FIN_STORE_DIRTY : FIN_STORE;
}

template <class S>
__device__ __forceinline__ bool clean(const S& s, int t) {
  const int pc = s.pc[t];
  return pc == s.start || (pc == READ_WAIT && s.ret_pc[t] == s.start);
}

// -- branches: OURS / OURS_DF (paper Fig. 4) and shared with ORIGINAL -------

template <class S>
__device__ void enter_help(S& s, int t, uint32_t word, int ret_pc) {
  cnt(s, t, CNT_HELPS) += 1;
  s.help_desc[t] = static_cast<int32_t>(word >> TAG_SHIFT);
  s.help_tgt[t] = 0;
  s.help_ok[t] = 1;
  s.ret_pc[t] = ret_pc;
  s.pc[t] = H_TEST;
}

template <class S>
__device__ void br_read_tgt(S& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = op_addr(s, t, j);
  const uint32_t word = ev_load_word(s, t, addr);
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

template <class S>
__device__ void br_read_wait(S& s, int t) {
  const int b = s.backoff[t];
  cost(s, t, s.c[C_WAIT]);
  s.backoff[t] = b - 1;
  if (b - 1 <= 0) s.pc[t] = s.ret_pc[t];
}

template <class S>
__device__ void br_init_desc(S& s, int t) {
  const OpRow op = cur_op(s, t);
  s.d_state[t] = s.alg == ALG_ORIGINAL ? ST_UNDECIDED : ST_FAILED;
  s.d_state_dirty[t] = 0;
  for (int j = 0; j < s.k; ++j) {
    const uint32_t e = s.exp[tk(s, t, j)];
    uint32_t d = op.des[j];
    if (d == DES_INCREMENT) d = e + 1u;
    s.d_addr[tk(s, t, j)] = op.addr[j];
    s.d_exp[tk(s, t, j)] = e << TAG_SHIFT;
    s.d_des[tk(s, t, j)] = d << TAG_SHIFT;
  }
  s.success[t] = 1;
  ev_desc_store(s, t, t);
  s.tgt_idx[t] = 0;
  s.pc[t] = PERSIST_DESC;
}

template <class S>
__device__ void br_persist_desc(S& s, int t) {
  ev_persist_desc(s, t, t);
  s.pc[t] = s.alg == ALG_ORIGINAL ? O_RDCSS_CAS : RESERVE_TEST;
}

template <class S>
__device__ void br_reserve_test(S& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = ev_load_word(s, t, addr);
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

template <class S>
__device__ void br_reserve_cas(S& s, int t) {
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

template <class S>
__device__ void br_persist_tgt(S& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  advance(s, t, s.tgt_idx, j, SET_SUCC, PERSIST_TGT);
}

template <class S>
__device__ void br_set_succ(S& s, int t) {
  s.d_state[t] = ST_SUCCEEDED;
  ev_desc_store(s, t, t);
  s.pc[t] = PERSIST_STATE;
}

template <class S>
__device__ void br_persist_state(S& s, int t) {
  ev_persist_desc_state(s, t, t);
  s.tgt_idx[t] = 0;
  s.pc[t] = first_fin(s);
}

template <class S>
__device__ void br_fin_store_dirty(S& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  if (holds_my_desc(s, t, s.cache[addr])) {
    ev_store_word(s, t, addr, final_word(s, t, j) | TAG_DIRTY, true);
    s.pc[t] = FIN_PERSIST_DIRTY;
  } else {
    s.pc[t] = OP_DONE;
  }
}

template <class S>
__device__ void br_fin_persist_dirty(S& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = FIN_STORE;
}

template <class S>
__device__ void br_fin_store(S& s, int t) {
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

template <class S>
__device__ void br_fin_persist(S& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  advance(s, t, s.tgt_idx, j, OP_DONE, first_fin(s));
}

template <class S>
__device__ void br_op_done(S& s, int t) {
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
  if (ok) next_op(s, t);
  s.d_ver[t] += 1;
  s.tgt_idx[t] = 0;
  s.pc[t] = s.start;
}

// -- branches: ORIGINAL (Wang et al.): RDCSS install, dirty flags, helping ----

template <class S>
__device__ void br_o_rdcss_cas(S& s, int t) {
  const int j = s.tgt_idx[t];
  const int addr = s.d_addr[tk(s, t, j)];
  const uint32_t word = ev_load_word(s, t, addr);
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

template <class S>
__device__ void br_o_promote_cas(S& s, int t) {
  const int j = s.tgt_idx[t];
  const uint32_t ptr = desc_ptr(s, t) << TAG_SHIFT;
  ev_cas_word(s, t, s.d_addr[tk(s, t, j)], ptr | TAG_RDCSS,
              ptr | TAG_DESC_DIRTY);
  s.pc[t] = O_PERSIST_TGT;
}

template <class S>
__device__ void br_o_persist_tgt(S& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = O_CLEAR_TGT;
}

template <class S>
__device__ void br_o_clear_tgt(S& s, int t) {
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

template <class S>
__device__ void br_o_status_cas(S& s, int t) {
  if (s.d_state[t] == ST_UNDECIDED)
    s.d_state[t] = s.success[t] ? ST_SUCCEEDED : ST_FAILED;
  s.d_state_dirty[t] = 1;
  ev_desc_store(s, t, t, true);
  s.pc[t] = O_STATUS_PERSIST;
}

template <class S>
__device__ void br_o_status_persist(S& s, int t) {
  ev_persist_desc_state(s, t, t);
  s.pc[t] = O_STATUS_CLEAR;
}

template <class S>
__device__ void br_o_status_clear(S& s, int t) {
  s.d_state_dirty[t] = 0;
  ev_desc_store(s, t, t);
  ev_persist_desc_state(s, t, t);    // Wang: the double flush
  s.tgt_idx[t] = 0;
  s.pc[t] = O_FIN_CAS;
}

template <class S>
__device__ void br_o_fin_cas(S& s, int t) {
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

template <class S>
__device__ void br_o_fin_persist(S& s, int t) {
  const int j = s.tgt_idx[t];
  ev_persist_word(s, t, s.d_addr[tk(s, t, j)]);
  s.pc[t] = O_FIN_CLEAR;
}

template <class S>
__device__ void br_o_fin_clear(S& s, int t) {
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
template <class S>
__device__ bool help_valid(const S& s, int t) {
  const int h = s.help_desc[t];
  const int dt = desc_tid(s, h);
  return static_cast<uint32_t>(s.d_ver[dt]) * static_cast<uint32_t>(s.T) +
             static_cast<uint32_t>(dt) ==
         static_cast<uint32_t>(h);
}

template <class S>
__device__ void abandon(S& s, int t) {
  s.help_desc[t] = -1;
  s.pc[t] = s.ret_pc[t];
}

template <class S>
__device__ void br_h_test(S& s, int t) {
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
    const uint32_t word = ev_load_word(s, t, addr);
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

template <class S>
__device__ void br_h_cas(S& s, int t) {
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

template <class S>
__device__ void br_h_status_cas(S& s, int t) {
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

template <class S>
__device__ void br_h_fin_cas(S& s, int t) {
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

template <class S>
__device__ void br_h_fin_persist(S& s, int t) {
  const int dt = desc_tid(s, s.help_desc[t]);
  const int j = s.help_tgt[t];
  ev_persist_word(s, t, s.d_addr[tk(s, dt, j)]);
  s.pc[t] = H_FIN_CLEAR;
}

template <class S>
__device__ void br_h_fin_clear(S& s, int t) {
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

template <class S>
__device__ void br_p_read(S& s, int t) {
  const int addr = op_addr(s, t, 0);
  const uint32_t word = ev_load_word(s, t, addr);
  if (word & TAG_MASK) {
    enter_wait(s, t, P_READ);
  } else {
    s.exp[tk(s, t, 0)] = word >> TAG_SHIFT;
    s.backoff_exp[t] = s.binit;
    s.pc[t] = P_CAS;
  }
}

template <class S>
__device__ void br_p_cas(S& s, int t) {
  const int addr = op_addr(s, t, 0);
  const uint32_t v = s.exp[tk(s, t, 0)];
  const bool ok = ev_cas_word(s, t, addr, v << TAG_SHIFT,
                              ((v + 1u) << TAG_SHIFT) | TAG_DIRTY);
  if (!ok) cnt(s, t, CNT_FAILS) += 1;
  s.pc[t] = ok ? P_PERSIST : P_READ;
}

template <class S>
__device__ void br_p_persist(S& s, int t) {
  ev_persist_word(s, t, op_addr(s, t, 0));
  s.pc[t] = P_CLEAR;
}

template <class S>
__device__ void br_p_clear(S& s, int t) {
  const int addr = op_addr(s, t, 0);
  ev_store_word(s, t, addr, (s.exp[tk(s, t, 0)] + 1u) << TAG_SHIFT, true);
  s.success[t] = 1;
  s.pc[t] = OP_DONE;
}

// -- dispatch ------------------------------------------------------------------

// the branch a thread at PC pc runs
__device__ __forceinline__ int dispatch_pc(const Sim& s, int pc) {
  if (pc < 0) pc += PC_COUNT;        // the reference's gather: wrap once,
  pc = pc < 0 ? 0 : (pc >= PC_COUNT ? PC_COUNT - 1 : pc);   // then clamp
  return (s.reach >> pc) & 1ull ? pc : s.first;
}

// one step of thread t, whose PC dispatches to branch pc.  R holds the
// PCs pc can be: all of them, or one algorithm's (the smem route's
// schedule loop), whose other cases the compiler then drops.
#define PC_CASE(P, BRANCH)             \
  case P:                              \
    if constexpr ((R >> P) & 1ull) {   \
      BRANCH(s, t);                    \
      break;                           \
    } else {                           \
      __builtin_unreachable();         \
    }
template <unsigned long long R = ~0ull, class S>
__device__ __forceinline__ void step_at(S& s, int t, int pc) {
  switch (pc) {
    PC_CASE(READ_TGT, br_read_tgt)
    PC_CASE(READ_WAIT, br_read_wait)
    PC_CASE(RESERVE_WAIT, br_read_wait)
    PC_CASE(INIT_DESC, br_init_desc)
    PC_CASE(PERSIST_DESC, br_persist_desc)
    PC_CASE(RESERVE_TEST, br_reserve_test)
    PC_CASE(RESERVE_CAS, br_reserve_cas)
    PC_CASE(PERSIST_TGT, br_persist_tgt)
    PC_CASE(SET_SUCC, br_set_succ)
    PC_CASE(PERSIST_STATE, br_persist_state)
    PC_CASE(FIN_STORE_DIRTY, br_fin_store_dirty)
    PC_CASE(FIN_PERSIST_DIRTY, br_fin_persist_dirty)
    PC_CASE(FIN_STORE, br_fin_store)
    PC_CASE(FIN_PERSIST, br_fin_persist)
    PC_CASE(OP_DONE, br_op_done)
    PC_CASE(O_RDCSS_CAS, br_o_rdcss_cas)
    PC_CASE(O_PROMOTE_CAS, br_o_promote_cas)
    PC_CASE(O_PERSIST_TGT, br_o_persist_tgt)
    PC_CASE(O_CLEAR_TGT, br_o_clear_tgt)
    PC_CASE(O_STATUS_CAS, br_o_status_cas)
    PC_CASE(O_STATUS_PERSIST, br_o_status_persist)
    PC_CASE(O_STATUS_CLEAR, br_o_status_clear)
    PC_CASE(O_FIN_CAS, br_o_fin_cas)
    PC_CASE(O_FIN_PERSIST, br_o_fin_persist)
    PC_CASE(O_FIN_CLEAR, br_o_fin_clear)
    PC_CASE(H_TEST, br_h_test)
    PC_CASE(H_CAS, br_h_cas)
    PC_CASE(H_STATUS_CAS, br_h_status_cas)
    PC_CASE(H_FIN_CAS, br_h_fin_cas)
    PC_CASE(H_FIN_PERSIST, br_h_fin_persist)
    PC_CASE(H_FIN_CLEAR, br_h_fin_clear)
    PC_CASE(P_READ, br_p_read)
    PC_CASE(P_CAS, br_p_cas)
    PC_CASE(P_PERSIST, br_p_persist)
    default:                           // P_CLEAR
      if constexpr ((R >> P_CLEAR) & 1ull) {
        br_p_clear(s, t);
      } else {
        __builtin_unreachable();
      }
  }
}
#undef PC_CASE

template <class S>
__device__ void step(S& s, int t) {
  step_at(s, t, dispatch_pc(s, s.pc[t]));
}

// lane 0's steps over one stage of the schedule, for algorithm A: s's
// algorithm fields become constants, so the branches' tests of them fold
// and the switch's tree of compares covers only A's PCs
template <int A>
__device__ long long run_stage(const SimS& sim, const int32_t* stage,
                               int m) {
  SimS s = sim;
  s.alg = A;
  s.reach = reach_of(A);
  s.start = s.first = first_of(A);
  long long steps = 0;
  for (int i = 0; i < m; ++i) {
    const int tid = stage[i];          // negative entries are no-ops
    if (tid >= 0) {
      step_at<reach_of(A)>(s, tid, dispatch_pc(s, s.pc[tid]));
      ++steps;
    }
  }
  return steps;
}

template <class S>
__device__ bool in_read_phase(const S& s, int t) {
  const int pc = s.pc[t];
  return s.alg == ALG_PCAS ? pc == P_READ
                           : (pc == READ_TGT || pc == READ_WAIT);
}

// the drain: rounds over the non-clean threads, each tested at its own
// turn, until all are clean; returns the rounds
template <class S>
__device__ long long drain(S& s, long long& steps) {
  long long rounds = 0;
  while (rounds < kMaxDrainRounds) {
    bool all_clean = true;
    for (int t = 0; t < s.T && all_clean; ++t) all_clean = clean(s, t);
    if (all_clean) break;
    for (int t = 0; t < s.T; ++t) {
      if (!clean(s, t)) {
        step(s, t);
        ++steps;
      }
    }
    ++rounds;
  }
  return rounds;
}

// SimBackend's two phases; returns 0, or the error of the phase whose
// thread err_t took more than cap steps (the simulation stops there)
template <class S>
__device__ int backend(S& s, long long cap, long long& steps, int& err_t) {
  for (int phase = 0; phase < 2; ++phase) {
    for (int t = 0; t < s.T; ++t) {
      long long n_steps = 0;
      while (phase == 0 ? in_read_phase(s, t)
                        : (s.op_idx[t] < 1 && cnt(s, t, CNT_FAILS) < 1)) {
        step(s, t);
        ++steps;
        if (++n_steps > cap) {
          err_t = t;
          return phase == 0 ? ERR_READ_PHASE : ERR_ATTEMPT;
        }
      }
    }
  }
  return 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__device__ __forceinline__ const int32_t* schedule(const long long* r) {
  return reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(r[R_SCHED]));
}

__device__ __forceinline__ long long sched_limit(const long long* r) {
  return r[R_NSCHED] < r[R_CUT] ? r[R_NSCHED] : r[R_CUT];
}

// -- the global route ---------------------------------------------------------

__global__ void __launch_bounds__(32)
pmwcas_sim_kernel(const long long* rec, long long* out, int n) {
  const int sim = blockIdx.x;
  if (sim >= n || threadIdx.x != 0) return;
  const unsigned long long t0 = globaltimer();
  const long long* r = rec + static_cast<long long>(sim) * R_LEN;
  long long* o = out + static_cast<long long>(sim) * OUT_LEN;
  Sim s;
  load_sim(s, r);
  long long steps = 0;
  if (r[R_MODE] == MODE_SCHEDULE) {
    const int32_t* sched = schedule(r);
    const long long lim = sched_limit(r);
    for (long long i = 0; i < lim; ++i) {
      const int tid = sched[i];      // negative entries are no-ops
      if (tid >= 0) {
        step(s, tid);
        ++steps;
      }
    }
    o[O_ROUNDS] = r[R_DRAIN] ? drain(s, steps) : 0;
  } else if (r[R_MODE] == MODE_BACKEND) {   // SimBackend's two phases
    int err_t = 0;
    const int err = backend(s, r[R_CAP], steps, err_t);
    if (err) {
      o[O_ERR] = err;
      o[O_ERR_THREAD] = err_t;
    }
  }
  o[O_STEPS] = steps;
  o[O_NS] = static_cast<long long>(globaltimer() - t0);
}

// -- the smem route -----------------------------------------------------------

// [T] int32 fields, [T, k] fields, [T] bool fields the route moves
constexpr int N_T32 = 15, N_TK = 7, N_T8 = 2;

// Shared memory of one simulation, in layout order: the schedule's two
// stages, the counters, the [T] int32 fields, the [T, k] fields, the
// descriptor lines' owners, the staged ops (addresses, desired values),
// the [T] bool fields.  kernels/pmwcas_sim/kernel.py::smem_bytes counts
// the same.
__host__ __device__ inline long long smem_bytes(int T, int k, int dl) {
  return 2LL * SCHED_CHUNK * 4 +
         static_cast<long long>(T) * (8 * N_COUNTERS + 4 * N_T32 +
                                      4 * N_TK * k + 4 * dl + 8 * k + N_T8);
}

// s: g's scalars and device pointers, its per-thread fields re-pointed
// into smem (the layout above)
__device__ void bind_smem(SimS& s, const Sim& g, unsigned char* smem) {
  static_cast<Sim&>(s) = g;
  const long long T = g.T, Tk = static_cast<long long>(g.T) * g.k;
  unsigned char* p = smem + 2 * SCHED_CHUNK * 4;
  auto take = [&p](long long bytes) {
    unsigned char* q = p;
    p += bytes;
    return q;
  };
  s.cnt = reinterpret_cast<long long*>(take(8 * N_COUNTERS * T));
  auto t32 = [&take, T]() {
    return reinterpret_cast<int32_t*>(take(4 * T));
  };
  s.d_state = t32();                   // the N_T32 [T] int32 fields
  s.d_state_p = t32();
  s.d_state_dirty = t32();
  s.d_ver = t32();
  s.d_ver_p = t32();
  s.pc = t32();
  s.op_idx = t32();
  s.tgt_idx = t32();
  s.backoff = t32();
  s.backoff_exp = t32();
  s.help_desc = t32();
  s.help_tgt = t32();
  s.ret_pc = t32();
  s.ref_cache = t32();
  s.ref_pmem = t32();
  s.d_addr = reinterpret_cast<int32_t*>(take(4 * Tk));
  s.d_exp = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.d_des = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.d_addr_p = reinterpret_cast<int32_t*>(take(4 * Tk));
  s.d_exp_p = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.d_des_p = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.exp = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.lo_d = reinterpret_cast<int32_t*>(take(4 * T * g.dl));
  s.op_a = reinterpret_cast<int32_t*>(take(4 * Tk));
  s.op_d = reinterpret_cast<uint32_t*>(take(4 * Tk));
  s.success = take(T);
  s.help_ok = take(T);
  s.wpl_shift = __popc(g.wpl) == 1 ? __ffs(g.wpl) - 1 : -1;
  s.t_magic = ~0ull / static_cast<unsigned>(g.T) + 1;
  s.ops_magic = ~0ull / static_cast<unsigned>(g.max_ops) + 1;
}

template <typename E>
__device__ __forceinline__ void move_field(E* sh, E* gl, long long n, bool in,
                                     int lane) {
  if (in) {
    for (long long i = lane; i < n; i += 32) sh[i] = gl[i];
  } else {
    for (long long i = lane; i < n; i += 32) gl[i] = sh[i];
  }
}

// every field the route keeps in shared memory, between its shared copy
// (s) and its tensor (g): in at entry, back at the end; all lanes
__device__ void move_state(const SimS& s, const Sim& g, bool in, int lane) {
  const long long T = s.T, Tk = static_cast<long long>(s.T) * s.k;
  move_field(s.cnt, g.cnt, T * N_COUNTERS, in, lane);
  move_field(s.d_state, g.d_state, T, in, lane);
  move_field(s.d_state_p, g.d_state_p, T, in, lane);
  move_field(s.d_state_dirty, g.d_state_dirty, T, in, lane);
  move_field(s.d_ver, g.d_ver, T, in, lane);
  move_field(s.d_ver_p, g.d_ver_p, T, in, lane);
  move_field(s.pc, g.pc, T, in, lane);
  move_field(s.op_idx, g.op_idx, T, in, lane);
  move_field(s.tgt_idx, g.tgt_idx, T, in, lane);
  move_field(s.backoff, g.backoff, T, in, lane);
  move_field(s.backoff_exp, g.backoff_exp, T, in, lane);
  move_field(s.help_desc, g.help_desc, T, in, lane);
  move_field(s.help_tgt, g.help_tgt, T, in, lane);
  move_field(s.ret_pc, g.ret_pc, T, in, lane);
  move_field(s.ref_cache, g.ref_cache, T, in, lane);
  move_field(s.ref_pmem, g.ref_pmem, T, in, lane);
  move_field(s.d_addr, g.d_addr, Tk, in, lane);
  move_field(s.d_exp, g.d_exp, Tk, in, lane);
  move_field(s.d_des, g.d_des, Tk, in, lane);
  move_field(s.d_addr_p, g.d_addr_p, Tk, in, lane);
  move_field(s.d_exp_p, g.d_exp_p, Tk, in, lane);
  move_field(s.d_des_p, g.d_des_p, Tk, in, lane);
  move_field(s.exp, g.exp, Tk, in, lane);
  move_field(s.lo_d, g.lo + g.nwl, T * g.dl, in, lane);
  move_field(s.success, g.success, T, in, lane);
  move_field(s.help_ok, g.help_ok, T, in, lane);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// this lane's share of schedule entries [base, base + SCHED_CHUNK) below
// lim into a stage, as one cp.async group
__device__ void fetch_stage(int32_t* stage, const int32_t* sched,
                            long long base, long long lim, int lane) {
  for (int i = lane; i < SCHED_CHUNK && base + i < lim; i += 32)
    cp_async4(stage + i, sched + base + i);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32)
pmwcas_sim_smem_kernel(const long long* rec, long long* out, int n,
                       long long avail) {
  const int sim = blockIdx.x;
  if (sim >= n) return;
  const int lane = threadIdx.x;
  const unsigned long long t0 = globaltimer();
  const long long* r = rec + static_cast<long long>(sim) * R_LEN;
  long long* o = out + static_cast<long long>(sim) * OUT_LEN;
  Sim g;
  load_sim(g, r);
  if (smem_bytes(g.T, g.k, g.dl) > avail) {   // refused: nothing ran
    if (lane == 0) o[O_ERR] = ERR_SMEM;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  SimS s;
  bind_smem(s, g, smem);
  move_state(s, g, true, lane);
  __syncwarp();
  for (int t = lane; t < s.T; t += 32) stage_op(s, t);
  __syncwarp();
  long long steps = 0, rounds = 0;
  int err = 0, err_t = 0;
  if (r[R_MODE] == MODE_SCHEDULE) {
    // stage c + 1 lands while lane 0 steps stage c
    const int32_t* sched = schedule(r);
    const long long lim = sched_limit(r);
    int32_t* stages = reinterpret_cast<int32_t*>(smem);
    const long long n_stages =
        lim > 0 ? (lim + SCHED_CHUNK - 1) / SCHED_CHUNK : 0;
    if (n_stages > 0) fetch_stage(stages, sched, 0, lim, lane);
    for (long long c = 0; c < n_stages; ++c) {
      if (c + 1 < n_stages) {
        fetch_stage(stages + ((c + 1) & 1) * SCHED_CHUNK, sched,
                    (c + 1) * SCHED_CHUNK, lim, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();                    // every lane's share of stage c
      if (lane == 0) {
        const int32_t* stage = stages + (c & 1) * SCHED_CHUNK;
        const long long rest = lim - c * SCHED_CHUNK;
        const int m = rest < SCHED_CHUNK ? static_cast<int>(rest)
                                         : SCHED_CHUNK;
        switch (s.alg) {
          case ALG_OURS: steps += run_stage<ALG_OURS>(s, stage, m); break;
          case ALG_OURS_DF:
            steps += run_stage<ALG_OURS_DF>(s, stage, m);
            break;
          case ALG_ORIGINAL:
            steps += run_stage<ALG_ORIGINAL>(s, stage, m);
            break;
          default: steps += run_stage<ALG_PCAS>(s, stage, m); break;
        }
      }
      __syncwarp();                    // stage c is free for c + 2
    }
    if (lane == 0 && r[R_DRAIN]) rounds = drain(s, steps);
  } else if (r[R_MODE] == MODE_BACKEND) {
    if (lane == 0) err = backend(s, r[R_CAP], steps, err_t);
  }
  __syncwarp();
  move_state(s, g, false, lane);       // an error stops here too
  if (lane == 0) {
    o[O_ROUNDS] = rounds;
    if (err) {
      o[O_ERR] = err;
      o[O_ERR_THREAD] = err_t;
    }
    o[O_STEPS] = steps;
    o[O_NS] = static_cast<long long>(globaltimer() - t0);
  }
}

}  // namespace

// rec int64[n, R_LEN], out int64[n, OUT_LEN] (zeroed by the caller); one
// block of one warp per simulation.  Each returns cudaGetLastError().
// The global route:
extern "C" int pmwcas_sim_launch(const void* rec, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  pmwcas_sim_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rec), static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// the smem route, with smem bytes of dynamic shared memory a block (at
// least pmwcas_sim_smem_bytes of every simulation's geometry).  The SM's
// split between shared memory and L1 is set to what the launch's blocks
// need at once (n over the SMs, each with the 1 KB the system reserves a
// block) and no more: the rest is L1, where the words are cached.
extern "C" int pmwcas_sim_smem_launch(const void* rec, void* out, int n,
                                      long long smem, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pmwcas_sim_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess) {
    const long long resident = (n + sms - 1) / sms;
    const long long want = resident * (smem + 1024) * 100;
    const long long pct = (want + per_sm - 1) / per_sm;
    err = cudaFuncSetAttribute(
        pmwcas_sim_smem_kernel,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(pct < 100 ? pct : 100));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  pmwcas_sim_smem_kernel<<<n, 32, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rec), static_cast<long long*>(out), n,
      smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long pmwcas_sim_smem_bytes(int T, int k, int dl) {
  return smem_bytes(T, k, dl);
}

extern "C" int pmwcas_sim_rec_len() { return R_LEN; }

extern "C" int pmwcas_sim_out_len() { return OUT_LEN; }

extern "C" const char* pmwcas_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
