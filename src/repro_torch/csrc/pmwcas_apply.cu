// Batched deterministic MwCAS: verdict and in-place apply, for Hopper (sm_90a).
//
// Replaces the TPU kernel pmwcas_success_pallas
// (src/repro/kernels/pmwcas_apply/kernel.py:62, body _kernel :25) together
// with the XLA gather and scatter around it (ops.py:24-34) and the vmap over
// shards (ops.py:39-59): ONE launch resolves every shard's round and writes
// the winners' desired values into the word tables in place.
//
// Semantics ("conservative one-shot", DESIGN.md Sec. 2.2).  Row i of shard s
// wins iff
//   (a) every valid slot (addr >= 0) holds words[s, addr] == exp, and
//   (b) no lower-index row j < i that passes (a) shares a valid address
//       with row i.
// A row that passes (a) and loses still blocks later rows.  A row's
// duplicate ids never block the row itself, a winning row with duplicate
// ids keeps the LAST slot's des, and an all-padded row wins vacuously.
//
// Both routes take (b) order-free in O(B*K): every (a)-passing row
// atomicMin's its index into a claim per address, and a passing row loses
// iff one of its addresses holds a claim < i.  (The TPU kernel compares
// all (B*K)^2 slot pairs instead.)  One CTA per shard, one thread per row
// in the row phases.  The Python plan (kernels/pmwcas_apply/kernel.py::
// plan) picks the route from [B, K]:
//
// smem (pmwcas_apply_smem_kernel) -- every round of at most 16 slots a row
// and 1024 / ceil(K / 4) rows (the service's waves, [4, 1024, 2], and
// serve's page grants, [1, 128, 9]): one thread per row, the row's slots
// in registers, and the claims in shared memory, so the kernel needs no
// global scratch and no reset pass.  It takes three dependent trips to
// device memory:
//   1. the row's addr/exp/des slots (neighbouring rows on neighbouring
//      addresses), all loads issued together;
//   2. the gather cur = words[s, addr] of the valid slots, and (a);
//   -- in shared memory: only (a)-passing rows can block, so only their
//      slots take part.  Each stores its slot id into a 2^16-bucket tag
//      table (plain stores, the last one stays); __syncthreads; a slot
//      that reads another slot's id marks the bucket contested;
//      __syncthreads_or.  A slot alone in its tag bucket shares its
//      address with no other passing slot, so it needs no claim.  Only
//      if some bucket is contested, the CTA clears an open-addressing hash
//      of at least 2 * B * K entries (load factor <= 1/2, should every
//      slot be contested), and each slot of a contested bucket inserts
//      its address (atomicCAS, linear probing) and atomicMin's its row
//      into the address's claim; __syncthreads.  This keeps most slots
//      off the shared-memory atomics, which took 4 of 9.6 us at
//      [4, 1024, 2] on an H100 when every slot went through them
//      (PERF.md section 6);
//   3. a passing row loses iff one of its claimed slots reads a claim
//      < i; the row stores its success byte, and a winner stores des in
//      place in slot order (stores, not waited on).
// Slots k, k + 1 (k even) that name neighbouring words on an 8-byte
// boundary -- a hash map bucket's key guard and value -- are gathered and
// stored with one 8-byte access.

// global (pmwcas_apply_kernel, the kernel's first design) -- larger rounds:
// the claims are a caller-owned int32[S, W] table in device memory, all
// INT_MAX on entry and on exit (every valid slot resets its claim).
//
// What bounds it on an H100: latency.  The bytes (a round's slots, its
// gathered words and the verdict: 0.17 MB at [4, 1024, 2]) take 0.05 us at
// 3.35 TB/s, far below one launch plus three dependent trips to memory;
// the design spends one launch per service wave for all S shards, touches
// only the round's words, and keeps every other step on chip.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;                // a free key: addresses are >= 0
constexpr unsigned kHashMult = 2654435761u;  // Knuth's multiplicative constant
constexpr int kMaxThreads = 1024;

// The smem route's rows (threads) a CTA takes at kmax slots a row.
__host__ __device__ constexpr int smem_rows(int kmax) {
  return kmax <= 4 ? kMaxThreads : 4096 / kmax;
}

// Bytes of the smem route's dynamic shared memory: keys and claims
// [1 << cap_bits] (4 bytes each), then tag[1 << tag_bits] (2 bytes).
// kernel.py::smem_bytes is the same formula.
long long smem_layout_bytes(int tag_bits, int cap_bits) {
  return 8 * (1LL << cap_bits) + 2 * (1LL << tag_bits);
}

constexpr unsigned short kContested = 0xFFFF;   // a tag no slot id takes

__device__ __forceinline__ int bucket(int a, int bits) {
  return static_cast<int>((static_cast<unsigned>(a) * kHashMult) >>
                          (32 - bits));
}

// Slots k and k + 1 name neighbouring words on an 8-byte boundary (a hash
// map bucket's key guard and value): one 8-byte access serves both.
__device__ __forceinline__ bool paired(const int32_t* w, int a0, int a1) {
  return a0 >= 0 && a1 == a0 + 1 &&
         (reinterpret_cast<uintptr_t>(w + a0) & 7) == 0;
}

template <int KMAX>
__global__ void __launch_bounds__(smem_rows(KMAX))
pmwcas_apply_smem_kernel(int32_t* __restrict__ words,
                         const int32_t* __restrict__ addr,
                         const int32_t* __restrict__ exp,
                         const int32_t* __restrict__ des,
                         uint8_t* __restrict__ success, int B, int K,
                         long long W, int tag_bits, int cap_bits) {
  extern __shared__ int4 smem_raw[];
  const int ca = 1 << cap_bits;
  int* keys = reinterpret_cast<int*>(smem_raw);
  int* claim = keys + ca;
  auto* tag = reinterpret_cast<unsigned short*>(claim + ca);

  const int i = threadIdx.x;                    // this thread's row
  const bool live = i < B;
  const long long s = blockIdx.x;
  int32_t* w = words + s * W;
  const long long base = (s * B + i) * static_cast<long long>(K);

  // trip 1: the row's slots
  int a[KMAX], e[KMAX], d[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const bool valid = live && k < K;
    a[k] = valid ? __ldg(addr + base + k) : kEmpty;
    e[k] = valid ? __ldg(exp + base + k) : 0;
    d[k] = valid ? __ldg(des + base + k) : 0;
  }

  // trip 2: the gather and condition (a)
  int cur[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; k += 2) {
    if (k + 1 < KMAX && paired(w, a[k], a[k + 1])) {
      const int2 v = *reinterpret_cast<const int2*>(w + a[k]);
      cur[k] = v.x;
      cur[k + 1] = v.y;
    } else {
      cur[k] = a[k] >= 0 ? w[a[k]] : e[k];
      if (k + 1 < KMAX) cur[k + 1] = a[k + 1] >= 0 ? w[a[k + 1]] : e[k + 1];
    }
  }
  bool pass = live;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) pass = pass && cur[k] == e[k];

  // the valid slots of a passing row tag their buckets
  int h[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    h[k] = pass && a[k] >= 0 ? bucket(a[k], tag_bits) : -1;
    if (h[k] >= 0) tag[h[k]] = static_cast<unsigned short>(i * K + k);
  }
  __syncthreads();
  // a slot that reads another slot's tag marks the bucket contested
  bool other = false;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (h[k] >= 0 && tag[h[k]] != i * K + k) {
      tag[h[k]] = kContested;
      other = true;
    }
  }
  const bool any_contested = __syncthreads_or(other);
  if (any_contested) {
    // slots of contested buckets claim their address with the row's index
    for (int j = i; j < ca; j += blockDim.x) {
      keys[j] = kEmpty;
      claim[j] = INT_MAX;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      int q = -1;
      if (h[k] >= 0 && tag[h[k]] != i * K + k) {
        q = bucket(a[k], cap_bits);
        for (;;) {
          const int prev = atomicCAS(&keys[q], kEmpty, a[k]);
          if (prev == kEmpty || prev == a[k]) break;
          q = (q + 1) & (ca - 1);
        }
        atomicMin(&claim[q], i);
      }
      h[k] = q;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) h[k] = -1;
  }

  // trip 3: condition (b), the verdict, and the winners' des in slot order
  if (!live) return;
  bool win = pass;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (h[k] >= 0 && claim[h[k]] < i) win = false;
  }
  success[s * B + i] = win ? 1 : 0;
  if (!win) return;
#pragma unroll
  for (int k = 0; k < KMAX; k += 2) {
    if (k + 1 < KMAX && paired(w, a[k], a[k + 1])) {
      *reinterpret_cast<int2*>(w + a[k]) = make_int2(d[k], d[k + 1]);
    } else {
      if (a[k] >= 0) w[a[k]] = d[k];
      if (k + 1 < KMAX && a[k + 1] >= 0) w[a[k + 1]] = d[k + 1];
    }
  }
}

template <int KMAX>
int launch_smem(int32_t* words, const int32_t* addr, const int32_t* exp,
                const int32_t* des, uint8_t* success, int S, int B, int K,
                long long W, int tag_bits, int cap_bits,
                cudaStream_t stream) {
  const long long bytes = smem_layout_bytes(tag_bits, cap_bits);
  // the attribute is per device; raise it once to the largest size asked
  static long long configured[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > 48 * 1024 && (device >= 64 || bytes > configured[device])) {
    err = cudaFuncSetAttribute(pmwcas_apply_smem_kernel<KMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) configured[device] = bytes;
  }
  const int threads = ((B + 31) / 32) * 32;
  pmwcas_apply_smem_kernel<KMAX><<<S, threads, bytes, stream>>>(
      words, addr, exp, des, success, B, K, W, tag_bits, cap_bits);
  return static_cast<int>(cudaGetLastError());
}

__global__ void pmwcas_apply_kernel(int32_t* __restrict__ words,
                                    const int32_t* __restrict__ addr,
                                    const int32_t* __restrict__ exp,
                                    const int32_t* __restrict__ des,
                                    int32_t* __restrict__ claim,
                                    uint8_t* __restrict__ success,
                                    int B, int K, long long W) {
  const long long s = blockIdx.x;
  int32_t* w = words + s * W;
  int32_t* c = claim + s * W;
  const long long row0 = s * static_cast<long long>(B);

  // phase 1: condition (a), then claim every valid address
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const long long base = (row0 + i) * K;
    bool pass = true;
    for (int k = 0; k < K; ++k) {
      const int a = addr[base + k];
      if (a >= 0 && w[a] != exp[base + k]) pass = false;
    }
    if (pass) {
      for (int k = 0; k < K; ++k) {
        const int a = addr[base + k];
        if (a >= 0) atomicMin(&c[a], i);
      }
    }
    success[row0 + i] = pass ? 1 : 0;
  }
  __syncthreads();

  // phase 2: condition (b) -- a lower passing row claimed one of our words
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    if (!success[row0 + i]) continue;
    const long long base = (row0 + i) * K;
    for (int k = 0; k < K; ++k) {
      const int a = addr[base + k];
      if (a >= 0 && __ldcg(&c[a]) < i) {
        success[row0 + i] = 0;
        break;
      }
    }
  }
  __syncthreads();

  // phase 3: winners scatter des; every valid slot clears its claim
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const bool win = success[row0 + i] != 0;
    const long long base = (row0 + i) * K;
    for (int k = 0; k < K; ++k) {
      const int a = addr[base + k];
      if (a < 0) continue;
      if (win) w[a] = des[base + k];
      c[a] = INT_MAX;
    }
  }
}

// One thread follows `trips` dependent 4-byte loads through `chain`: the
// device time of an empty launch (trips = 0) and of the smem route's three
// dependent trips to memory with nothing else (trips = 3).
__global__ void pmwcas_latency_probe_kernel(const int32_t* chain,
                                            int32_t* out, int trips) {
  int i = 0;
  for (int t = 0; t < trips; ++t) i = __ldcg(chain + i);
  out[0] = i;
}

int threads_for(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

}  // namespace

// The smem route: words int32[S, W] (updated in place), addr/exp/des
// int32[S, B, K], success uint8[S, B]; the tag table holds 1 << tag_bits
// buckets (at most 2^16) and the hash 1 << cap_bits keys (at least
// 2 * B * K).  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a round the route does not take.
extern "C" int pmwcas_apply_smem_launch(void* words, const void* addr,
                                        const void* exp, const void* des,
                                        void* success, int S, int B, int K,
                                        long long W, int tag_bits,
                                        int cap_bits, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  const int kmax = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : 16;
  if (K < 1 || K > 16 || B > smem_rows(kmax) || tag_bits < 1 ||
      tag_bits > 16 || cap_bits < 1 || cap_bits > 30 ||
      (1LL << cap_bits) < 2LL * B * K || B * K >= kContested)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* w = static_cast<int32_t*>(words);
  auto* a = static_cast<const int32_t*>(addr);
  auto* e = static_cast<const int32_t*>(exp);
  auto* d = static_cast<const int32_t*>(des);
  auto* ok = static_cast<uint8_t*>(success);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kmax) {
    case 1: return launch_smem<1>(w, a, e, d, ok, S, B, K, W, tag_bits,
                                  cap_bits, st);
    case 2: return launch_smem<2>(w, a, e, d, ok, S, B, K, W, tag_bits,
                                  cap_bits, st);
    case 4: return launch_smem<4>(w, a, e, d, ok, S, B, K, W, tag_bits,
                                  cap_bits, st);
    case 8: return launch_smem<8>(w, a, e, d, ok, S, B, K, W, tag_bits,
                                  cap_bits, st);
    default: return launch_smem<16>(w, a, e, d, ok, S, B, K, W, tag_bits,
                                    cap_bits, st);
  }
}

// The smem route's dynamic shared memory for its tables, in bytes.
extern "C" long long pmwcas_smem_bytes(int tag_bits, int cap_bits) {
  return smem_layout_bytes(tag_bits, cap_bits);
}

// The global route: words int32[S, W] (updated in place), addr/exp/des
// int32[S, B, K], claim int32[S, W] (all INT_MAX on entry and on exit),
// success uint8[S, B].  Launches on `stream`; returns cudaGetLastError().
extern "C" int pmwcas_apply_launch(void* words, const void* addr,
                                   const void* exp, const void* des,
                                   void* claim, void* success, int S, int B,
                                   int K, long long W, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  pmwcas_apply_kernel<<<S, threads_for(B), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(words), static_cast<const int32_t*>(addr),
      static_cast<const int32_t*>(exp), static_cast<const int32_t*>(des),
      static_cast<int32_t*>(claim), static_cast<uint8_t*>(success), B, K, W);
  return static_cast<int>(cudaGetLastError());
}

// The latency probe: chain int32[N] of indices into itself, out int32[1].
extern "C" int pmwcas_latency_probe_launch(const void* chain, void* out,
                                           int trips, void* stream) {
  pmwcas_latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chain), static_cast<int32_t*>(out), trips);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pmwcas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
