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
// A row that passes (a) and loses still blocks later rows.
//
// Design: one CTA per shard, one thread per row (rows strided over the
// block), three phases split by __syncthreads():
//   1. gather cur and decide (a); every passing row atomicMin's its own
//      index into claim[s, addr] for each valid slot;
//   2. a passing row loses iff one of its valid slots reads claim < i.
//      claim[s, addr] is the lowest (a)-passing row on that address, so
//      this is (b) exactly, order-free, in O(B*K) -- the TPU kernel
//      compares all (B*K)^2 slot pairs instead.  A row's duplicate ids
//      claim its own index and never block the row itself;
//   3. winners write des in slot order (a duplicate id keeps the LAST
//      slot's des), and every valid slot resets claim to INT_MAX, so the
//      scratch is all INT_MAX again for the next launch.
//
// What bounds it on an H100: launch latency, then B*K dependent random
// 4-byte gathers and atomics into tables far larger than one round.  The
// design pays one launch per service wave for all S shards and touches
// only the round's words, never the whole [S, W] table; the scratch
// claim table is allocated once by the caller, so the kernel allocates
// nothing.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

}  // namespace

// words int32[S, W] (updated in place), addr/exp/des int32[S, B, K],
// claim int32[S, W] (all INT_MAX on entry and on exit), success
// uint8[S, B].  Launches on `stream`; returns cudaGetLastError().
extern "C" int pmwcas_apply_launch(void* words, const void* addr,
                                   const void* exp, const void* des,
                                   void* claim, void* success, int S, int B,
                                   int K, long long W, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  int threads = ((B + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  pmwcas_apply_kernel<<<S, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(words), static_cast<const int32_t*>(addr),
      static_cast<const int32_t*>(exp), static_cast<const int32_t*>(des),
      static_cast<int32_t*>(claim), static_cast<uint8_t*>(success), B, K, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pmwcas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
