// Forward flash attention on Hopper's tensor cores: the bf16 prefill route.
//
// Replaces the TPU kernel flash_attention_flat
// (src/repro/kernels/flash_attention/kernel.py:73, body _kernel :26) for
// bf16 calls whose GQA group brings more than 16 q rows to a kv head and
// whose head_dim is 64, 128 or 256 (llama3, glm4 and qwen1.5 at 128,
// gemma2 at 256).  The route plan is in
// src/repro_torch/kernels/flash_attention/kernel.py (plan()); f32 calls and
// other head dims go to flash_attention.cu, single-token decode to
// flash_attention_decode.cu.  Semantics are those of flash_attention.cu:
//   s   = q . k^T * scale, then tanh(s / cap) * cap when attn_cap > 0
//   ok  = k_pos < 2**29 && (!causal || q_pos >= k_pos)
//         && (window <= 0 || q_pos - k_pos < window)
//   out = softmax over the ok keys of s, times v (kv head h // g); masked
//         keys get p = 0; a row with no visible key gets the mean of v
//         over the Sk keys; the output is bf16;
//   lse = m + log(l) in natural log, f32, when the caller passes an lse
//         pointer (the training forward's second output); NEG_INF +
//         log(Sk) for a row with no visible key.  A null pointer writes
//         nothing, and the serving launches pass one.
//
// What bounds it on an H100: a causal prefill does 4*hd flops per visible
// (q, k) pair, so the bound is the bf16 tensor-core rate (989 TFLOP/s),
// far above the bytes.  Only wgmma reaches that rate, fed from shared
// memory by TMA while other warps compute.  The design is FA-3 shaped:
//   - one CTA per (kv head, 128 packed q rows): q is read as
//     [HK, g*Sq, hd] (the g heads of a kv head are contiguous in the flat
//     layout), so one K/V tile serves all g heads;
//   - three warpgroups.  The producer (setmaxnreg down to 40) issues TMA
//     loads of the Q tile once and of K/V tiles into a ring guarded by
//     full/empty mbarriers, K and V released separately: 3 stages of 128
//     keys at hd <= 128, 2 stages of 64 keys at hd 256, so that Q and the
//     ring fit in 227 KB.  Two consumer warpgroups (setmaxnreg up to 232)
//     own 64 q rows each;
//   - S = Q . K^T by wgmma.m64n{BK}k16 with both operands in shared
//     memory (K-major); softcap, mask and the online softmax run on the
//     f32 accumulator fragment in registers, in the log2 domain; the mask
//     is applied only on tiles that straddle the causal diagonal, the
//     window edge, an invalid key or Sk;
//   - P goes to bf16 in registers and is the A operand of
//     wgmma.m64n{hd}k16 for P . V; V is the B operand read from shared
//     memory MN-major (the transpose bit), so V needs no transpose;
//   - the softmax hides behind the tensor cores twice over: P . V of tile
//     j is issued beside S of tile j + 1, so a consumer's softmax of tile
//     j + 1 overlaps its own P . V of tile j; and the two consumers take
//     turns at issuing their products (ping-pong on named barriers), so
//     one's softmax runs while the other's products hold the tensor cores;
//   - epilogue: divide by l; rows with l == 0 take the column mean of v
//     (one extra pass over the kv head, only when such a row exists);
//     only rows < g*Sq are stored.  The softmax keeps m in the scores'
//     own units and l as a sum of powers of two, so the log-sum-exp goes
//     back to natural log: m * (f * ln 2) + ln l, where f * ln 2 is the
//     scale (or 1 after a softcap, which applies the scale itself);
//   - CTAs that run together share a kv head (blockIdx.y), so K/V tiles
//     are read from HBM about once and then from L2; inside a head the q
//     tiles with the largest positions go first (causal load balance).
// Hazards the design handles:
//   - TMA descriptors are 3-D ([HK, g*Sq, hd], [HK, Sk, hd]) so that a
//     ragged last tile zero-fills inside its own head: a 2-D view would
//     read the next head's keys (Sk = 2080 is 16 * 128 + 32) or run past
//     the allocation at the last head;
//   - the 128-byte swizzle caps a box's inner extent at 64 bf16, so a
//     128- or 256-wide head loads as 64-column slabs of 128-byte rows and
//     the wgmma descriptors walk the same slabs (K-major: +32 bytes per
//     k16 step inside a slab; MN-major V: slab stride as the leading byte
//     offset, 1024 bytes between 8-key groups);
//   - cuTensorMapEncodeTiled is a driver function: it is reached through
//     cudaGetDriverEntryPoint, so the library links nothing beyond the
//     runtime;
//   - tiles are skipped by position, not by index: positions are arbitrary
//     float tensors, so the producer warp and every consumer warp evaluate
//     the same skip predicate from k_pos and agree on the tile sequence
//     without talking;
//   - wgmma reads its register operands asynchronously: accumulators and P
//     are fenced as operands after each wait so the compiler neither reads
//     nor reuses them early;
//   - ptxas serializes every wgmma (a wait after each) when one sits behind
//     a branch it cannot prove warp-uniform: the warpgroup role and the
//     skip predicate are broadcast from lane 0 (__shfl_sync) for that.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1048576.0f;     // -2**20, the reference's mask fill
constexpr float kPosLimit = 536870912.0f;  // 2**29: keys at or above are invalid
constexpr float kPadPos = 1073741824.0f;   // 2**30: past Sk
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;                   // q rows per CTA
constexpr int kThreads = 384;              // producer + two consumer warpgroups
constexpr int kSlabBytes = 128;            // one swizzled row: 64 bf16

template <int HD>
struct TcShape {
  static constexpr int kBK = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int kStages = HD == 256 ? 2 : 3;   // K/V ring depth
  static constexpr int kSlabs = HD / 64;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;       // one K or V tile
  static constexpr int kExtra = 160 + 2 * HD * 4;     // barriers, flags, v means
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + kExtra;
};

// ---- shared memory, mbarriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Named barriers: 1 and 2 are each consumer's own (epilogue); 3 and 4 hand
// the tensor cores from one consumer to the other (ping-pong).
constexpr int kTurnBarrier = 3;

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers that an asynchronous wgmma reads or writes where they are.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[32] (+)= A (shared, K-major) . B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A (shared, K-major) . B (shared, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (registers, bf16x2) . B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers, bf16x2) . B (shared, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A (registers, bf16x2) . B (shared, MN-major), m64n256k16
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
}

// 2**x by the SFU (ex2.approx: about 2 ulp; 2**-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the skip predicate -------------------------------------------------------

struct TileInfo {
  float kmin, kmax;   // over the tile's valid keys (kmin > kmax: none)
  bool any_invalid;   // a key past Sk or at a position >= 2**29
};

// The positions of this lane's keys of tile kt (past Sk: the pad).  Loaded
// a tile ahead, so their latency hides behind the current tile.
template <int BK>
struct TilePos {
  float kp[BK / 32];
};

template <int BK>
__device__ __forceinline__ TilePos<BK> load_tile_pos(
    const float* __restrict__ k_pos, int Sk, int kt, int lane) {
  TilePos<BK> p;
#pragma unroll
  for (int i = 0; i < BK / 32; ++i) {
    const int key = kt * BK + lane + 32 * i;
    p.kp[i] = key < Sk ? __ldg(k_pos + key) : kPadPos;
  }
  return p;
}

// Warp-collective: every lane returns the same answer for the tile.
template <int BK>
__device__ __forceinline__ TileInfo tile_info(const TilePos<BK>& p) {
  float kmin = 3.0e38f, kmax = -3.0e38f;
  int bad = 0;
#pragma unroll
  for (int i = 0; i < BK / 32; ++i) {
    const float kp = p.kp[i];
    if (kp < kPosLimit) {
      kmin = fminf(kmin, kp);
      kmax = fmaxf(kmax, kp);
    } else {
      bad = 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kmin = fminf(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
  }
  return TileInfo{kmin, kmax, __any_sync(0xffffffffu, bad) != 0};
}

// Broadcast from lane 0, so that the compiler sees the answer is the same in
// every lane: wgmma behind a branch it cannot prove uniform is serialized.
__device__ __forceinline__ bool skip_tile(const TileInfo& t, float qmin,
                                          float qmax, int causal,
                                          int window) {
  const bool skip = t.kmin > t.kmax || (causal && t.kmin > qmax) ||
                    (window > 0 && qmin - t.kmax >= static_cast<float>(window));
  return __shfl_sync(0xffffffffu, static_cast<int>(skip), 0) != 0;
}

// Range of q positions over rows [r0, r0 + n) that are < R (warp-collective).
__device__ __forceinline__ void q_range(const float* __restrict__ q_pos,
                                        long long r0, int n, long long R,
                                        int Sq, int lane, float* qmin,
                                        float* qmax) {
  float lo = 3.0e38f, hi = -3.0e38f;
  for (int i = lane; i < n; i += 32) {
    const long long r = r0 + i;
    if (r < R) {
      const float p = __ldg(q_pos + r % Sq);
      lo = fminf(lo, p);
      hi = fmaxf(hi, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  *qmin = lo;
  *qmax = hi;
}

// ---- the kernel -------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ q_pos,
                          const float* __restrict__ k_pos,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int G, int Sq, int Sk,
                          float scale, int causal, int window,
                          float attn_cap) {
  using Shape = TcShape<HD>;
  constexpr int BK = Shape::kBK;
  constexpr int SLAB_Q = kBQ * kSlabBytes;   // bytes of one Q slab
  constexpr int SLAB_KV = BK * kSlabBytes;   // bytes of one K or V slab

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + Shape::kQBytes;
  constexpr int kStages = Shape::kStages;
  uint8_t* vs = ks + kStages * Shape::kKVBytes;
  // barriers: Q full, then K full, V full, K empty, V empty per stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * Shape::kKVBytes);
  int* flags = reinterpret_cast<int*>(bars + 16);
  float* vmean = reinterpret_cast<float*>(flags + 4);
  const uint32_t q_full = smem_u32(bars);
  auto k_full = [&](int s) { return smem_u32(bars + 1 + s); };
  auto v_full = [&](int s) { return smem_u32(bars + 1 + kStages + s); };
  auto k_empty = [&](int s) { return smem_u32(bars + 1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return smem_u32(bars + 1 + 3 * kStages + s); };

  // blockIdx.x is a rank among the q tiles of kv head blockIdx.y: CTAs
  // that run together share a head, so its K/V tiles come from L2; inside
  // a head the q tiles with the largest positions go first
  const int hk = blockIdx.y;
  const long long R = static_cast<long long>(G) * Sq;
  const int rank = blockIdx.x;
  int tile;
  if (Sq % kBQ == 0) {
    const int nt = Sq / kBQ;
    tile = (rank % G) * nt + (nt - 1 - rank / G);
  } else {
    tile = gridDim.x - 1 - rank;
  }
  const long long row0 = static_cast<long long>(tile) * kBQ;
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp index, visibly uniform to the compiler
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_kt = (Sk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);
      mbar_init(v_empty(s), 2 * 128);
    }
    flags[0] = flags[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float qmin, qmax;   // the CTA's q range: the skip predicate's
  q_range(q_pos, row0, kBQ, R, Sq, lane, &qmin, &qmax);

  if (warp < 4) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, Shape::kQBytes);
#pragma unroll
        for (int s = 0; s < Shape::kSlabs; ++s)
          tma_load_3d(smem_u32(qs + s * SLAB_Q), &tm_q, q_full, 64 * s,
                      static_cast<int>(row0), hk);
      }
      int stage = 0, phase = 0;
      TilePos<BK> nxt = load_tile_pos<BK>(k_pos, Sk, 0, lane);
      for (int kt = 0; kt < n_kt; ++kt) {
        const TileInfo t = tile_info<BK>(nxt);
        if (kt + 1 < n_kt) nxt = load_tile_pos<BK>(k_pos, Sk, kt + 1, lane);
        if (skip_tile(t, qmin, qmax, causal, window)) continue;
        if (lane == 0) {
          uint8_t* kdst = ks + stage * Shape::kKVBytes;
          uint8_t* vdst = vs + stage * Shape::kKVBytes;
          mbar_wait(k_empty(stage), phase ^ 1);
          mbar_expect_tx(k_full(stage), Shape::kKVBytes);
#pragma unroll
          for (int s = 0; s < Shape::kSlabs; ++s)
            tma_load_3d(smem_u32(kdst + s * SLAB_KV), &tm_k, k_full(stage),
                        64 * s, kt * BK, hk);
          mbar_wait(v_empty(stage), phase ^ 1);
          mbar_expect_tx(v_full(stage), Shape::kKVBytes);
#pragma unroll
          for (int s = 0; s < Shape::kSlabs; ++s)
            tma_load_3d(smem_u32(vdst + s * SLAB_KV), &tm_v, v_full(stage),
                        64 * s, kt * BK, hk);
        }
        __syncwarp();
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp / 4 - 1;            // consumer 0 or 1: rows cw*64..
    const int wq = warp % 4;                // warp inside the warpgroup
    const int lr = cw * 64 + wq * 16 + lane / 4;   // this thread's first row
    const long long rg0 = row0 + lr, rg1 = rg0 + 8;
    const bool real0 = rg0 < R, real1 = rg1 < R;
    const float qp0 = real0 ? __ldg(q_pos + rg0 % Sq) : 0.0f;
    const float qp1 = real1 ? __ldg(q_pos + rg1 % Sq) : 0.0f;
    float wqmin, wqmax;   // this warp's 16 rows: the mask decision's
    q_range(q_pos, row0 + cw * 64 + wq * 16, 16, R, Sq, lane, &wqmin, &wqmax);
    const float s_log2 = scale * kLog2e;   // raw scores to the log2 domain
    const float cap_in = attn_cap > 0.0f ? scale / attn_cap : 0.0f;
    const int cpair = 2 * (lane % 4);       // first of this thread's columns

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    const uint32_t q_base = smem_u32(qs) + cw * 64 * kSlabBytes;
    // P . V of tile j is issued in iteration j + 1, beside S of tile j + 1,
    // so this tile's softmax overlaps the previous tile's product.  The
    // first live tile is peeled off the loop, so that no wgmma sits behind
    // a branch inside it.
    float s[BK / 2];
    uint32_t p[BK / 16][4];        // P of the tile whose P . V is pending
    int stage = 0, phase = 0, pv_stage = 0, pv_phase = 0;
    TilePos<BK> nxt = load_tile_pos<BK>(k_pos, Sk, 0, lane);
    TileInfo t;
    // the first live tile at or after kt (n_kt if none); t gets its info
    auto next_live = [&](int kt) {
      for (; kt < n_kt; ++kt) {
        t = tile_info<BK>(nxt);
        if (kt + 1 < n_kt) nxt = load_tile_pos<BK>(k_pos, Sk, kt + 1, lane);
        if (!skip_tile(t, qmin, qmax, causal, window)) break;
      }
      return kt;
    };
    auto issue_s = [&]() {         // S = Q . K^T of the tile in `stage`
      const uint32_t k_base = smem_u32(ks + stage * Shape::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 bf16 further into the slab
        const uint64_t da =
            sw128_desc(q_base + (kk / 4) * SLAB_Q + off, 16, 1024);
        const uint64_t db =
            sw128_desc(k_base + (kk / 4) * SLAB_KV + off, 16, 1024);
        wgmma_ss<BK>(s, da, db, kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&]() {        // O += P . V of the tile in `pv_stage`
      mbar_wait(v_full(pv_stage), pv_phase);
      const uint32_t v_base = smem_u32(vs + pv_stage * Shape::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(v_base + kk * 16 * kSlabBytes,
                                       SLAB_KV, 1024);
        wgmma_rs<HD>(o, p[kk], db);
      }
      wg_commit();
    };
    auto retire_pv = [&]() {       // after wg_wait<0>: P . V is done
      fence_regs<HD / 2>(o);
      fence_regs<BK / 4>(&p[0][0]);
      mbar_arrive(v_empty(pv_stage));
    };
    // softcap, mask, online softmax of S; returns the factors that rescale
    // O, and leaves p in s.  m is kept in the scores' own units (capped,
    // if capped); p = 2^(s*f - m*f) is one FFMA and one ex2 an element,
    // with f = scale*log2(e), or log2(e) after the cap (which applies the
    // scale itself).  Maxima and sums run as 4 independent partials, so
    // the softmax is not one long dependent chain.
    auto softmax = [&](int kt, float* a0, float* a1) {
      if (attn_cap > 0.0f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = tanhf(s[i] * cap_in) * attn_cap;
      }
      const float f = attn_cap > 0.0f ? kLog2e : s_log2;
      const bool need_mask = __shfl_sync(
          0xffffffffu,
          static_cast<int>(t.any_invalid || (causal && t.kmax > wqmin) ||
                           (window > 0 &&
                            wqmax - t.kmin >= static_cast<float>(window))),
          0);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kt * BK + 8 * j + cpair + e;
            const float kp = key < Sk ? __ldg(k_pos + key) : kPadPos;
            const bool ok0 =
                kp < kPosLimit && (!causal || qp0 >= kp) &&
                (window <= 0 || qp0 - kp < static_cast<float>(window));
            const bool ok1 =
                kp < kPosLimit && (!causal || qp1 >= kp) &&
                (window <= 0 || qp1 - kp < static_cast<float>(window));
            if (!ok0) s[4 * j + e] = -INFINITY;
            if (!ok1) s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      // fragment element 4j+e: row 0 for e < 2, row 1 otherwise
      float x0[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      float x1[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        x0[j % 4] = fmaxf(x0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
        x1[j % 4] = fmaxf(x1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float mx0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
      float mx1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float u0 = n0 == -INFINITY ? 0.0f : n0 * f;
      const float u1 = n1 == -INFINITY ? 0.0f : n1 * f;
      *a0 = ex2(m0 * f - u0);
      *a1 = ex2(m1 * f - u1);
      m0 = n0;
      m1 = n1;
      float y0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], f, -u0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], f, -u0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], f, -u1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], f, -u1));
        y0[j % 4] += s[4 * j] + s[4 * j + 1];
        y1[j % 4] += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * *a0 + ((y0[0] + y0[1]) + (y0[2] + y0[3]));  // partial row sums
      l1 = l1 * *a1 + ((y1[0] + y1[1]) + (y1[2] + y1[3]));
    };
    auto pack_and_advance = [&]() {   // P to bf16; this tile's P . V is next
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      pv_stage = stage;
      pv_phase = phase;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    // ping-pong: a consumer issues its products only in its turn, so one
    // consumer's softmax runs while the other's products hold the tensor
    // cores; consumer 0 goes first
    const int my_turn = kTurnBarrier + cw, their_turn = kTurnBarrier + 1 - cw;
    if (cw == 1) named_arrive(their_turn, 256);
    mbar_wait(q_full, 0);
    int kt = next_live(0);
    if (kt < n_kt) {
      float a0, a1;
      mbar_wait(k_full(stage), phase);
      named_sync(my_turn, 256);
      wg_fence();
      issue_s();
      named_arrive(their_turn, 256);
      wg_wait<0>();
      fence_regs<BK / 2>(s);
      mbar_arrive(k_empty(stage));
      softmax(kt, &a0, &a1);         // O is still zero: nothing to rescale
      pack_and_advance();
      for (kt = next_live(kt + 1); kt < n_kt; kt = next_live(kt + 1)) {
        mbar_wait(k_full(stage), phase);
        named_sync(my_turn, 256);
        wg_fence();
        issue_s();
        issue_pv();
        named_arrive(their_turn, 256);
        wg_wait<1>();                // S is done; P . V may still run
        fence_regs<BK / 2>(s);
        mbar_arrive(k_empty(stage));
        softmax(kt, &a0, &a1);
        wg_wait<0>();                // P . V is done: O and P are free
        retire_pv();
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        pack_and_advance();
      }
      wg_fence();                    // the last tile's P . V
      issue_pv();
      wg_wait<0>();
      retire_pv();
    }
    if (cw == 0) named_sync(my_turn, 256);   // consumer 1's last hand-over

    // epilogue: full row sums, rows without a visible key, store
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if ((real0 && l0 == 0.0f) || (real1 && l1 == 0.0f)) flags[cw] = 1;
    named_sync(1 + cw, 128);
    float* vm = vmean + cw * HD;
    if (flags[cw]) {
      const __nv_bfloat16* vh = v + static_cast<long long>(hk) * Sk * HD;
      for (int d = tid % 128; d < HD; d += 128) {
        float sum = 0.0f;
        for (int key = 0; key < Sk; ++key)
          sum += __bfloat162float(vh[static_cast<long long>(key) * HD + d]);
        vm[d] = sum / static_cast<float>(Sk);
      }
      named_sync(1 + cw, 128);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    if (lse != nullptr && lane % 4 == 0) {   // the quad holds one row pair
      const float to_nat = attn_cap > 0.0f ? 1.0f : scale;
      const float empty = kNegInf + logf(static_cast<float>(Sk));
      float* lh = lse + static_cast<long long>(hk) * R;
      if (real0) lh[rg0] = l0 == 0.0f ? empty : m0 * to_nat + logf(l0);
      if (real1) lh[rg1] = l1 == 0.0f ? empty : m1 * to_nat + logf(l1);
    }
    __nv_bfloat16* oh = out + static_cast<long long>(hk) * R * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + cpair;
      if (real0) {
        const uint32_t w = l0 == 0.0f ? pack_bf16(vm[col], vm[col + 1])
                                      : pack_bf16(o[4 * j] * inv0,
                                                  o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(oh + rg0 * HD + col) = w;
      }
      if (real1) {
        const uint32_t w = l1 == 0.0f ? pack_bf16(vm[col], vm[col + 1])
                                      : pack_bf16(o[4 * j + 2] * inv1,
                                                  o[4 * j + 3] * inv1);
        *reinterpret_cast<uint32_t*>(oh + rg1 * HD + col) = w;
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

// Error codes of this library beyond cudaError_t's (negative).
constexpr int kErrNoEncoder = -1;     // cuTensorMapEncodeTiled not reachable
constexpr int kErrEncode = -2;        // the driver refused a tensor map
constexpr int kErrHeadDim = -3;       // head_dim not in {64, 128, 256}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [heads, rows, hd] bf16 tensor as 3-D tiles of box_rows x 64 columns,
// 128-byte swizzle; out-of-bounds rows read as zero.
int make_map(CUtensorMap* map, const void* ptr, long long rows, int heads,
             int hd, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const float* q_pos,
              const float* k_pos, void* out, float* lse, int HK, int G,
              int Sq, int Sk, float scale, int causal, int window,
              float attn_cap, cudaStream_t stream) {
  using Shape = TcShape<HD>;
  const long long R = static_cast<long long>(G) * Sq;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, R, HK, HD, kBQ);
  if (!err) err = make_map(&tk, k, Sk, HK, HD, Shape::kBK);
  if (!err) err = make_map(&tv, v, Sk, HK, HD, Shape::kBK);
  if (err) return err;
  auto kernel = flash_attention_tc_kernel<HD>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  const dim3 grid(static_cast<unsigned>((R + kBQ - 1) / kBQ),
                  static_cast<unsigned>(HK));
  kernel<<<grid, kThreads, Shape::kSmem, stream>>>(
      tq, tk, tv, q_pos, k_pos, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, G, Sq, Sk, scale, causal,
      window, attn_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [HK*G, Sq, hd], k/v [HK, Sk, hd], out like q: contiguous bf16, 16-byte
// aligned; q_pos [Sq] and k_pos [Sk] float32; lse null or float32
// [HK*G, Sq]; hd in {64, 128, 256}.  Returns 0 when the launch was
// accepted, else a cudaError_t or one of this library's negative codes
// (flash_attention_tc_error_string).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, const void* q_pos,
                                         const void* k_pos, void* out,
                                         void* lse, int HK, int G, int Sq,
                                         int Sk, int hd, float scale,
                                         int causal, int window,
                                         float attn_cap, void* stream) {
  if (HK <= 0 || G <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const auto* qp = static_cast<const float*>(q_pos);
  const auto* kp = static_cast<const float*>(k_pos);
  auto* ls = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_hd<64>(q, k, v, qp, kp, out, ls, HK, G, Sq, Sk, scale,
                           causal, window, attn_cap, st);
    case 128:
      return launch_hd<128>(q, k, v, qp, kp, out, ls, HK, G, Sq, Sk, scale,
                            causal, window, attn_cap, st);
    case 256:
      return launch_hd<256>(q, k, v, qp, kp, out, ls, HK, G, Sq, Sk, scale,
                            causal, window, attn_cap, st);
    default:
      return kErrHeadDim;
  }
}

extern "C" const char* flash_attention_tc_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled is not reachable through the runtime";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrHeadDim:
      return "head_dim must be 64, 128 or 256 on the tensor-core route";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
