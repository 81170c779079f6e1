// Split-K flash attention for decode: at most 16 q rows per kv head.
//
// Replaces the TPU kernel flash_attention_flat
// (src/repro/kernels/flash_attention/kernel.py:73, body _kernel :26) for
// calls whose GQA group brings at most 16 q rows to a kv head (g * Sq <=
// 16: a decode step, or a very short prefill), in float32 and bfloat16,
// for any head_dim that is a multiple of 8 up to 256.  The route plan is
// in src/repro_torch/kernels/flash_attention/kernel.py (plan()).
// Semantics are those of flash_attention.cu: softcap before the mask,
// masked keys get p = 0, a row with no visible key gets the mean of v over
// the Sk keys, scores, softmax and sums in f32 (the bf16 tensor-core path
// rounds p to bf16 for P.V), output in q's dtype.
//
// What bounds it on an H100: the K/V bytes.  A decode step reads every
// cached key and value once and does 4*hd flops per (row, key) pair, a few
// flops per byte, far below the ~295 the card needs before its compute is
// the limit; the bound is the bytes at 3.35 TB/s.  Two things matter:
// filling all 132 SMs, and keeping loads in flight on each.  So:
//   - split-K: one CTA per (kv head, key split).  The wrapper picks the
//     split count (plan()): enough CTAs to fill the card several times
//     over, at least 128 keys a split.  Each split is a whole number of
//     64-key chunks, so a tile never straddles two splits;
//   - K/V stream through a cp.async ring (16 bytes a thread a copy) into
//     shared memory rows padded by 16 bytes, so reads hit distinct banks;
//   - a tile whose keys are all masked for every row is skipped before it
//     is loaded; a split with no live tile writes m = -inf, l = 0 and
//     returns before reading any K/V: at step t of the serve cell the keys
//     2049+t..2079 of the 2080-slot cache are masked, so the tail split is
//     often empty;
//   - each CTA writes its (m, l, acc[hd]) to an f32 workspace that the
//     wrapper allocates; a second launch combines each (kv head, row): it
//     rescales every split by exp(m_i - m), sums and divides.  A row whose
//     total l is 0 takes the mean of v over Sk.  At one split the mma
//     kernel below writes the output itself: no workspace, no combine.
// Two split kernels share that frame:
//   - bf16 at head_dim 64, 128 or 256 (the serve cell's calls): warps split
//     each 64-key tile, 16 keys a warp, and run both products as
//     mma.sync.m16n8k16 on the tensor cores with the (<= 16) q rows as
//     one zero-padded 16-row fragment.  Not for speed of arithmetic: it
//     keeps every warp on its own keys, so no warp re-reads another's K/V
//     from shared memory, and cuts the instructions per byte to a few;
//   - every other call (float32, odd head dims): 32-key tiles, lane j of
//     every warp owns key j, warp w the rows w, w+4, w+8, w+12, all in
//     f32 on the CUDA cores.
// No per-call host work beyond the launches: no tensor map is built.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kPosLimit = 536870912.0f;  // 2**29: keys at or above are invalid
constexpr float kPadPos = 1073741824.0f;   // 2**30: past the split
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;                    // keys per tile
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kMaxRows = 16;               // q rows per kv head
constexpr int kRowsPerWarp = kMaxRows / kWarps;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerChunk = 4;      // elements in 16 bytes
  __device__ static void unpack(uint4 w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  // element 2i sits in the low half of word i (little endian)
  __device__ static void unpack(uint4 w, float* out) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
  __device__ static float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 narrow(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Split {
  const float* k_pos;
  int key_lo, key_hi, n_tiles, causal, window;
  float qmin, qmax;

  // The first tile at or after t with a key visible to some row (n_tiles
  // if none).  Warp-collective: every warp finds the same tile.
  __device__ int next_live(int t, int lane) const {
    for (; t < n_tiles; ++t) {
      const int key = key_lo + t * kTK + lane;
      const float kp = key < key_hi ? __ldg(k_pos + key) : kPadPos;
      const bool valid = kp < kPosLimit;
      const float kmin = -warp_max(valid ? -kp : -3.0e38f);
      const float kmax = warp_max(valid ? kp : -3.0e38f);
      const bool skip =
          kmin > kmax || (causal && kmin > qmax) ||
          (window > 0 && qmin - kmax >= static_cast<float>(window));
      if (!skip) return t;
    }
    return n_tiles;
  }
};

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ q_pos,
                              const float* __restrict__ k_pos,
                              float* __restrict__ ws, int G, int Sq, int Sk,
                              int hd, float scale, int causal, int window,
                              float attn_cap, int chunk) {
  using E = Elem<T>;
  constexpr int CPL = HDMAX / 32;          // head-dim columns per lane
  const int split = blockIdx.x, splits = gridDim.x, hk = blockIdx.y;
  const int Rk = G * Sq;                   // rows of this kv head (<= 16)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int stride = row_bytes + 16;       // padded shared-memory row
  const int chunks = row_bytes / 16;

  extern __shared__ __align__(16) uint8_t smem[];
  float* qf = reinterpret_cast<float*>(smem);            // [Rk][hd]
  float* qpos_s = qf + Rk * hd;                          // [16]
  uint8_t* ring = smem + (Rk * hd + kMaxRows) * 4;       // K then V stages
  const int tile_bytes = kTK * stride;

  for (int i = tid; i < Rk * hd; i += kThreads)
    qf[i] = E::widen(q[static_cast<long long>(hk) * Rk * hd + i]);
  if (tid < Rk) qpos_s[tid] = __ldg(q_pos + tid % Sq);
  __syncthreads();

  Split sp;
  sp.k_pos = k_pos;
  sp.key_lo = split * chunk;
  sp.key_hi = min(Sk, sp.key_lo + chunk);
  sp.n_tiles = sp.key_hi > sp.key_lo ? (sp.key_hi - sp.key_lo + kTK - 1) / kTK : 0;
  sp.causal = causal;
  sp.window = window;
  sp.qmin = 3.0e38f;
  sp.qmax = -3.0e38f;
  for (int r = 0; r < Rk; ++r) {
    sp.qmin = fminf(sp.qmin, qpos_s[r]);
    sp.qmax = fmaxf(sp.qmax, qpos_s[r]);
  }

  float* ws_m = ws;                                       // [HK, splits, Rk]
  float* ws_l = ws + static_cast<long long>(gridDim.y) * splits * Rk;
  float* ws_acc = ws_l + static_cast<long long>(gridDim.y) * splits * Rk;
  const long long slot = (static_cast<long long>(hk) * splits + split) * Rk;

  int consume = sp.next_live(0, lane);
  if (consume >= sp.n_tiles) {             // nothing visible: no K/V read
    if (tid < Rk) {
      ws_m[slot + tid] = -INFINITY;
      ws_l[slot + tid] = 0.0f;
    }
    return;
  }

  const char* kg = reinterpret_cast<const char*>(k) +
                   static_cast<long long>(hk) * Sk * row_bytes;
  const char* vg = reinterpret_cast<const char*>(v) +
                   static_cast<long long>(hk) * Sk * row_bytes;
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto issue = [&](int t, int stage) {
    const int key0 = sp.key_lo + t * kTK;
    const uint32_t kd = ring_u32 + (2 * stage) * tile_bytes;
    const uint32_t vd = kd + tile_bytes;
    for (int idx = tid; idx < kTK * chunks; idx += kThreads) {
      const int r = idx / chunks, c = idx % chunks;
      const int key = key0 + r;
      const bool in = key < sp.key_hi;
      const long long off = in ? static_cast<long long>(key) * row_bytes + 16 * c : 0;
      cp_async16(kd + r * stride + 16 * c, kg + off, in ? 16 : 0);
      cp_async16(vd + r * stride + 16 * c, vg + off, in ? 16 : 0);
    }
  };

  int fetch = consume;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (fetch < sp.n_tiles) {
      issue(fetch, s);
      fetch = sp.next_live(fetch + 1, lane);
    }
    cp_async_commit();
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], qp[kRowsPerWarp];
  float acc[kRowsPerWarp][CPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
    const int r = warp + kWarps * i;
    qp[i] = r < Rk ? qpos_s[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.0f;
  }
  const float inv_cap = attn_cap > 0.0f ? 1.0f / attn_cap : 0.0f;

  int rs = 0;                               // the stage being read
  while (consume < sp.n_tiles) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                        // the tile landed; the stage
                                            // read last time is free
    const int wstage = (rs + kStages - 1) % kStages;
    if (fetch < sp.n_tiles) {
      issue(fetch, wstage);
      fetch = sp.next_live(fetch + 1, lane);
    }
    cp_async_commit();

    const uint8_t* ks = ring + (2 * rs) * tile_bytes;
    const uint8_t* vs = ks + tile_bytes;
    const int key = sp.key_lo + consume * kTK + lane;
    const float kp = key < sp.key_hi ? __ldg(k_pos + key) : kPadPos;

    // scores: lane = key, rows warp + 4i
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const uint4* krow = reinterpret_cast<const uint4*>(ks + lane * stride);
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) {
      float kv[E::kPerChunk];
      E::unpack(krow[c], kv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r < Rk) {
          const float4* qr = reinterpret_cast<const float4*>(
              qf + r * hd + c * E::kPerChunk);
#pragma unroll
          for (int e = 0; e < E::kPerChunk / 4; ++e) {
            const float4 qv = qr[e];
            s[i] += qv.x * kv[4 * e] + qv.y * kv[4 * e + 1] +
                    qv.z * kv[4 * e + 2] + qv.w * kv[4 * e + 3];
          }
        }
      }
    }

    // mask, online softmax
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      p[i] = 0.0f;
      if (warp + kWarps * i >= Rk) continue;       // uniform in the warp
      float x = s[i] * scale;
      if (attn_cap > 0.0f) x = tanhf(x * inv_cap) * attn_cap;
      const bool ok = kp < kPosLimit && (!causal || qp[i] >= kp) &&
                      (window <= 0 || qp[i] - kp < static_cast<float>(window));
      x = ok ? x : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(x));
      const float mu = mn == -INFINITY ? 0.0f : mn;
      const float alpha = expf(m[i] - mu);
      p[i] = ok ? expf(x - mu) : 0.0f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
    }

    // acc += p . v: lane owns columns lane*CPL ..
#pragma unroll 4
    for (int j = 0; j < kTK; ++j) {
      const T* vrow = reinterpret_cast<const T*>(vs + j * stride);
      float vv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane * CPL + c;
        vv[c] = d < hd ? E::widen(vrow[d]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] += pj * vv[c];
      }
    }
    consume = sp.next_live(consume + 1, lane);
    rs = (rs + 1) % kStages;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= Rk) continue;
    if (lane == 0) {
      ws_m[slot + r] = m[i];
      ws_l[slot + r] = l[i];
    }
    float* a = ws_acc + (slot + r) * hd;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d = lane * CPL + c;
      if (d < hd) a[d] = acc[i][c];
    }
  }
}

// One CTA per (row, kv head): combine the splits' partials.  The splits'
// weights exp(m_i - m) go to shared memory first (dynamic, `splits`
// floats), so the loop over a column's partials has no dependent loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_combine_kernel(const float* __restrict__ ws,
                               const T* __restrict__ v, T* __restrict__ out,
                               int splits, int Rk, int Sk, int hd) {
  using E = Elem<T>;
  extern __shared__ float weight[];        // [splits]
  __shared__ float red[kWarps];
  const int r = blockIdx.x, hk = blockIdx.y, HK = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* ws_m = ws;
  const float* ws_l = ws + static_cast<long long>(HK) * splits * Rk;
  const float* ws_acc = ws_l + static_cast<long long>(HK) * splits * Rk;
  const long long first = static_cast<long long>(hk) * splits * Rk + r;

  float mx = -INFINITY;
  for (int s = tid; s < splits; s += kThreads)
    if (ws_l[first + s * Rk] > 0.0f) mx = fmaxf(mx, ws_m[first + s * Rk]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float total = 0.0f;
  for (int s = tid; s < splits; s += kThreads) {
    const float ls = ws_l[first + s * Rk];
    const float w = ls > 0.0f ? expf(ws_m[first + s * Rk] - mx) : 0.0f;
    weight[s] = w;
    total += ls * w;
  }
  total = warp_sum(total);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  total = red[0] + red[1] + red[2] + red[3];

  T* o = out + (static_cast<long long>(hk) * Rk + r) * hd;
  if (total > 0.0f) {
    const float inv = 1.0f / total;
    for (int d = tid; d < hd; d += kThreads) {
      float sum = 0.0f;
#pragma unroll 4
      for (int s = 0; s < splits; ++s) {
        const float w = weight[s];
        if (w > 0.0f) sum += ws_acc[(first + s * Rk) * hd + d] * w;
      }
      o[d] = E::narrow(sum * inv);
    }
  } else {                                 // no visible key: the mean of v
    const T* vh = v + static_cast<long long>(hk) * Sk * hd;
    for (int d = tid; d < hd; d += kThreads) {
      float sum = 0.0f;
      for (int key = 0; key < Sk; ++key)
        sum += E::widen(vh[static_cast<long long>(key) * hd + d]);
      o[d] = E::narrow(sum / static_cast<float>(Sk));
    }
  }
}

template <typename T>
int launch_combine(const float* ws, const void* v, void* out, int HK,
                   int splits, int Rk, int Sk, int hd, cudaStream_t stream) {
  auto kernel = flash_attention_combine_kernel<T>;
  const size_t bytes = static_cast<size_t>(splits) * 4;
  static size_t raised = 48 * 1024;
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = bytes;
  }
  kernel<<<dim3(Rk, HK), kThreads, bytes, stream>>>(
      ws, static_cast<const T*>(v), static_cast<T*>(out), splits, Rk, Sk, hd);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 at head_dim 64, 128 or 256: mma.sync, warps split the tile ----
//
// The serve cell's route.  A tile holds 64 keys; warp w owns keys 16w ..
// 16w+15 of it and all (<= 16, zero-padded) q rows, so no warp reads
// another's K/V and none repeats the others' work: S = Q . K^T and
// O += P . V are mma.sync.m16n8k16 (bf16 in, f32 out), Q's fragments
// sit in registers for the whole split, K and V fragments come from
// shared memory by ldmatrix (V transposed on the fly).  Each warp keeps
// its own m, l and O; the four are combined in shared memory at the end,
// and the CTA writes one (m, l, acc) to the workspace, or, when it is the
// only split, the output itself (no combine launch: 45 us against 50 us
// with it at the serve cell).  The tiles' skip and mask flags are computed
// up front into shared memory (25 bytes a 64-key tile; the plan keeps a
// split at most 65,536 keys), all position loads of the split in flight
// at once, so the copy ring never waits on a position load.

constexpr int kTKM = 64;                   // keys per tile, 16 per warp

// cp.async ring depth: 3 measured best at hd 128 on the H100 (4 to 6 were
// slower: one CTA an SM instead of two); 2 fit at hd 256
template <int HD>
__host__ __device__ constexpr int mma_stages() {
  return HD <= 128 ? 3 : 2;
}

template <int HD>
__host__ __device__ constexpr int mma_stride() {
  return HD * 2 + 16;                      // padded row: ldmatrix without conflicts
}

template <int HD>
__host__ __device__ constexpr int mma_ring_bytes() {
  return mma_stages<HD>() * 2 * kTKM * mma_stride<HD>();
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[4] += a[4] (16 x 16, row major) . {b0, b1} (16 x 8, column major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ q_pos,
                                  const float* __restrict__ k_pos,
                                  float* __restrict__ ws,
                                  __nv_bfloat16* __restrict__ out, int G,
                                  int Sq, int Sk, float scale, int causal,
                                  int window, float attn_cap, int chunk) {
  constexpr int STAGES = mma_stages<HD>();
  constexpr int STRIDE = mma_stride<HD>();
  constexpr int TILE = kTKM * STRIDE;      // bytes of one K or V tile
  const int split = blockIdx.x, splits = gridDim.x, hk = blockIdx.y;
  const int Rk = G * Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // mma fragment coordinates

  const int key_lo = split * chunk;
  const int key_hi = min(Sk, key_lo + chunk);
  const int n_tiles = key_hi > key_lo ? (key_hi - key_lo + kTKM - 1) / kTKM : 0;
  const int n_groups = 2 * n_tiles;        // 32-key halves of the tiles

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                    // [stage][K|V][64][STRIDE]
  float* qpos_s = reinterpret_cast<float*>(smem + mma_ring_bytes<HD>());
  float* gmin = qpos_s + kMaxRows;         // [n_groups]
  float* gmax = gmin + n_groups;           // [n_groups]
  int* gbad = reinterpret_cast<int*>(gmax + n_groups);  // [n_groups]
  uint8_t* flags = reinterpret_cast<uint8_t*>(gbad + n_groups);  // [n_tiles]

  if (tid < kMaxRows) qpos_s[tid] = tid < Rk ? __ldg(q_pos + tid % Sq) : 0.0f;
  // each 32-key group's position range: up to 8 groups a warp in flight
  for (int base = 0; base < n_groups; base += 8 * kWarps) {
    float kp[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int gi = base + warp + kWarps * u;
      const int key = key_lo + gi * 32 + lane;
      kp[u] = gi < n_groups && key < key_hi ? __ldg(k_pos + key) : kPadPos;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int gi = base + warp + kWarps * u;
      const bool valid = kp[u] < kPosLimit;
      const float lo = -warp_max(valid ? -kp[u] : -3.0e38f);
      const float hi = warp_max(valid ? kp[u] : -3.0e38f);
      const int bad = __any_sync(0xffffffffu, !valid);
      if (lane == 0 && gi < n_groups) {
        gmin[gi] = lo;
        gmax[gi] = hi;
        gbad[gi] = bad;
      }
    }
  }
  __syncthreads();
  float qmin = 3.0e38f, qmax = -3.0e38f;
  for (int r = 0; r < Rk; ++r) {
    qmin = fminf(qmin, qpos_s[r]);
    qmax = fmaxf(qmax, qpos_s[r]);
  }
  // per tile: bit 0 = some key visible to some row, bit 1 = needs the mask
  for (int ti = tid; ti < n_tiles; ti += kThreads) {
    const float kmin = fminf(gmin[2 * ti], gmin[2 * ti + 1]);
    const float kmax = fmaxf(gmax[2 * ti], gmax[2 * ti + 1]);
    const bool bad = gbad[2 * ti] || gbad[2 * ti + 1];
    const bool skip = kmin > kmax || (causal && kmin > qmax) ||
                      (window > 0 && qmin - kmax >= static_cast<float>(window));
    const bool mask = bad || (causal && kmax > qmin) ||
                      (window > 0 && qmax - kmin >= static_cast<float>(window));
    flags[ti] = (skip ? 0 : 1) | (mask ? 2 : 0);
  }
  __syncthreads();
  auto next_live = [&](int ti) {
    while (ti < n_tiles && !(flags[ti] & 1)) ++ti;
    return ti;
  };

  float* ws_m = ws;                                       // [HK, splits, Rk]
  float* ws_l = ws + static_cast<long long>(gridDim.y) * splits * Rk;
  float* ws_acc = ws_l + static_cast<long long>(gridDim.y) * splits * Rk;
  const long long slot = (static_cast<long long>(hk) * splits + split) * Rk;

  int consume = next_live(0);
  if (consume >= n_tiles && splits > 1) {  // nothing visible: no K/V read
    if (tid < Rk) {
      ws_m[slot + tid] = -INFINITY;
      ws_l[slot + tid] = 0.0f;
    }
    return;
  }

  const char* kg = reinterpret_cast<const char*>(k) +
                   static_cast<long long>(hk) * Sk * HD * 2;
  const char* vg = reinterpret_cast<const char*>(v) +
                   static_cast<long long>(hk) * Sk * HD * 2;
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto issue = [&](int ti, int stage) {
    constexpr int CHUNKS = HD * 2 / 16;
    const int key0 = key_lo + ti * kTKM;
    const uint32_t kd = ring_u32 + stage * 2 * TILE;
#pragma unroll 4
    for (int idx = tid; idx < kTKM * CHUNKS; idx += kThreads) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const int key = key0 + r;
      const bool in = key < key_hi;
      const long long off = in ? static_cast<long long>(key) * HD * 2 + 16 * c : 0;
      cp_async16(kd + r * STRIDE + 16 * c, kg + off, in ? 16 : 0);
      cp_async16(kd + TILE + r * STRIDE + 16 * c, vg + off, in ? 16 : 0);
    }
  };
  int fetch = consume;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (fetch < n_tiles) {
      issue(fetch, st);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }

  // Q's A fragments for every k16 step (rows >= Rk are zero)
  uint32_t qa[HD / 16][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(hk) * Rk + g) * HD);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(hk) * Rk + g + 8) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = g < Rk ? __ldg(q0 + kk * 8 + t) : 0u;
      qa[kk][1] = g + 8 < Rk ? __ldg(q1 + kk * 8 + t) : 0u;
      qa[kk][2] = g < Rk ? __ldg(q0 + kk * 8 + t + 4) : 0u;
      qa[kk][3] = g + 8 < Rk ? __ldg(q1 + kk * 8 + t + 4) : 0u;
    }
  }
  const float qp0 = qpos_s[g], qp1 = qpos_s[g + 8];
  const float inv_cap = attn_cap > 0.0f ? 1.0f / attn_cap : 0.0f;

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  // ldmatrix row addresses of this lane inside a tile
  const int mi = lane / 8, mr = lane % 8;
  const uint32_t k_lane = (warp * 16 + (mi / 2) * 8 + mr) * STRIDE + (mi % 2) * 16;
  const uint32_t v_lane = (warp * 16 + (mi % 2) * 8 + mr) * STRIDE + (mi / 2) * 16;

  int rs = 0;                              // the stage being read
  while (consume < n_tiles) {
    cp_async_wait<STAGES - 2>();           // this tile has landed
    __syncthreads();                       // and the stage read last is free
    if (fetch < n_tiles) {
      issue(fetch, (rs + STAGES - 1) % STAGES);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
    const uint32_t kst = ring_u32 + rs * 2 * TILE;
    const uint32_t vst = kst + TILE;

    // S = Q . K^T over this warp's 16 keys
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(kst + k_lane + kk * 32, b);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (attn_cap > 0.0f) x = tanhf(x * inv_cap) * attn_cap;
        s[nb][e] = x;
      }
    if (flags[consume] & 2) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key_lo + consume * kTKM + warp * 16 + nb * 8 + 2 * t + e;
          const float kp = key < key_hi ? __ldg(k_pos + key) : kPadPos;
          const bool valid = kp < kPosLimit;
          const bool ok0 = valid && g < Rk && (!causal || qp0 >= kp) &&
                           (window <= 0 || qp0 - kp < static_cast<float>(window));
          const bool ok1 = valid && g + 8 < Rk && (!causal || qp1 >= kp) &&
                           (window <= 0 || qp1 - kp < static_cast<float>(window));
          if (!ok0) s[nb][e] = -INFINITY;
          if (!ok1) s[nb][2 + e] = -INFINITY;
        }
    }
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float u0 = n0 == -INFINITY ? 0.0f : n0;
    const float u1 = n1 == -INFINITY ? 0.0f : n1;
    const float a0 = expf(m0 - u0), a1 = expf(m1 - u1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      s[nb][0] = expf(s[nb][0] - u0);
      s[nb][1] = expf(s[nb][1] - u0);
      s[nb][2] = expf(s[nb][2] - u1);
      s[nb][3] = expf(s[nb][3] - u1);
    }
    l0 = l0 * a0 + s[0][0] + s[0][1] + s[1][0] + s[1][1];
    l1 = l1 * a1 + s[0][2] + s[0][3] + s[1][2] + s[1][3];
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};

    // O = O * alpha + P . V
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[2 * j + h][0] *= a0;
        o[2 * j + h][1] *= a0;
        o[2 * j + h][2] *= a1;
        o[2 * j + h][3] *= a1;
      }
      uint32_t b[4];
      ldsm_x4_t(vst + v_lane + j * 32, b);
      mma_bf16(o[2 * j], pa, b[0], b[1]);
      mma_bf16(o[2 * j + 1], pa, b[2], b[3]);
    }
    consume = next_live(consume + 1);
    rs = (rs + 1) % STAGES;
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free for the combine

  // combine the four warps in shared memory
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* wm = reinterpret_cast<float*>(ring);            // [4][16]
  float* wl = wm + kWarps * kMaxRows;                    // [4][16]
  float* wo = wl + kWarps * kMaxRows;                    // [4][16][HD]
  if (t == 0) {
    wm[warp * kMaxRows + g] = m0;
    wl[warp * kMaxRows + g] = l0;
    wm[warp * kMaxRows + g + 8] = m1;
    wl[warp * kMaxRows + g + 8] = l1;
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float* r0 = wo + (warp * kMaxRows + g) * HD + 8 * j + 2 * t;
    float* r1 = r0 + 8 * HD;
    r0[0] = o[j][0];
    r0[1] = o[j][1];
    r1[0] = o[j][2];
    r1[1] = o[j][3];
  }
  __syncthreads();
  for (int idx = tid; idx < Rk * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wl[w * kMaxRows + r] > 0.0f) top = fmaxf(top, wm[w * kMaxRows + r]);
    float acc = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = wl[w * kMaxRows + r];
      if (lw > 0.0f) {
        const float f = expf(wm[w * kMaxRows + r] - top);
        acc += wo[(w * kMaxRows + r) * HD + d] * f;
        lsum += lw * f;
      }
    }
    if (splits == 1) {                     // the whole cache: the answer
      float val = acc / fmaxf(lsum, 1e-30f);
      if (lsum == 0.0f) {                  // no visible key: the mean of v
        const __nv_bfloat16* vh = v + static_cast<long long>(hk) * Sk * HD + d;
        val = 0.0f;
        for (int key = 0; key < Sk; ++key)
          val += __bfloat162float(vh[static_cast<long long>(key) * HD]);
        val /= static_cast<float>(Sk);
      }
      out[(static_cast<long long>(hk) * Rk + r) * HD + d] = __float2bfloat16(val);
      continue;
    }
    ws_acc[(slot + r) * HD + d] = acc;
    if (d == 0) {
      ws_m[slot + r] = top;
      ws_l[slot + r] = lsum;
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v,
               const float* q_pos, const float* k_pos, void* out, float* ws,
               int HK, int G, int Sq, int Sk, float scale, int causal,
               int window, float attn_cap, int splits, int chunk,
               cudaStream_t stream) {
  auto kernel = flash_attention_decode_mma_kernel<HD>;
  const int n_tiles = (chunk + kTKM - 1) / kTKM;
  const size_t bytes = static_cast<size_t>(mma_ring_bytes<HD>()) +
                       kMaxRows * 4 + static_cast<size_t>(n_tiles) * 2 * 12 +
                       ((n_tiles + 15) / 16) * 16;
  static size_t raised = 48 * 1024;  // the limit this instantiation allows
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = bytes;
  }
  using T = __nv_bfloat16;
  kernel<<<dim3(splits, HK), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, ws, static_cast<T*>(out), G,
      Sq, Sk, scale, causal, window, attn_cap, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_combine<T>(ws, v, out, HK, splits, G * Sq, Sk, HD, stream);
}

template <typename T, int HDMAX>
int launch_tmpl(const void* q, const void* k, const void* v,
                const float* q_pos, const float* k_pos, void* out, float* ws,
                int HK, int G, int Sq, int Sk, int hd, float scale, int causal,
                int window, float attn_cap, int splits, int chunk,
                cudaStream_t stream) {
  auto kernel = flash_attention_decode_kernel<T, HDMAX>;
  const int Rk = G * Sq;
  const int stride = hd * static_cast<int>(sizeof(T)) + 16;
  const size_t bytes = static_cast<size_t>(Rk * hd + kMaxRows) * 4 +
                       static_cast<size_t>(2 * kStages) * kTK * stride;
  static size_t raised = 48 * 1024;  // the limit this instantiation allows
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = bytes;
  }
  kernel<<<dim3(splits, HK), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, ws, G, Sq, Sk, hd, scale,
      causal, window, attn_cap, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_combine<T>(ws, v, out, HK, splits, Rk, Sk, hd, stream);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* q_pos, const float* k_pos, void* out, float* ws,
                 int HK, int G, int Sq, int Sk, int hd, float scale,
                 int causal, int window, float attn_cap, int splits,
                 int chunk, cudaStream_t stream) {
#define FA_DECODE(HDMAX)                                                    \
  return launch_tmpl<T, HDMAX>(q, k, v, q_pos, k_pos, out, ws, HK, G, Sq,   \
                               Sk, hd, scale, causal, window, attn_cap,     \
                               splits, chunk, stream)
  if (hd <= 32) FA_DECODE(32);
  if (hd <= 64) FA_DECODE(64);
  if (hd <= 128) FA_DECODE(128);
  FA_DECODE(256);
#undef FA_DECODE
}

}  // namespace

// q [HK*G, Sq, hd] with G*Sq <= 16, k/v [HK, Sk, hd], out like q, all
// contiguous, 16-byte aligned, of one dtype (0 = float32, 1 = bfloat16);
// q_pos [Sq], k_pos [Sk] float32; hd a multiple of 8 in [8, 256].
// `splits` CTAs per kv head, each over `chunk` keys (a multiple of 64,
// splits * chunk >= Sk); `workspace` holds HK * splits * G*Sq * (hd + 2)
// floats, and may be null at one split of the mma kernel (bf16 at hd 64,
// 128 or 256), which never touches it.  Launches the split kernel and the
// combine (none after one split of the mma kernel); returns
// cudaGetLastError() after them (0 when both were accepted).
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, void* workspace, int dtype, int HK, int G,
    int Sq, int Sk, int hd, float scale, int causal, int window,
    float attn_cap, int splits, int chunk, void* stream) {
  if (HK <= 0 || G <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (G * Sq > kMaxRows || splits <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const float*>(q_pos);
  const auto* kp = static_cast<const float*>(k_pos);
  auto* ws = static_cast<float*>(workspace);
  const auto st = static_cast<cudaStream_t>(stream);
#define FA_MMA(HD)                                                       \
  return launch_mma<HD>(q, k, v, qp, kp, out, ws, HK, G, Sq, Sk, scale,  \
                        causal, window, attn_cap, splits, chunk, st)
  if (dtype == 1 && hd == 64) FA_MMA(64);
  if (dtype == 1 && hd == 128) FA_MMA(128);
  if (dtype == 1 && hd == 256) FA_MMA(256);
#undef FA_MMA
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, qp, kp, out, ws, HK, G, Sq,
                                       Sk, hd, scale, causal, window,
                                       attn_cap, splits, chunk, st);
  return launch_typed<float>(q, k, v, qp, kp, out, ws, HK, G, Sq, Sk, hd,
                             scale, causal, window, attn_cap, splits, chunk,
                             st);
}

extern "C" const char* flash_attention_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
