// Forward flash attention over flattened heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_flat
// (src/repro/kernels/flash_attention/kernel.py:73, body _kernel :26).
// For every q head h and q row it computes
//   s   = q . k^T * scale                      (f32)
//   s   = tanh(s / cap) * cap                  (when attn_cap > 0)
//   ok  = k_pos < 2**29 && (!causal || q_pos >= k_pos)
//         && (window <= 0 || q_pos - k_pos < window)
//   out = softmax over the ok keys of s, times v   (kv head h // g)
// with positions in float32 and the output cast to q's dtype.  The online
// softmax keeps m, l and acc in f32; l is clamped at 1e-30.  Masked keys
// get p = 0, which is what the TPU kernel's finite NEG_INF = -2**20 gives
// as soon as a row has seen one visible key.  A row with no visible key
// at all gets the mean of v over the Sk keys passed in (never NaN): the
// TPU kernel's answer whenever its kv tile divides Sk (for other tiles it
// also counts its own zero padding), and the plain version's
// (src/repro_torch/kernels/flash_attention/ref.py).
// With an lse pointer it also writes every row's natural log-sum-exp over
// its visible keys, m + log(l) in f32 (the training forward's second
// output, which the recompute backward reads); a row with no visible key
// gets NEG_INF + log(Sk), the log-sum-exp of the Sk NEG_INF scores whose
// uniform softmax gives the mean of v.  A null pointer writes nothing.
//
// Design.  The TPU kernel carries m/l/acc across a sequential kv-tile grid
// axis; Hopper blocks run in no order, so here one block owns a q tile and
// loops over the kv tiles itself:
//   - GQA packing: the g q heads of one kv head are contiguous in the flat
//     layout, so q is read as [HK, g*Sq, hd] and a block's BQ rows may mix
//     heads of one group.  Every K/V tile staged in shared memory then
//     serves all g heads (4x fewer K/V bytes for llama3's g = 4), and a
//     decode step (Sq = 1) fills g rows of one 16-row tile instead of one
//     block per head;
//   - 256 threads; thread t owns rows (t/16)*TR .. +TR (TR = BQ/16) and,
//     of each 64-key tile, keys (t%16) + 16j.  Its scores, the row max and
//     the row sum (shuffles within 16 lanes) stay in registers; p goes
//     through shared memory to the P.V product, where the thread owns the
//     head-dim columns (t%16) + 16j of its rows in registers (acc);
//   - q, k and v tiles are staged in shared memory in their own dtype
//     (16-byte global loads, rows padded by one 32-bit word so the strided
//     reads hit distinct banks) and widened to f32 on read; above 48 KB the
//     dynamic shared memory limit is raised with cudaFuncSetAttribute
//     (hd = 256 in f32 needs 215 KB);
//   - a kv tile whose keys are all masked for every row of the q tile
//     (no valid key, all after the tile's last position under the causal
//     mask, or all out of the window) is skipped before its K/V are read:
//     about half the tiles of a causal prefill.  Rows with no visible key
//     are found at the end (l == 0) and get the column mean of v from one
//     extra pass over the kv head, so skipping never changes them.
//
// What bounds it on an H100: a causal prefill does 4*hd flops per visible
// (q, k) pair; at 989 TFLOP/s in bf16 that is the bound, far above the
// bytes.  This design runs the products on the CUDA cores in f32 (67
// TFLOP/s peak, and two shared-memory loads per four FMAs in the score
// loop), with no copy/compute overlap, so it sits an order of magnitude or
// more above the bound.
//
// Which calls still reach it: the route plan (plan() in
// src/repro_torch/kernels/flash_attention/kernel.py) sends a call here
// only when a kv head has more than 16 q rows and the call is float32 (an
// f32 prefill: wgmma has no f32 product, and TF32 would break the f32
// tolerance) or bf16 at a head_dim other than 64, 128 or 256.  bf16
// prefills at those head dims go to flash_attention_tc.cu (tensor cores,
// TMA), and every call with at most 16 q rows per kv head, decode steps
// included, to flash_attention_decode.cu (split-K) -- unless the call asks
// for the log-sum-exp, which the decode route does not write: such a call
// with at most 16 rows a kv head comes here, to the 16-row tile.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1048576.0f;     // -2**20, finite
constexpr float kPosLimit = 536870912.0f;  // 2**29: keys at or above are invalid
constexpr float kPadPos = 1073741824.0f;   // 2**30: the kernel's own key padding
constexpr int kThreads = 256;
constexpr int kBK = 64;                    // keys per kv tile

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // element 2i sits in the low half of word i (little endian)
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 narrow(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy `rows` rows of `row_bytes` bytes (a multiple of 16) starting at
// global row `row0` of `src` (total `n_rows` rows) into shared memory rows
// of `stride` words; rows past the end are zero.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const char* src,
                                           long long row0, long long n_rows,
                                           int rows, int row_bytes,
                                           int stride) {
  const int chunks = row_bytes / 16;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx % chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = reinterpret_cast<const uint4*>(src + (row0 + r) * row_bytes)[c];
    uint32_t* d = dst + r * stride + c * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int BQ>
__host__ __device__ constexpr int smem_words(int row_words, int hd) {
  // q tile, k tile, v tile, p tile, k positions, q positions, v mean
  return (BQ + 2 * kBK) * row_words + BQ * (kBK + 1) + kBK + BQ + hd;
}

template <typename T, int HDMAX, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ q_pos,
                       const float* __restrict__ k_pos, T* __restrict__ out,
                       float* __restrict__ lse, int G, int Sq, int Sk, int hd,
                       float scale, int causal, int window, float attn_cap) {
  constexpr int TR = BQ / 16;        // rows per thread
  constexpr int ACC = HDMAX / 16;    // head-dim columns per thread
  constexpr int KC = kBK / 16;       // keys per thread per tile
  using E = Elem<T>;

  const int hk = blockIdx.y;
  const long long R = static_cast<long long>(G) * Sq;   // rows of this kv head
  const long long row0 = static_cast<long long>(blockIdx.x) * BQ;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int hw = row_bytes / 4;      // 32-bit words per row
  const int stride = hw + 1;         // padded shared-memory row, odd

  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* ks = qs + BQ * stride;
  uint32_t* vs = ks + kBK * stride;
  float* ps = reinterpret_cast<float*>(vs + kBK * stride);
  float* kpos_s = ps + BQ * (kBK + 1);
  float* qpos_s = kpos_s + kBK;
  float* vmean = qpos_s + BQ;

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;

  const char* qg = reinterpret_cast<const char*>(q + hk * R * hd);
  const char* kg = reinterpret_cast<const char*>(k + static_cast<long long>(hk) * Sk * hd);
  const char* vg = reinterpret_cast<const char*>(v + static_cast<long long>(hk) * Sk * hd);

  stage_rows(qs, qg, row0, R, BQ, row_bytes, stride);
  if (tid < BQ) {
    const long long r = row0 + tid;
    qpos_s[tid] = r < R ? q_pos[r % Sq] : 0.0f;
  }
  __syncthreads();

  // the q tile's position range, over its real rows
  float qmin = 3.0e38f, qmax = -3.0e38f;
  for (int t = 0; t < BQ && row0 + t < R; ++t) {
    qmin = fminf(qmin, qpos_s[t]);
    qmax = fmaxf(qmax, qpos_s[t]);
  }

  float qp[TR], m[TR], l[TR], acc[TR][ACC];
  bool real[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    qp[i] = qpos_s[rg * TR + i];
    real[i] = row0 + rg * TR + i < R;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[i][j] = 0.0f;
  }
  const float inv_cap = attn_cap > 0.0f ? 1.0f / attn_cap : 0.0f;
  const int lane = tid % 32;
  const int n_tiles = (Sk + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const long long key0 = static_cast<long long>(kt) * kBK;
    __syncthreads();                 // the previous tile's readers are done
    if (tid < kBK)
      kpos_s[tid] = key0 + tid < Sk ? k_pos[key0 + tid] : kPadPos;
    __syncthreads();

    // skip the tile if every key is masked for every row (same in all warps)
    float kmin = 3.0e38f, kmax = -3.0e38f;
#pragma unroll
    for (int c = lane; c < kBK; c += 32) {
      const float kp = kpos_s[c];
      if (kp < kPosLimit) {
        kmin = fminf(kmin, kp);
        kmax = fmaxf(kmax, kp);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = fminf(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    const bool none_valid = kmin > kmax;
    if (none_valid || (causal && kmin > qmax) ||
        (window > 0 && qmin - kmax >= static_cast<float>(window)))
      continue;

    stage_rows(ks, kg, key0, Sk, kBK, row_bytes, stride);
    stage_rows(vs, vg, key0, Sk, kBK, row_bytes, stride);
    __syncthreads();

    // scores of this thread's TR rows x KC keys
    float s[TR][KC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int w = 0; w < hw; ++w) {
      float qv[TR][E::kPerWord], kv[KC][E::kPerWord];
#pragma unroll
      for (int i = 0; i < TR; ++i) E::unpack(qs[(rg * TR + i) * stride + w], qv[i]);
#pragma unroll
      for (int j = 0; j < KC; ++j) E::unpack(ks[(cg + 16 * j) * stride + w], kv[j]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j)
#pragma unroll
          for (int e = 0; e < E::kPerWord; ++e) s[i][j] += qv[i][e] * kv[j][e];
    }

    // mask, online softmax update, p to shared memory
    float alpha[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      bool ok[KC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float kp = kpos_s[cg + 16 * j];
        ok[j] = real[i] && kp < kPosLimit && (!causal || qp[i] >= kp) &&
                (window <= 0 || qp[i] - kp < static_cast<float>(window));
        float sv = s[i][j] * scale;
        if (attn_cap > 0.0f) sv = tanhf(sv * inv_cap) * attn_cap;
        s[i][j] = ok[j] ? sv : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(rg * TR + i) * (kBK + 1) + cg + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha[i] + group16_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    const T* vt = reinterpret_cast<const T*>(vs);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = ps[(rg * TR + i) * (kBK + 1) + c];
      const T* vrow = vt + c * stride * E::kPerWord;
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int d = cg + 16 * j;
        if (d < hd) {
          const float vv = E::widen(vrow[d]);
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

  // rows with no visible key: the mean of v over all Sk keys of this head
  int empty = 0;
#pragma unroll
  for (int i = 0; i < TR; ++i) empty |= (real[i] && l[i] == 0.0f) ? 1 : 0;
  if (__syncthreads_or(empty)) {
    const T* vh = v + static_cast<long long>(hk) * Sk * hd;
    for (int d = tid; d < hd; d += kThreads) {
      float sum = 0.0f;
      for (int key = 0; key < Sk; ++key)
        sum += E::widen(vh[static_cast<long long>(key) * hd + d]);
      vmean[d] = sum / static_cast<float>(Sk);
    }
    __syncthreads();
  }

  T* oh = out + hk * R * hd;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (!real[i]) continue;
    const long long r = row0 + rg * TR + i;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cg == 0)   // m and l are the same in all 16 lanes
      lse[hk * R + r] = l[i] == 0.0f
                            ? kNegInf + logf(static_cast<float>(Sk))
                            : m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int d = cg + 16 * j;
      if (d < hd) {
        const float val = l[i] == 0.0f ? vmean[d] : acc[i][j] * inv_l;
        oh[r * hd + d] = E::narrow(val);
      }
    }
  }
}

template <typename T, int HDMAX, int BQ>
int launch_tiled(const void* q, const void* k, const void* v,
                 const float* q_pos, const float* k_pos, void* out,
                 float* lse, int HK, int G, int Sq, int Sk, int hd,
                 float scale, int causal, int window, float attn_cap,
                 cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HDMAX, BQ>;
  const int stride = hd * static_cast<int>(sizeof(T)) / 4 + 1;
  const size_t bytes = sizeof(uint32_t) * smem_words<BQ>(stride, hd);
  static size_t raised = 48 * 1024;  // the limit this instantiation allows
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = bytes;
  }
  const long long R = static_cast<long long>(G) * Sq;
  const dim3 grid(static_cast<unsigned>((R + BQ - 1) / BQ),
                  static_cast<unsigned>(HK));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), lse, G,
      Sq, Sk, hd, scale, causal, window, attn_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ>
int launch_bq(const void* q, const void* k, const void* v,
              const float* q_pos, const float* k_pos, void* out, float* lse,
              int HK, int G, int Sq, int Sk, int hd, float scale, int causal,
              int window, float attn_cap, cudaStream_t stream) {
#define FA_LAUNCH(HDMAX)                                                    \
  return launch_tiled<T, HDMAX, BQ>(q, k, v, q_pos, k_pos, out, lse, HK, G, \
                                    Sq, Sk, hd, scale, causal, window,      \
                                    attn_cap, stream)
  if (hd <= 16) FA_LAUNCH(16);
  if (hd <= 32) FA_LAUNCH(32);
  if (hd <= 64) FA_LAUNCH(64);
  if (hd <= 128) FA_LAUNCH(128);
  FA_LAUNCH(256);
#undef FA_LAUNCH
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* q_pos, const float* k_pos, void* out,
                 float* lse, int HK, int G, int Sq, int Sk, int hd,
                 float scale, int causal, int window, float attn_cap,
                 cudaStream_t stream) {
  // at most 16 rows of a kv head fill one 16-row tile; longer q use 64 rows
  if (static_cast<long long>(G) * Sq <= 16)
    return launch_bq<T, 16>(q, k, v, q_pos, k_pos, out, lse, HK, G, Sq, Sk,
                            hd, scale, causal, window, attn_cap, stream);
  return launch_bq<T, 64>(q, k, v, q_pos, k_pos, out, lse, HK, G, Sq, Sk,
                          hd, scale, causal, window, attn_cap, stream);
}

}  // namespace

// q [HK*G, Sq, hd], k/v [HK, Sk, hd], out like q, all contiguous, 16-byte
// aligned, of one dtype (0 = float32, 1 = bfloat16); q_pos [Sq] and k_pos
// [Sk] float32; lse null or float32 [HK*G, Sq].  hd is a multiple of 8 in
// [8, 256] (the wrapper checks).  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, void* lse,
                                      int dtype, int HK, int G, int Sq, int Sk,
                                      int hd, float scale, int causal,
                                      int window, float attn_cap,
                                      void* stream) {
  if (HK <= 0 || G <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const auto* qp = static_cast<const float*>(q_pos);
  const auto* kp = static_cast<const float*>(k_pos);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* ls = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, qp, kp, out, ls, HK, G, Sq,
                                       Sk, hd, scale, causal, window,
                                       attn_cap, st);
  return launch_typed<float>(q, k, v, qp, kp, out, ls, HK, G, Sq, Sk, hd,
                             scale, causal, window, attn_cap, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
