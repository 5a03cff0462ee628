// flash_attention: blocked online-softmax attention with GQA and an
// end-aligned causal diagonal.  q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)
// -> o (B, Hq, Sq, D), float32 or bfloat16 in and out, float32 inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel: (Bq x D).(D x Bk) MXU tiles, the (m, l,
// acc) recurrence in VMEM scratch across the sequential kv grid axis,
// causal blocks above the band skipped with pl.when, kv heads indexed
// through the BlockSpec map).  Query row i sits at absolute position
// i + (Skv - Sq); it sees key j iff j < Skv and, when causal, j <= that
// position.  A row that sees no key returns zeros, as the TPU kernel's
// does.
//
// Bound on the H100: operations for prefill (4·Sq·Skv·D per head,
// halved by the causal band), bytes for decode (the KV cache is read
// once).  This first kernel is simple and right, not fast: it runs on
// the CUDA cores in float32, no tensor cores, no TMA.  The design:
//
//   * grid (ceil(Sq / BQ), B·Hq); one CTA of 256 threads per (head,
//     query tile).  The CTA stages its BQ query rows (scaled) in shared
//     memory, then walks the KV tiles of the head's kv group (head h
//     reads kv head h / (Hq / Hkv): no repeat is materialised), BK rows
//     at a time, up to the last tile the causal band reaches.  Two
//     tiles are built: BQ = 64 (prefill) and BQ = 16 (decode, short
//     prompts), both with BK = 64;
//   * each query row belongs to TPR = 256 / BQ adjacent lanes of one
//     warp: lane t of the row scores keys t, t + TPR, ... of the tile
//     and owns output columns t, t + TPR, ...; row max and row sum are
//     warp shuffles within the TPR lanes;
//   * (m, l, acc) live in registers in float32 across the tiles;
//     probabilities go through shared memory to the P·V product;
//   * shared rows are padded by one float where a warp would read one
//     column of several rows, so those reads hit distinct banks.
//
// Tensor-core (wgmma) tiles fed by TMA are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, int BQ, int BK>
struct Smem {
  static constexpr int kQ = BQ * (D + 1);
  static constexpr int kK = BK * (D + 1);
  static constexpr int kV = BK * D;
  static constexpr int kP = BQ * (BK + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, long long sq, long long skv, float scale,
                       int causal) {
  constexpr int TPR = kThreads / BQ;   // lanes per query row
  constexpr int CPT = BK / TPR;        // scores per lane per tile
  constexpr int DPT = D / TPR;         // output columns per lane
  using S = Smem<D, BQ, BK>;
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D + 1], scaled
  float* ks = qs + S::kQ;              // [BK][D + 1]
  float* vs = ks + S::kK;              // [BK][D]
  float* ps = vs + S::kV;              // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const long long bh = blockIdx.y;
  const long long q0 = static_cast<long long>(blockIdx.x) * BQ;
  const long long kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const long long offset = skv - sq;
  const T* qb = q + (bh * sq + q0) * D;
  const T* kb = k + kvh * skv * D;
  const T* vb = v + kvh * skv * D;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int rr = idx / D, dd = idx % D;
    qs[rr * (D + 1) + dd] =
        q0 + rr < sq ? to_float(qb[static_cast<long long>(rr) * D + dd]) * scale
                     : 0.0f;
  }

  const long long n_kt = (skv + BK - 1) / BK;
  long long n_live = n_kt;
  if (causal) {
    const long long q_last = min(q0 + BQ - 1, sq - 1) + offset;
    n_live = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
  }
  const long long qpos = q0 + r + offset;

  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.0f;

  for (long long kt = 0; kt < n_live; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();                   // previous tile's K/V reads done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int rr = idx / D, dd = idx % D;
      const bool in = k0 + rr < skv;
      const long long at = (k0 + rr) * D + dd;
      ks[rr * (D + 1) + dd] = in ? to_float(kb[at]) : 0.0f;
      vs[rr * D + dd] = in ? to_float(vb[at]) : 0.0f;
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      const float qd = qs[r * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < CPT; ++i) s[i] += qd * ks[(t + TPR * i) * (D + 1) + dd];
    }
    float mx = kNegInf;
    bool ok[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const long long kpos = k0 + t + TPR * i;
      ok[i] = kpos < skv && (!causal || qpos >= kpos);
      s[i] = ok[i] ? s[i] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float rowsum = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.0f;
      rowsum += p;
      ps[r * (BK + 1) + t + TPR * i] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
    l = l * corr + rowsum;
    m = m_new;
    __syncwarp();                      // the row's P is written by its lanes
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float pc = ps[r * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += pc * vs[c * D + t + TPR * j];
    }
  }

  if (q0 + r < sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* ob = o + (bh * sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[t + TPR * j] = from_float<T>(acc[j] * inv);
  }
}

template <typename T, int D, int BQ, int BK>
int launch_tile(const T* q, const T* k, const T* v, T* o, long long b,
                long long hq, long long hkv, long long sq, long long skv,
                float scale, long long causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, BQ, BK>;
  const size_t smem = Smem<D, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
            static_cast<unsigned>(b * hq));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, static_cast<int>(hq),
                                           static_cast<int>(hkv), sq, skv,
                                           scale, static_cast<int>(causal));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, long long b,
             long long hq, long long hkv, long long sq, long long skv,
             float scale, long long causal, long long bq, long long bk,
             cudaStream_t stream) {
#define TILE(BQ_, BK_)                                                     \
  if (bq == BQ_ && bk == BK_)                                              \
    return launch_tile<T, D, BQ_, BK_>(q, k, v, o, b, hq, hkv, sq, skv,   \
                                       scale, causal, stream);
  TILE(16, 64) TILE(64, 64)
#undef TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, long long b,
           long long hq, long long hkv, long long sq, long long skv,
           long long d, float scale, long long causal, long long bq,
           long long bk, void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d == 64)
    return launch_d<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           bq, bk, stream);
  if (d == 128)
    return launch_d<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            bq, bk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, long long b,
                                   long long hq, long long hkv, long long sq,
                                   long long skv, long long d, float scale,
                                   long long causal, long long bq,
                                   long long bk, void* stream) {
  return launch<float>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, bq,
                       bk, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    long long b, long long hq, long long hkv,
                                    long long sq, long long skv, long long d,
                                    float scale, long long causal,
                                    long long bq, long long bk,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, scale,
                               causal, bq, bk, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
