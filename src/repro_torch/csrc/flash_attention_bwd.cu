// flash_attention_bwd: the gradient of flash_attention.  Given q (B, Hq,
// Sq, D), k/v (B, Hkv, Skv, D), the forward's output o (B, Hq, Sq, D) and
// its cotangent do (B, Hq, Sq, D), it writes dq (B, Hq, Sq, D) and dk/dv
// (B, Hkv, Skv, D), dk and dv summed over the Hq/Hkv query heads of each
// kv group.  float32 or bfloat16 in and out, float32 inside.
//
// Replaces no TPU kernel: the JAX package's Pallas flash_attention
// (src/repro/kernels/flash_attention.py) has no custom_vjp, and its models
// differentiate the jnp blocked attention.  The port's models run the
// CUDA forward on the card, so their gradient comes from this kernel;
// it computes what the gradient of the plain version ref.attention
// computes, with the forward's masking: query row i sits at absolute
// position i + (Skv - Sq) and sees key j iff j < Skv and, when causal,
// j <= that position; a row that sees no key gets zero gradient and
// gives none.
//
// Two paths, picked from the dtype and the head dim:
//
//   * "wgmma" — bfloat16 at head dims 64 and 128: TMA-fed warpgroup
//     products on the tensor cores, the log-sum-exp from the forward
//     (or recomputed by the dQ kernel), a causally balanced dK/dV grid;
//     see namespace wg below.
//   * "simt" — every other call (float32, other head dims): three
//     kernels on the CUDA cores in float32, launched in order on the
//     caller's stream:
//
//   (a) attention_bwd_preprocess — one CTA per (head, query tile):
//       recomputes each row's log-sum-exp over its visible keys (the
//       online max and sum of the forward, without the P·V product) and
//       delta = rowsum(do ∘ o), both float32, into a workspace.  Only
//       the forward's "wgmma" path writes an lse.
//   (b) attention_bwd_dq — one CTA per (head, query tile), walking the
//       kv tiles up to the causal band: P = exp(S - lse), dP = do·Vᵀ,
//       dS = P ∘ (dP - delta), dQ += scale · dS·K.
//   (c) attention_bwd_dkdv — one CTA per (kv head, kv tile), walking the
//       G query heads of its group and, for each, the query tiles that
//       see the kv tile: dV += Pᵀ·do, dK += scale · dSᵀ·Q.
//
// No atomics on either path: every output element is written once by
// one CTA (or, with "wgmma"'s head slices, summed from the slices'
// partials in slice order), so the gradient is the same bits on every
// run.  Bound on the H100: operations (seven products a visible (query,
// key) pair on "wgmma" at D = 64, eight at D = 128 and on "simt").
// "simt" runs them on the CUDA cores in float32, a 16 x 16 thread grid
// computing register micro-tiles from shared memory
// (rows padded by one float against bank conflicts); head dims:
// instances at 32, 64, 128 and 256, a d between two taking the wider
// instance with its columns past d read as zeros and not written; tiles
// 64 x 64 up to D = 128 and 32 x 32 at 256 (shared memory).  Launches
// are cut at 65,535 (batch, head) rows (the grid's y limit).  A kernel
// that cannot launch returns its CUDA error; a tensor map that cannot be
// encoded returns hopper::kNoEncoder or kBadTensorMap.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;            // a 16 x 16 thread grid
constexpr int kSide = 16;
constexpr float kNegInf = -1e30f;
constexpr long long kMaxGridY = 65535;

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

// Query and kv tile of an instance of width D.
template <int D> struct Tile {
  static constexpr int kQ = D <= 128 ? 64 : 32;
  static constexpr int kK = D <= 128 ? 64 : 32;
};

// Sum or max over the 16 lanes of one thread-grid row (lanes ty·16 ..
// ty·16 + 15 of a warp hold one query row's columns).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows x D of a (.., D)-strided tensor into shared memory with row stride
// D + 1, times `mul`; rows past `n_rows` and columns past d read zeros.
template <typename T, int D, bool kMasked>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row0, long long n_rows,
                                          int rows, int d, float mul) {
  const long long ld = kMasked ? d : D;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int rr = idx / D, dd = idx % D;
    const bool in = row0 + rr < n_rows && (!kMasked || dd < d);
    dst[rr * (D + 1) + dd] = in ? to_float(src[(row0 + rr) * ld + dd]) * mul
                                : 0.0f;
  }
}

// The kv head of flattened (batch, query head) row bh.
__device__ __forceinline__ long long kv_head(long long bh, int hq, int hkv) {
  return (bh / hq) * hkv + (bh % hq) / (hq / hkv);
}

// Key tiles a query tile [q0, q0 + BQ) walks: all of them, or, causal, up
// to the last key its last row sees.
__device__ __forceinline__ long long live_kv_tiles(long long q0, int bq,
                                                   long long sq,
                                                   long long skv, int bk,
                                                   int causal) {
  const long long n_kt = (skv + bk - 1) / bk;
  if (!causal) return n_kt;
  const long long q_last = min(q0 + bq - 1, sq - 1) + (skv - sq);
  return q_last < 0 ? 0 : min(n_kt, q_last / bk + 1);
}

// ---------------------------------------------------------------------------
// (a) lse and delta per query row
// ---------------------------------------------------------------------------

template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_bwd_preprocess(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ lse, float* __restrict__ delta,
                         int hq, int hkv, long long sq, long long skv, int d,
                         float scale, int causal) {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  constexpr int RI = BQ / kSide, CJ = BK / kSide;
  extern __shared__ float smem[];
  float* qs = smem;                      // [BQ][D + 1], scaled
  float* ks = qs + BQ * (D + 1);         // [BK][D + 1]

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const long long ld = kMasked ? d : D;
  const long long q0 = static_cast<long long>(blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  const long long offset = skv - sq;
  const T* qb = q + bh * sq * ld;
  const T* kb = k + kv_head(bh, hq, hkv) * skv * ld;

  // delta: 16 lanes a row, columns strided by 16.
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = q0 + ty + kSide * i;
    float acc = 0.0f;
    if (row < sq) {
      const long long at = (bh * sq + row) * ld;
      for (int dd = tx; dd < d; dd += kSide)
        acc += to_float(o[at + dd]) * to_float(dout[at + dd]);
    }
    acc = row_sum(acc);
    if (tx == 0 && row < sq) delta[bh * sq + row] = acc;
  }

  load_rows<T, D, kMasked>(qs, qb, q0, sq, BQ, d, scale);
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) { m[i] = kNegInf; l[i] = 0.0f; }

  const long long n_live = live_kv_tiles(q0, BQ, sq, skv, BK, causal);
  for (long long kt = 0; kt < n_live; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();                     // previous tile's reads done
    load_rows<T, D, kMasked>(ks, kb, k0, skv, BK, d, 1.0f);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + kSide * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + kSide * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long qpos = q0 + ty + kSide * i + offset;
      float mx = kNegInf;
      bool ok[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const long long kpos = k0 + tx + kSide * j;
        ok[j] = kpos < skv && (!causal || qpos >= kpos);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) sum += ok[j] ? expf(s[i][j] - m_new) : 0.0f;
      sum = row_sum(sum);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long row = q0 + ty + kSide * i;
      // A row that sees no key: lse = +inf, so every P of it is 0.
      if (row < sq)
        lse[bh * sq + row] = l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// S = (scale·Q)·Kᵀ and dP = dO·Vᵀ of one (query tile, kv tile), then
// P = exp(S - lse) and dS = P ∘ (dP - delta), masked, into registers.
template <int D, int BQ, int BK>
__device__ __forceinline__ void tile_probs(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, long long q0, long long k0,
    long long offset, long long skv, int causal, int tx, int ty,
    float (&p)[BQ / kSide][BK / kSide], float (&ds)[BQ / kSide][BK / kSide]) {
  constexpr int RI = BQ / kSide, CJ = BK / kSide;
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) { s[i][j] = 0.0f; dp[i][j] = 0.0f; }
#pragma unroll 2
  for (int dd = 0; dd < D; ++dd) {
    float qv[RI], dv[RI], kv[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = qs[(ty + kSide * i) * (D + 1) + dd];
      dv[i] = dos[(ty + kSide * i) * (D + 1) + dd];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kv[j] = ks[(tx + kSide * j) * (D + 1) + dd];
      vv[j] = vs[(tx + kSide * j) * (D + 1) + dd];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += dv[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + kSide * i;
    const long long qpos = q0 + r + offset;
    const float row_lse = lse_s[r], row_delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const long long kpos = k0 + tx + kSide * j;
      const bool ok = kpos < skv && (!causal || qpos >= kpos);
      p[i][j] = ok ? expf(s[i][j] - row_lse) : 0.0f;
      ds[i][j] = p[i][j] * (dp[i][j] - row_delta);
    }
  }
}

// lse and delta of rows [row0, row0 + rows) into shared memory; rows past
// sq get lse = +inf (P = 0).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               long long base, long long row0,
                                               long long sq, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool in = row0 + r < sq;
    lse_s[r] = in ? lse[base + row0 + r] : INFINITY;
    delta_s[r] = in ? delta[base + row0 + r] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// (b) dQ: one CTA per (batch·query head, query tile)
// ---------------------------------------------------------------------------

template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int hq,
                 int hkv, long long sq, long long skv, int d, float scale,
                 int causal) {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  constexpr int RI = BQ / kSide, CJ = BK / kSide, EJ = D / kSide;
  extern __shared__ float smem[];
  float* qs = smem;                      // [BQ][D + 1], scaled
  float* dos = qs + BQ * (D + 1);        // [BQ][D + 1]
  float* ks = dos + BQ * (D + 1);        // [BK][D + 1]
  float* vs = ks + BK * (D + 1);         // [BK][D + 1]
  float* dss = vs + BK * (D + 1);        // [BQ][BK + 1]
  float* lse_s = dss + BQ * (BK + 1);    // [BQ]
  float* delta_s = lse_s + BQ;           // [BQ]

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const long long ld = kMasked ? d : D;
  const long long q0 = static_cast<long long>(blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  const long long offset = skv - sq;
  const long long kvh = kv_head(bh, hq, hkv);
  const T* kb = k + kvh * skv * ld;
  const T* vb = v + kvh * skv * ld;

  load_rows<T, D, kMasked>(qs, q + bh * sq * ld, q0, sq, BQ, d, scale);
  load_rows<T, D, kMasked>(dos, dout + bh * sq * ld, q0, sq, BQ, d, 1.0f);
  load_row_stats(lse_s, delta_s, lse, delta, bh * sq, q0, sq, BQ);

  float acc[RI][EJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < EJ; ++j) acc[i][j] = 0.0f;

  const long long n_live = live_kv_tiles(q0, BQ, sq, skv, BK, causal);
  for (long long kt = 0; kt < n_live; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();                     // previous tile's reads done
    load_rows<T, D, kMasked>(ks, kb, k0, skv, BK, d, 1.0f);
    load_rows<T, D, kMasked>(vs, vb, k0, skv, BK, d, 1.0f);
    __syncthreads();
    float p[RI][CJ], ds[RI][CJ];
    tile_probs<D, BQ, BK>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, offset,
                          skv, causal, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dss[(ty + kSide * i) * (BK + 1) + tx + kSide * j] = ds[i][j];
    __syncthreads();
    // dQ[r][e] += Σ_c dS[r][c] · K[c][e]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[EJ];
#pragma unroll
      for (int j = 0; j < EJ; ++j) kv[j] = ks[c * (D + 1) + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float dsv = dss[(ty + kSide * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < EJ; ++j) acc[i][j] += dsv * kv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = q0 + ty + kSide * i;
    if (row >= sq) continue;
    T* out = dq + (bh * sq + row) * ld;
#pragma unroll
    for (int j = 0; j < EJ; ++j) {
      const int col = tx + kSide * j;
      if (!kMasked || col < d) out[col] = from_float<T>(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dK, dV: one CTA per (batch·kv head, kv tile)
// ---------------------------------------------------------------------------

template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int hq, int hkv, long long sq,
                   long long skv, int d, float scale, int causal) {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  constexpr int RI = BQ / kSide, CJ = BK / kSide, EJ = D / kSide;
  extern __shared__ float smem[];
  float* ks = smem;                      // [BK][D + 1]
  float* vs = ks + BK * (D + 1);         // [BK][D + 1]
  float* qs = vs + BK * (D + 1);         // [BQ][D + 1], scaled
  float* dos = qs + BQ * (D + 1);        // [BQ][D + 1]
  float* ps = dos + BQ * (D + 1);        // [BQ][BK + 1]
  float* dss = ps + BQ * (BK + 1);       // [BQ][BK + 1]
  float* lse_s = dss + BQ * (BK + 1);    // [BQ]
  float* delta_s = lse_s + BQ;           // [BQ]

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const long long ld = kMasked ? d : D;
  const long long k0 = static_cast<long long>(blockIdx.x) * BK;
  const long long bkv = blockIdx.y;      // batch · hkv + kv head
  const long long batch = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv;
  const long long offset = skv - sq;

  load_rows<T, D, kMasked>(ks, k + bkv * skv * ld, k0, skv, BK, d, 1.0f);
  load_rows<T, D, kMasked>(vs, v + bkv * skv * ld, k0, skv, BK, d, 1.0f);

  float acc_k[CJ][EJ], acc_v[CJ][EJ];
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int j = 0; j < EJ; ++j) { acc_k[i][j] = 0.0f; acc_v[i][j] = 0.0f; }

  // The first query row that sees key k0: row i sees it iff
  // i + offset >= k0.
  const long long n_qt = (sq + BQ - 1) / BQ;
  long long qt0 = 0;
  if (causal) {
    const long long first = k0 - offset;
    qt0 = first <= 0 ? 0 : first / BQ;
  }
  for (int g = 0; g < group; ++g) {
    const long long bh = batch * hq + kvh * group + g;
    const T* qb = q + bh * sq * ld;
    const T* db = dout + bh * sq * ld;
    for (long long qt = qt0; qt < n_qt; ++qt) {
      const long long q0 = qt * BQ;
      __syncthreads();                   // previous tile's reads done
      load_rows<T, D, kMasked>(qs, qb, q0, sq, BQ, d, scale);
      load_rows<T, D, kMasked>(dos, db, q0, sq, BQ, d, 1.0f);
      load_row_stats(lse_s, delta_s, lse, delta, bh * sq, q0, sq, BQ);
      __syncthreads();
      float p[RI][CJ], ds[RI][CJ];
      tile_probs<D, BQ, BK>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, offset,
                            skv, causal, tx, ty, p, ds);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int at = (ty + kSide * i) * (BK + 1) + tx + kSide * j;
          ps[at] = p[i][j];
          dss[at] = ds[i][j];
        }
      __syncthreads();
      // dV[c][e] += Σ_r P[r][c] · dO[r][e];
      // dK[c][e] += Σ_r dS[r][c] · (scale·Q)[r][e]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float dov[EJ], qv[EJ];
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          dov[j] = dos[r * (D + 1) + tx + kSide * j];
          qv[j] = qs[r * (D + 1) + tx + kSide * j];
        }
#pragma unroll
        for (int i = 0; i < CJ; ++i) {
          const float pv = ps[r * (BK + 1) + ty + kSide * i];
          const float dsv = dss[r * (BK + 1) + ty + kSide * i];
#pragma unroll
          for (int j = 0; j < EJ; ++j) {
            acc_v[i][j] += pv * dov[j];
            acc_k[i][j] += dsv * qv[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const long long row = k0 + ty + kSide * i;
    if (row >= skv) continue;
    T* outk = dk + (bkv * skv + row) * ld;
    T* outv = dv + (bkv * skv + row) * ld;
#pragma unroll
    for (int j = 0; j < EJ; ++j) {
      const int col = tx + kSide * j;
      if (!kMasked || col < d) {
        outk[col] = from_float<T>(acc_k[i][j]);
        outv[col] = from_float<T>(acc_v[i][j]);
      }
    }
  }
}

template <int D> constexpr size_t pre_smem() {
  return sizeof(float) * (Tile<D>::kQ + Tile<D>::kK) * (D + 1);
}
template <int D> constexpr size_t dq_smem() {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  return sizeof(float) *
         ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}
template <int D> constexpr size_t dkdv_smem() {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  return sizeof(float) *
         ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool kMasked>
int launch_d(const T* q, const T* k, const T* v, const T* o, const T* dout,
             T* dq, T* dk, T* dv, float* lse, float* delta, long long b,
             long long hq, long long hkv, long long sq, long long skv,
             long long d, float scale, long long causal,
             cudaStream_t stream) {
  constexpr int BQ = Tile<D>::kQ, BK = Tile<D>::kK;
  auto pre = attention_bwd_preprocess<T, D, kMasked>;
  auto kdq = attention_bwd_dq<T, D, kMasked>;
  auto kdkdv = attention_bwd_dkdv<T, D, kMasked>;
  cudaError_t err = allow_smem(pre, pre_smem<D>());
  if (err == cudaSuccess) err = allow_smem(kdq, dq_smem<D>());
  if (err == cudaSuccess) err = allow_smem(kdkdv, dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ih = static_cast<int>(hq), ik = static_cast<int>(hkv);
  const int id = static_cast<int>(d), ic = static_cast<int>(causal);
  // Batches cut into launches of at most 65,535 (batch, head) rows.
  const long long step = std::max(1LL, kMaxGridY / hq);
  for (long long b0 = 0; b0 < b; b0 += step) {
    const long long nb = std::min(step, b - b0);
    const long long qoff = b0 * hq * sq * d, koff = b0 * hkv * skv * d;
    const long long roff = b0 * hq * sq;
    const dim3 qgrid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                     static_cast<unsigned>(nb * hq));
    const dim3 kgrid(static_cast<unsigned>((skv + BK - 1) / BK),
                     static_cast<unsigned>(nb * hkv));
    pre<<<qgrid, kThreads, pre_smem<D>(), stream>>>(
        q + qoff, k + koff, o + qoff, dout + qoff, lse + roff, delta + roff,
        ih, ik, sq, skv, id, scale, ic);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kdq<<<qgrid, kThreads, dq_smem<D>(), stream>>>(
        q + qoff, k + koff, v + koff, dout + qoff, lse + roff, delta + roff,
        dq + qoff, ih, ik, sq, skv, id, scale, ic);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kdkdv<<<kgrid, kThreads, dkdv_smem<D>(), stream>>>(
        q + qoff, k + koff, v + koff, dout + qoff, lse + roff, delta + roff,
        dk + koff, dv + koff, ih, ik, sq, skv, id, scale, ic);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// "wgmma": bfloat16 at head dims 64 and 128 on the tensor cores, TMA-fed
// ---------------------------------------------------------------------------
//
// Every kernel of this path but the two small ones is a CTA of two
// consumer warpgroups and one producer warpgroup, of which one thread
// issues TMA loads into shared memory (the resident operands once, the
// streamed ones into a three-stage ring signalled by full/empty mbarrier
// pairs).  setmaxnreg moves registers between the warpgroups of a CTA,
// within what the CTA was launched with (168 a thread at 384 threads):
// the producer drops to 24 and the consumers rise to 240, what dK and
// dV (D/2 floats each a thread) with Sᵀ and dPᵀ (32 each) need at
// D = 128.  Tensor
// maps are 3-D (D, S, B·H): a tile past Sq or Skv reads zeros inside its
// own head; with the 128-byte swizzle a box row is at most 64 bf16, so a
// D = 128 row is two boxes.  Every product is a wgmma: both operands in
// shared memory (K-major) where both come from global memory, and the
// first operand in registers where it is P or dS (an m64nN accumulator's
// layout is the A operand's, so P and dS never touch shared memory),
// with the second in shared memory as the MN-major B operand (the
// transpose bit).  P and dS are rounded to bf16 for those products;
// everything else stays float32.
//
// lse and delta are float32 rows of lse_ld (Sq rounded up to kLsePad) a
// (batch, query head); the rows past Sq are never read as values (the
// kernels mask them).  A call runs, in order on the caller's stream:
//
//   (a) attention_bwd_delta — delta = rowsum(dO ∘ O), a warp a few rows,
//       16 bytes a lane: bound by bytes, it reads O and dO once.
//   (b) attention_bwd_dq_wgmma — one CTA per (batch·query head, 128
//       query rows), Q and dO resident, a ring of (K, V) tiles of 64
//       keys: S = Q·Kᵀ, dP = dO·Vᵀ,
//       P = exp2(S·scale·log2 e − lse), dS = P ∘ (dP − delta),
//       dQ += dS·K.  The last (heaviest causal)
//       query tiles first, the query heads of one kv group side by side
//       (they share its K/V in L2).  Without an lse from the forward
//       (kLse), a first pass over the same tiles computes S alone and
//       each row's online max and sum, and stores the lse for (c).
//   (c) attention_bwd_dkdv_wgmma — one CTA per (key tile of 128,
//       query-head slice, batch·kv head), K and V resident, 64 keys a
//       warpgroup, a ring of (Q, dO, lse, delta) tiles of 64 query
//       rows over the slice's heads and the query tiles that see its
//       keys: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, Pᵀ and dSᵀ in registers,
//       dV += Pᵀ·dO, dK += dSᵀ·Q.  At D = 128 dK and dV hold 128
//       registers a thread, so the CTA walks its tiles twice: dV, then
//       dK with Sᵀ recomputed.  Key tiles in order, so the first CTAs
//       (whose keys the most query rows see) start first.  With one
//       slice the CTA writes dK and dV; with more, each slice writes
//       float32 partials to a workspace and
//   (d) attention_bwd_slice_sum adds them in slice order into dK and dV.
//
// The wrapper's `_bwd_plan` picks the slices (a divisor of Hq/Hkv) and
// `_bwd_ctas` lists (c)'s CTAs in this order.  Causal masks apply only on
// tiles that straddle the diagonal or the end of Sq / Skv; tiles above
// the band are skipped.  Seven products a visible (query, key) pair,
// eight at D = 128.

namespace wg {

using bf16 = __nv_bfloat16;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::sw128_desc;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = hopper::kBoxCols;
constexpr uint32_t kAtom = 1024;            // 8 swizzled rows of 128 bytes
constexpr int kStages = 3;
constexpr int kKeys = 128;     // (c): keys a CTA, 64 a warpgroup
constexpr int kBQ = 64;        // (c): query rows a ring tile
constexpr int kRows = 128;     // (b): query rows a CTA, 64 a warpgroup
constexpr int kBK = 64;        // (b): keys a ring tile
constexpr int kLsePad = 128;   // lse / delta rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;
// setmaxnreg.inc waits until the CTA's own pool holds the registers it
// asks for: a kernel built with fewer than 168 a thread would wait
// forever, so it is not launched.
constexpr int kRegisterBudget = -3;

// 2^x on the special-function unit (the forward's exp2f, without its
// denormal handling: probabilities below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A shared-memory descriptor at base + offset, computed where it is
// used: a loop-invariant descriptor hoisted out of the tile loop would
// hold two registers for every k-step.
__device__ __forceinline__ uint64_t desc_at(uint32_t base, uint32_t offset,
                                            uint32_t lbo) {
  uint32_t addr;
  asm volatile("add.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(base), "r"(offset));
  return sw128_desc(addr, lbo, kAtom);
}

// D (64 x N) (+)= A (64 x 16, registers) . B (16 x N, smem, MN-major),
// N = D.
template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    hopper::wgmma_m64n128k16_rs(acc, a, db, 1);
  } else {
    hopper::wgmma_m64n64k16_rs(acc, a, db, 1);
  }
}

// X (64 x 64) = A (64 rows of D, K-major) . B (64 rows of D, K-major)ᵀ
// over D in steps of 16: 32 bytes along a box row, then the next box;
// a_half and b_half are the byte sizes of one box of each.
template <int D>
__device__ __forceinline__ void mma_ss(float (&x)[32], uint32_t a,
                                       uint32_t a_half, uint32_t b,
                                       uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(x, desc_at(a, (kk / 4) * a_half + step, 16),
                               desc_at(b, (kk / 4) * b_half + step, 16),
                               kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, registers: a[4·kk ... 4·kk + 3] the k-step
// kk) . B (64 rows of D, MN-major; boxes `half` bytes apart).
template <int D>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[D / 2],
                                            const uint32_t (&a)[16],
                                            uint32_t b, uint32_t half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    mma_rs<D>(acc, ak, desc_at(b, kk * 16 * 128, half));
  }
}

// ---------------------------------------------------------------------------
// (a) delta = rowsum(dO ∘ O)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
attention_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int sq,
                    int lse_ld) {
  constexpr int kLanes = D / 8;                 // lanes a row, 8 bf16 each
  const int lane = threadIdx.x % 32;
  const long long warp = (static_cast<long long>(blockIdx.x) * 256
                          + threadIdx.x) / 32;
  const long long row = warp * (32 / kLanes) + lane / kLanes;
  float acc = 0.0f;
  if (row < rows) {
    const long long at = row * D + (lane % kLanes) * 8;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + at));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + at));
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
    const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16),
                 acc);
      acc = fmaf(__uint_as_float(wa[i] & 0xffff0000u),
                 __uint_as_float(wb[i] & 0xffff0000u), acc);
    }
  }
#pragma unroll
  for (int x = kLanes / 2; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (row < rows && lane % kLanes == 0)
    delta[(row / sq) * lse_ld + row % sq] = acc;
}

// ---------------------------------------------------------------------------
// (b) dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int kHalves = D / kBox;
  static constexpr uint32_t kQHalf = kRows * 128;   // one box of Q or dO
  static constexpr uint32_t kKHalf = kBK * 128;     // one box of K or V
  static constexpr uint32_t kQ = kHalves * kQHalf;
  static constexpr uint32_t kKV = kHalves * kKHalf;
  static constexpr uint32_t kDO = kQ;
  static constexpr uint32_t kK = 2 * kQ;                   // + stage · kKV
  static constexpr uint32_t kV = kK + kStages * kKV;       // + stage · kKV
  static constexpr uint32_t kBars = kV + kStages * kKV;    // 8 bytes each
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + kAtom;
};

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_wgmma(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_do,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int hq, int hkv, int n_bh, int sq, int skv, int lse_ld,
                       float scale, float scale_log2, int causal) {
  using L = DqLayout<D>;
  constexpr int kAcc = D / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + kAtom - 1)
                        & ~(kAtom - 1);
  const uint32_t s_q = base, s_do = base + L::kDO, s_k = base + L::kK,
                 s_v = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full = q_full + 8;                // + 8 · stage
  const uint32_t empty = full + 8 * kStages;       // + 8 · stage

  const int n_qt = (sq + kRows - 1) / kRows;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kRows;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offset = skv - sq;
  const int n_kt = (skv + kBK - 1) / kBK;
  int n_tiles = n_kt;
  if (causal) {
    const int last = min(q0 + kRows - 1, sq - 1) + offset;
    n_tiles = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: Q and dO once, then (K, V) tiles into the ring (twice
    // over with kLse: the lse pass, then the gradient pass).
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      // The maps' boxes are kBQ rows (the dK/dV kernel's tile).
      mbar_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
#pragma unroll
        for (int r = 0; r < kRows; r += kBQ) {
          const uint32_t at = h * L::kQHalf + r * 128;
          hopper::tma_load_3d(s_q + at, &tm_q, q_full, h * kBox, q0 + r, bh);
          hopper::tma_load_3d(s_do + at, &tm_do, q_full, h * kBox, q0 + r,
                              bh);
        }
      const int n_loads = kLse ? 2 * n_tiles : n_tiles;
      for (int i = 0; i < n_loads; ++i) {
        const int kt = i < n_tiles ? i : i - n_tiles;
        const int s = i % kStages, use = i / kStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          const uint32_t at = s * L::kKV + h * L::kKHalf;
          hopper::tma_load_3d(s_k + at, &tm_k, full + 8 * s, h * kBox,
                              kt * kBK, kvh);
          hopper::tma_load_3d(s_v + at, &tm_v, full + 8 * s, h * kBox,
                              kt * kBK, kvh);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    // Warpgroup wg owns query rows q0 + 64·wg ... + 63; lane l of warp w
    // in it owns rows r0 = 16·w + l/4 and r0 + 8 of those, and in every
    // 8 columns of an accumulator the two at 2·(l % 4).
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int pos0 = row0 + offset, pos1 = pos0 + 8;
    const int wg_first = q0 + wg * 64 + offset;
    const int wg_last = min(q0 + wg * 64 + 63, sq - 1) + offset;
    const int col = 2 * (lane % 4);
    const uint32_t s_qw = s_q + wg * 64 * 128, s_dow = s_do + wg * 64 * 128;
    float* lb = lse + static_cast<long long>(bh) * lse_ld;
    const float* db = delta + static_cast<long long>(bh) * lse_ld;
    // A tile needs masks where it crosses Skv or the causal diagonal.
    auto edge = [&](int k0) {
      return k0 + kBK > skv || (causal && k0 + kBK - 1 > wg_first);
    };
    auto masked = [&](int kpos, int pos) {
      return kpos >= skv || (causal && kpos > pos);
    };

    mbar_wait(q_full, 0);
    int i = 0;                                    // ring tiles consumed
    float lse0, lse1;
    if constexpr (kLse) {
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      for (int kt = 0; kt < n_tiles; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(full + 8 * s, (i / kStages) & 1);
        const int k0 = kt * kBK;
        if (!causal || k0 <= wg_last) {
          float sc[32];
          hopper::wgmma_fence();
          mma_ss<D>(sc, s_qw, L::kQHalf, s_k + s * L::kKV, L::kKHalf);
          hopper::wgmma_commit();
          hopper::wgmma_wait_all();
          hopper::fence_regs(sc);
          if (edge(k0)) {
#pragma unroll
            for (int x = 0; x < 32; ++x)
              if (masked(k0 + 8 * (x / 4) + col + (x & 1),
                         (x & 2) ? pos1 : pos0))
                sc[x] = -INFINITY;
          }
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
          }
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
          }
          // A row that has seen no key keeps max −inf: shift by 0.
          const float b0 = mx0 == -INFINITY ? 0.0f : mx0 * scale_log2;
          const float b1 = mx1 == -INFINITY ? 0.0f : mx1 * scale_log2;
          l0 *= ex2(fmaf(m0, scale_log2, -b0));
          l1 *= ex2(fmaf(m1, scale_log2, -b1));
          m0 = mx0;
          m1 = mx1;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            l0 += ex2(fmaf(sc[4 * j], scale_log2, -b0))
                  + ex2(fmaf(sc[4 * j + 1], scale_log2, -b0));
            l1 += ex2(fmaf(sc[4 * j + 2], scale_log2, -b1))
                  + ex2(fmaf(sc[4 * j + 3], scale_log2, -b1));
          }
        }
        mbar_arrive(empty + 8 * s);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      }
      lse0 = l0 > 0.0f ? fmaf(m0, scale_log2, log2f(l0)) : INFINITY;
      lse1 = l1 > 0.0f ? fmaf(m1, scale_log2, log2f(l1)) : INFINITY;
      if (lane % 4 == 0) {
        if (row0 < sq) lb[row0] = lse0;
        if (row0 + 8 < sq) lb[row0 + 8] = lse1;
      }
    } else {
      lse0 = lb[row0];
      lse1 = lb[row0 + 8];
    }
    const float delta0 = db[row0], delta1 = db[row0 + 8];

    float acc[kAcc];
#pragma unroll
    for (int x = 0; x < kAcc; ++x) acc[x] = 0.0f;
    for (int kt = 0; kt < n_tiles; ++kt, ++i) {
      const int s = i % kStages;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      const int k0 = kt * kBK;
      if (!causal || k0 <= wg_last) {
        float sc[32], dp[32];
        hopper::wgmma_fence();
        mma_ss<D>(sc, s_qw, L::kQHalf, s_k + s * L::kKV, L::kKHalf);
        mma_ss<D>(dp, s_dow, L::kQHalf, s_v + s * L::kKV, L::kKHalf);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        const bool on_edge = edge(k0);
        uint32_t ds[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float e[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const bool hi = x & 2;
            const float p = ex2(fmaf(sc[4 * j + x], scale_log2,
                                       -(hi ? lse1 : lse0)));
            e[x] = on_edge && masked(k0 + 8 * j + col + (x & 1),
                                     hi ? pos1 : pos0)
                       ? 0.0f
                       : p * (dp[4 * j + x] - (hi ? delta1 : delta0));
          }
          ds[2 * j] = pack(e[0], e[1]);
          ds[2 * j + 1] = pack(e[2], e[3]);
        }
        // dQ += dS·K: K as the MN-major B operand (its boxes kKHalf
        // apart).
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        mma_rs_tile<D>(acc, ds, s_k + s * L::kKV, L::kKHalf);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(acc);
      }
      mbar_arrive(empty + 8 * s);
    }

    bf16* out = dq + static_cast<long long>(bh) * sq * D;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int c = 8 * j + col;
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row0) * D
                                     + c) =
            pack(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row0 + 8 < sq)
        *reinterpret_cast<uint32_t*>(
            out + static_cast<long long>(row0 + 8) * D + c) =
            pack(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dK, dV
// ---------------------------------------------------------------------------

template <int D>
struct DkdvLayout {
  static constexpr int kHalves = D / kBox;
  static constexpr uint32_t kKHalf = kKeys * 128;   // one box of K or V
  static constexpr uint32_t kQHalf = kBQ * 128;     // one box of Q or dO
  static constexpr uint32_t kKV = kHalves * kKHalf;
  static constexpr uint32_t kQ = kHalves * kQHalf;
  static constexpr uint32_t kV = kKV;
  static constexpr uint32_t kQs = 2 * kKV;                    // + stage · kQ
  static constexpr uint32_t kDO = kQs + kStages * kQ;         // + stage · kQ
  static constexpr uint32_t kStat = kBQ * 4;                  // lse or delta
  static constexpr uint32_t kLse = kDO + kStages * kQ;        // + stage · 256
  static constexpr uint32_t kDelta = kLse + kStages * kStat;  // + stage · 256
  static constexpr uint32_t kBars = kDelta + kStages * kStat;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + kAtom;
};

// Pᵀ of one ring tile (this warpgroup's 64 keys x the tile's 64 query
// rows) in bf16 registers, in the A operand's layout: Sᵀ = K·Qᵀ, then
// exp2(Sᵀ·scale·log2 e − lse).  Where the tile crosses Sq or the causal
// diagonal (on_edge), masked elements are 0 and their bits set in off
// (keys past Skv only feed rows of dK and dV that are not written).
template <int D>
__device__ __forceinline__ void dkdv_probs(uint32_t (&p)[16], uint32_t& off,
                                           uint32_t s_kw, uint32_t s_qt,
                                           const float* lt, int q0, int key0,
                                           int col, int sq, int offset,
                                           int causal, bool on_edge,
                                           float scale_log2) {
  using L = DkdvLayout<D>;
  float st[32];
  hopper::wgmma_fence();
  mma_ss<D>(st, s_kw, L::kKHalf, s_qt, L::kQHalf);
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(st);
  off = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col;
    const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
    float e[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int qi = q0 + c + (x & 1);
      if (on_edge && (qi >= sq
                      || (causal && qi + offset < key0 + (x & 2) * 4)))
        off |= 1u << (4 * j + x);
      e[x] = off >> (4 * j + x) & 1
                 ? 0.0f
                 : ex2(fmaf(st[4 * j + x], scale_log2,
                            -((x & 1) ? l2.y : l2.x)));
    }
    p[2 * j] = pack(e[0], e[1]);
    p[2 * j + 1] = pack(e[2], e[3]);
  }
}

// dSᵀ = Pᵀ ∘ (dPᵀ − delta) in bf16 registers, from the bf16 Pᵀ.
__device__ __forceinline__ void dkdv_dscores(uint32_t (&ds)[16],
                                             const float (&dpt)[32],
                                             const uint32_t (&p)[16],
                                             uint32_t off, const float* dt,
                                             int col) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * j + col);
    float f[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const uint32_t w = p[2 * j + x / 2];
      const float pv = __uint_as_float((x & 1) ? w & 0xffff0000u : w << 16);
      f[x] = off >> (4 * j + x) & 1
                 ? 0.0f
                 : pv * (dpt[4 * j + x] - ((x & 1) ? d2.y : d2.x));
    }
    ds[2 * j] = pack(f[0], f[1]);
    ds[2 * j + 1] = pack(f[2], f[3]);
  }
}

// A warpgroup's dK or dV rows (keys key0 and key0 + 8 a lane) times
// `mul`: in bf16 to `out` with one slice, else as float32 partials to
// the workspace, slice-major (part 0 dK's, part 1 dV's), summed by (d).
template <int D>
__device__ __forceinline__ void dkdv_store(const float (&acc)[D / 2],
                                           bf16* out, float* ws, int part,
                                           int slice, int slices, int n_bkv,
                                           int bkv, int skv, int key0,
                                           int col, float mul) {
  const long long n = static_cast<long long>(n_bkv) * skv * D;
  const long long head = static_cast<long long>(bkv) * skv * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= skv) continue;
      const long long at = head + static_cast<long long>(key) * D + 8 * j
                           + col;
      const float x0 = acc[4 * j + 2 * h] * mul;
      const float x1 = acc[4 * j + 2 * h + 1] * mul;
      if (slices == 1)
        *reinterpret_cast<uint32_t*>(out + at) = pack(x0, x1);
      else
        *reinterpret_cast<float2*>(ws + (2 * slice + part) * n + at) =
            make_float2(x0, x1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_wgmma(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ ws, int hq, int hkv, int n_bkv,
                         int sq, int skv, int lse_ld, int slices, float scale,
                         float scale_log2, int causal) {
  using L = DkdvLayout<D>;
  constexpr int kAcc = D / 2;
  // At D = 128, dK and dV (64 floats each a thread) and a tile's Sᵀ and
  // dPᵀ do not fit in a consumer's registers together: two passes over
  // the query tiles, dV then dK, the second recomputing Sᵀ.
  constexpr int kPasses = D == 128 ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);
  const uint32_t s_k = base, s_v = base + L::kV, s_q = base + L::kQs,
                 s_do = base + L::kDO, s_lse = base + L::kLse,
                 s_delta = base + L::kDelta;
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;               // + 8 · stage
  const uint32_t empty = full + 8 * kStages;       // + 8 · stage

  // CTA -> (key tile, slice, batch·kv head), key tiles in order
  // (`_bwd_ctas` lists the same order).
  const int bkv = blockIdx.x % n_bkv;
  const int slice = (blockIdx.x / n_bkv) % slices;
  const int k0 = (blockIdx.x / n_bkv / slices) * kKeys;
  const int group = hq / hkv, per = group / slices;
  const int g0 = slice * per;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int offset = skv - sq;
  // The query tiles that see key k0: row i sees it iff i + offset >= k0.
  const int n_qt = (sq + kBQ - 1) / kBQ;
  int qt0 = 0;
  if (causal) {
    const int first = k0 - offset;
    qt0 = first <= 0 ? 0 : min(n_qt, first / kBQ);
  }
  const int n_q = n_qt - qt0;
  const int n_steps = per * n_q;                   // a pass

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: K and V once, then (Q, dO, lse, delta) tiles of the
    // slice's heads into the ring, once a pass.
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      // The maps' boxes are kBK keys (the dQ kernel's tile).
      mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
#pragma unroll
        for (int r = 0; r < kKeys; r += kBK) {
          const uint32_t at = h * L::kKHalf + r * 128;
          hopper::tma_load_3d(s_k + at, &tm_k, kv_full, h * kBox, k0 + r,
                              bkv);
          hopper::tma_load_3d(s_v + at, &tm_v, kv_full, h * kBox, k0 + r,
                              bkv);
        }
      for (int i = 0; i < kPasses * n_steps; ++i) {
        const int t = i % n_steps;
        const int bh = b * hq + kvh * group + g0 + t / n_q;
        const int q0 = (qt0 + t % n_q) * kBQ;
        const int s = i % kStages, use = i / kStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::kQ + 2 * L::kStat);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          const uint32_t at = s * L::kQ + h * L::kQHalf;
          hopper::tma_load_3d(s_q + at, &tm_q, bar, h * kBox, q0, bh);
          hopper::tma_load_3d(s_do + at, &tm_do, bar, h * kBox, q0, bh);
        }
        const long long row = static_cast<long long>(bh) * lse_ld + q0;
        hopper::bulk_load(s_lse + s * L::kStat, lse + row, L::kStat, bar);
        hopper::bulk_load(s_delta + s * L::kStat, delta + row, L::kStat,
                          bar);
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    // Warpgroup wg owns keys kw0 ... kw0 + 63; the accumulators' rows are
    // keys (key0 and key0 + 8 a lane), their columns query rows.
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int kw0 = k0 + wg * 64;
    const int key0 = kw0 + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    const uint32_t s_kw = s_k + wg * 64 * 128, s_vw = s_v + wg * 64 * 128;
    const float* lse_s = reinterpret_cast<const float*>(
        smem_raw + (s_lse - raw));
    const float* delta_s = reinterpret_cast<const float*>(
        smem_raw + (s_delta - raw));
    // Ring tile i: its stage, its first query row, and whether it sees
    // this warpgroup's keys (its last row sees key kw0) or lies above
    // the band; the tile needs masks where it crosses Sq or the causal
    // diagonal.
    auto stage = [](int i) { return i % kStages; };
    auto first_row = [&](int i) {
      return (qt0 + i % n_steps % n_q) * kBQ;
    };
    auto visible = [&](int q0) {
      return !causal || min(q0 + kBQ, sq) - 1 + offset >= kw0;
    };
    auto on_edge = [&](int q0) {
      return q0 + kBQ > sq || (causal && q0 + offset < kw0 + 63);
    };
    mbar_wait(kv_full, 0);

    if constexpr (kPasses == 1) {
      float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
      for (int x = 0; x < kAcc; ++x) {
        acc_k[x] = 0.0f;
        acc_v[x] = 0.0f;
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = stage(i), q0 = first_row(i);
        mbar_wait(full + 8 * s, (i / kStages) & 1);
        if (visible(q0)) {
          // Pᵀ first, before dPᵀ takes registers; then dPᵀ = V·dOᵀ and
          // dV += Pᵀ·dO (dO as the MN-major B operand), dSᵀ, and
          // dK += dSᵀ·Q (Q as the MN-major B operand).
          uint32_t p[16], ds[16];
          uint32_t off;
          dkdv_probs<D>(p, off, s_kw, s_q + s * L::kQ, lse_s + s * kBQ, q0,
                        key0, col, sq, offset, causal, on_edge(q0),
                        scale_log2);
          float dpt[32];
          hopper::fence_regs(acc_v);
          hopper::wgmma_fence();
          mma_ss<D>(dpt, s_vw, L::kKHalf, s_do + s * L::kQ, L::kQHalf);
          mma_rs_tile<D>(acc_v, p, s_do + s * L::kQ, L::kQHalf);
          hopper::wgmma_commit();
          hopper::wgmma_wait_all();
          hopper::fence_regs(dpt);
          hopper::fence_regs(acc_v);
          dkdv_dscores(ds, dpt, p, off, delta_s + s * kBQ, col);
          hopper::fence_regs(acc_k);
          hopper::wgmma_fence();
          mma_rs_tile<D>(acc_k, ds, s_q + s * L::kQ, L::kQHalf);
          hopper::wgmma_commit();
          hopper::wgmma_wait_all();
          hopper::fence_regs(acc_k);
        }
        mbar_arrive(empty + 8 * s);
      }
      dkdv_store<D>(acc_k, dk, ws, 0, slice, slices, n_bkv, bkv, skv, key0,
                    col, scale);
      dkdv_store<D>(acc_v, dv, ws, 1, slice, slices, n_bkv, bkv, skv, key0,
                    col, 1.0f);
    } else {
      {  // Pass 1: dV += Pᵀ·dO.
        float acc_v[kAcc];
#pragma unroll
        for (int x = 0; x < kAcc; ++x) acc_v[x] = 0.0f;
        for (int i = 0; i < n_steps; ++i) {
          const int s = stage(i), q0 = first_row(i);
          mbar_wait(full + 8 * s, (i / kStages) & 1);
          if (visible(q0)) {
            uint32_t p[16];
            uint32_t off;
            dkdv_probs<D>(p, off, s_kw, s_q + s * L::kQ, lse_s + s * kBQ,
                          q0, key0, col, sq, offset, causal, on_edge(q0),
                          scale_log2);
            hopper::fence_regs(acc_v);
            hopper::wgmma_fence();
            mma_rs_tile<D>(acc_v, p, s_do + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(acc_v);
          }
          mbar_arrive(empty + 8 * s);
        }
        dkdv_store<D>(acc_v, dv, ws, 1, slice, slices, n_bkv, bkv, skv,
                      key0, col, 1.0f);
      }
      {  // Pass 2: dSᵀ from Sᵀ again and dPᵀ, dK += dSᵀ·Q.
        float acc_k[kAcc];
#pragma unroll
        for (int x = 0; x < kAcc; ++x) acc_k[x] = 0.0f;
        for (int i = n_steps; i < 2 * n_steps; ++i) {
          const int s = stage(i), q0 = first_row(i);
          mbar_wait(full + 8 * s, (i / kStages) & 1);
          if (visible(q0)) {
            uint32_t p[16], ds[16];
            uint32_t off;
            dkdv_probs<D>(p, off, s_kw, s_q + s * L::kQ, lse_s + s * kBQ,
                          q0, key0, col, sq, offset, causal, on_edge(q0),
                          scale_log2);
            float dpt[32];
            hopper::wgmma_fence();
            mma_ss<D>(dpt, s_vw, L::kKHalf, s_do + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(dpt);
            dkdv_dscores(ds, dpt, p, off, delta_s + s * kBQ, col);
            hopper::fence_regs(acc_k);
            hopper::wgmma_fence();
            mma_rs_tile<D>(acc_k, ds, s_q + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(acc_k);
          }
          mbar_arrive(empty + 8 * s);
        }
        dkdv_store<D>(acc_k, dk, ws, 0, slice, slices, n_bkv, bkv, skv,
                      key0, col, scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (d) the slices' partial dK and dV, summed in slice order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
attention_bwd_slice_sum(const float* __restrict__ ws, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, long long n, int slices) {
  const long long n4 = n / 4;                    // D is a multiple of 4
  const float4* w = reinterpret_cast<const float4*>(ws);
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * 256) {
    float4 acc = w[i];
    for (int s = 1; s < slices; ++s) {
      const float4 x = w[2 * s * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    bf16* out = i < n4 ? dk + 4 * i : dv + 4 * (i - n4);
    *reinterpret_cast<uint2*>(out) = make_uint2(pack(acc.x, acc.y),
                                                pack(acc.z, acc.w));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Shared memory, and the check that the CTA's registers cover what its
// warpgroups ask for after setmaxnreg (see kRegisterBudget): once a
// kernel and device (the host's cost counts in a call this short).
template <auto kKernel>
int prepare(uint32_t smem) {
  constexpr int kDevices = 64;
  static int done[kDevices] = {};            // 0: not yet; else rc + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices && done[dev] != 0) return done[dev] - 1;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kKernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = kConsumers * kConsumerRegs
                   + (kThreads - kConsumers) * kProducerRegs;
  const int rc = attr.numRegs * kThreads >= need ? 0 : kRegisterBudget;
  if (dev < kDevices) done[dev] = rc + 1;
  return rc;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* lse,
           float* delta, float* ws, long long b, long long hq, long long hkv,
           long long sq, long long skv, long long lse_ld, float scale,
           long long causal, long long have_lse, long long slices,
           cudaStream_t stream) {
  const long long bhq = b * hq, bhkv = b * hkv;
  const int ic = static_cast<int>(causal), ild = static_cast<int>(lse_ld);
  const float sl2 = scale * kLog2e;
  // delta first: the card runs it while the host encodes the maps.
  const long long rows = bhq * sq;
  constexpr int kRowsPerBlock = 8 * (32 / (D / 8));
  attention_bwd_delta<D>
      <<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
         256, 0, stream>>>(o, dout, delta, rows, static_cast<int>(sq), ild);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // One map a tensor: boxes of kBQ query rows (the dK/dV tile; the
  // dQ kernel loads its 128 rows as several) and kBK keys (the dQ tile;
  // the dK/dV kernel loads its 128 keys as two).
  CUtensorMap qm, dom, km, vm;
  int rc = hopper::bf16_map(&qm, q, D, sq, bhq, kBQ);
  if (rc == 0) rc = hopper::bf16_map(&dom, dout, D, sq, bhq, kBQ);
  if (rc == 0) rc = hopper::bf16_map(&km, k, D, skv, bhkv, kBK);
  if (rc == 0) rc = hopper::bf16_map(&vm, v, D, skv, bhkv, kBK);
  if (rc != 0) return rc;
  auto kdq = have_lse ? attention_bwd_dq_wgmma<D, false>
                      : attention_bwd_dq_wgmma<D, true>;
  rc = have_lse ? prepare<attention_bwd_dq_wgmma<D, false>>(
                      DqLayout<D>::kBytes)
                : prepare<attention_bwd_dq_wgmma<D, true>>(
                      DqLayout<D>::kBytes);
  if (rc == 0)
    rc = prepare<attention_bwd_dkdv_wgmma<D>>(DkdvLayout<D>::kBytes);
  if (rc != 0) return rc;

  const long long n_qt = (sq + kRows - 1) / kRows;
  kdq<<<static_cast<unsigned>(n_qt * bhq), kThreads, DqLayout<D>::kBytes,
        stream>>>(qm, dom, km, vm, lse, delta, dq,
                  static_cast<int>(hq), static_cast<int>(hkv),
                  static_cast<int>(bhq), static_cast<int>(sq),
                  static_cast<int>(skv), ild, scale, sl2, ic);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_kt = (skv + kKeys - 1) / kKeys;
  attention_bwd_dkdv_wgmma<D>
      <<<static_cast<unsigned>(n_kt * slices * bhkv), kThreads,
         DkdvLayout<D>::kBytes, stream>>>(
      qm, dom, km, vm, lse, delta, dk, dv, ws, static_cast<int>(hq),
      static_cast<int>(hkv), static_cast<int>(bhkv), static_cast<int>(sq),
      static_cast<int>(skv), ild, static_cast<int>(slices), scale, sl2, ic);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);

  const long long n = bhkv * skv * D;
  const long long blocks = std::min((2 * n / 4 + 255) / 256, 132LL * 16);
  attention_bwd_slice_sum<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      ws, dk, dv, n, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* delta, long long b,
           long long hq, long long hkv, long long sq, long long skv,
           long long d, float scale, long long causal, void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WIDTH(D_)                                                          \
  if (d <= D_)                                                             \
    return d == D_ ? launch_d<T, D_, false>(q, k, v, o, dout, dq, dk, dv,  \
                                            lse, delta, b, hq, hkv, sq,    \
                                            skv, d, scale, causal, stream) \
                   : launch_d<T, D_, true>(q, k, v, o, dout, dq, dk, dv,   \
                                           lse, delta, b, hq, hkv, sq,     \
                                           skv, d, scale, causal, stream);
  WIDTH(32) WIDTH(64) WIDTH(128) WIDTH(256)
#undef WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse and delta: float32 workspaces of B·Hq·Sq each.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, float* dq, float* dk, float* dv, float* lse,
    float* delta, long long b, long long hq, long long hkv, long long sq,
    long long skv, long long d, float scale, long long causal,
    void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv,
                       sq, skv, d, scale, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse, float* delta,
    long long b, long long hq, long long hkv, long long sq, long long skv,
    long long d, float scale, long long causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, b,
                               hq, hkv, sq, skv, d, scale, causal, stream);
}

// "wgmma": bfloat16 at head dims 64 and 128.  lse and delta: float32
// rows of lse_ld (Sq rounded up to 128) a (batch, query head); lse holds
// the forward's log-sum-exp (base 2 of the scaled scores) when have_lse,
// else the dQ kernel writes it.  ws: slices·2·B·Hkv·Skv·D float32 when
// slices > 1 (a divisor of Hq/Hkv), else unused.
extern "C" int flash_attention_bwd_wgmma_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse, float* delta,
    float* ws, long long b, long long hq, long long hkv, long long sq,
    long long skv, long long d, long long lse_ld, float scale,
    long long causal, long long have_lse, long long slices, void* stream) {
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return 0;
  if (slices < 1 || (hq / hkv) % slices != 0 || lse_ld < sq
      || lse_ld % wg::kLsePad != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return wg::launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, b,
                          hq, hkv, sq, skv, lse_ld, scale, causal, have_lse,
                          slices, st);
  if (d == 128)
    return wg::launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, b,
                           hq, hkv, sq, skv, lse_ld, scale, causal, have_lse,
                           slices, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  if (code == wg::kRegisterBudget)
    return "a setmaxnreg kernel was built with too few registers";
  return hopper::error_string(code);
}
