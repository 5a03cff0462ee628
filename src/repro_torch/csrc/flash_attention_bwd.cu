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
//   * "mma" — bfloat16 at head dims 64 and 128: two kernels on the
//     tensor cores (warp-level mma.sync; see namespace tc below).
//   * "simt" — every other call (float32, other head dims): three
//     kernels on the CUDA cores in float32, launched in order on the
//     caller's stream:
//
//   (a) attention_bwd_preprocess — one CTA per (head, query tile):
//       recomputes each row's log-sum-exp over its visible keys (the
//       online max and sum of the forward, without the P·V product) and
//       delta = rowsum(do ∘ o), both float32, into a workspace.  The
//       three forward paths stay as they are: none writes an lse.
//   (b) attention_bwd_dq — one CTA per (head, query tile), walking the
//       kv tiles up to the causal band: P = exp(S - lse), dP = do·Vᵀ,
//       dS = P ∘ (dP - delta), dQ += scale · dS·K.
//   (c) attention_bwd_dkdv — one CTA per (kv head, kv tile), walking the
//       G query heads of its group and, for each, the query tiles that
//       see the kv tile: dV += Pᵀ·do, dK += scale · dSᵀ·Q.
//
// No atomics on either path: every output element is written once by
// one CTA, so the gradient is the same bits on every run.  Bound on the
// H100: operations (four products a visible (query, key) pair for the
// gradient, S twice).  "simt" runs them on the CUDA cores in float32, a
// 16 x 16 thread grid computing register micro-tiles from shared memory
// (rows padded by one float against bank conflicts); head dims:
// instances at 32, 64, 128 and 256, a d between two taking the wider
// instance with its columns past d read as zeros and not written; tiles
// 64 x 64 up to D = 128 and 32 x 32 at 256 (shared memory).  Launches
// are cut at 65,535 (batch, head) rows (the grid's y limit).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// "mma": bfloat16 at head dims 64 and 128 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
//
// Two kernels, four warps a CTA, each warp a strip of 16 rows, products
// as warp-level mma.sync.m16n8k16 (bf16 in, float32 accumulate) from
// bf16 tiles in shared memory (rows padded by 8 elements: the fragment
// loads hit 32 distinct banks):
//
//   * attention_bwd_dq_mma — one CTA per (head, 64 query rows).  delta =
//     rowsum(do ∘ o); pass 1 over the live kv tiles: S = Q·Kᵀ and the
//     online row max and sum, giving each row's log-sum-exp (base 2,
//     into the workspace for the second kernel); pass 2: S and
//     dP = dO·Vᵀ again, P = exp2(S·scale·log2 e - lse), dS = P ∘ (dP -
//     delta), dQ += dS·K, dS rounded to bf16 in registers (the S
//     accumulator's layout is the A operand's, so it never touches
//     shared memory).
//   * attention_bwd_dkdv_mma — one CTA per (kv head, 64 keys), walking
//     the group's query heads and the query tiles that see its keys:
//     Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with the keys as rows, so Pᵀ and dSᵀ
//     are A operands in registers: dV += Pᵀ·dO, dK += dSᵀ·Q.
//
// P and dS are rounded to bf16 for the second products (what the
// tensor cores take); everything else stays float32.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;             // four warps
constexpr int kRows = 64;                 // rows (queries or keys) a CTA
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Two floats as bf16, the first in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x D bf16 from a (.., D) tensor into shared memory with row stride
// D + 8, 16 bytes a thread; rows past n_rows read zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row0, long long n_rows,
                                          int rows) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < rows * V; idx += kThreads) {
    const int r = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = reinterpret_cast<const uint4*>(src + (row0 + r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

// The A fragment of rows r0.. of a row-major shared tile, k columns
// k0..k0+15 (lane: g = lane / 4, t = lane % 4).
template <int ST>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* x,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(x + (r0 + g) * ST + k0 + 2 * t);
  a[1] = ld32(x + (r0 + g + 8) * ST + k0 + 2 * t);
  a[2] = ld32(x + (r0 + g) * ST + k0 + 8 + 2 * t);
  a[3] = ld32(x + (r0 + g + 8) * ST + k0 + 8 + 2 * t);
}

// The A fragment (16 rows x k 16j..16j+15) from two n-tiles of a float
// accumulator (the C layout of tiles 2j and 2j+1 is the A layout).
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// B fragments where B[k][n] = y[n][k] (y row-major: n rows, k columns).
template <int ST>
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* y, int n0, int k0,
                                          int g, int t) {
  b0 = ld32(y + (n0 + g) * ST + k0 + 2 * t);
  b1 = ld32(y + (n0 + g) * ST + k0 + 8 + 2 * t);
}

// B fragments where B[k][n] = z[k][n] (z row-major: k rows, n columns).
template <int ST>
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* z, int k0, int n0,
                                          int g, int t) {
  const bf16* col = z + n0 + g;
  b0 = pack(col[(k0 + 2 * t) * ST], col[(k0 + 2 * t + 1) * ST]);
  b1 = pack(col[(k0 + 2 * t + 8) * ST], col[(k0 + 2 * t + 9) * ST]);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * 4 * kRows * (D + 8) + sizeof(float) * kRows;
}
template <int D, int BQ>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (2 * kRows + 2 * BQ) * (D + 8) +
         sizeof(float) * 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, float* __restrict__ lse2,
                     float* __restrict__ delta, bf16* __restrict__ dq,
                     int hq, int hkv, long long sq, long long skv,
                     float scale, int causal) {
  constexpr int BQ = kRows, BK = kRows, ST = D + 8;
  constexpr int NK = BK / 8, ND = D / 8, KD = D / 16, KK = BK / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BQ * ST;
  bf16* ks = dos + BQ * ST;
  bf16* vs = ks + BK * ST;
  float* delta_s = reinterpret_cast<float*>(vs + BK * ST);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long q0 = static_cast<long long>(blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  const long long offset = skv - sq;
  const long long kvh = kv_head(bh, hq, hkv);
  const bf16* qb = q + bh * sq * D;
  const bf16* ob = o + bh * sq * D;
  const bf16* db = dout + bh * sq * D;
  const bf16* kb = k + kvh * skv * D;
  const bf16* vb = v + kvh * skv * D;

  load_tile<D>(qs, qb, q0, sq, BQ);
  load_tile<D>(dos, db, q0, sq, BQ);
  {  // delta = rowsum(do ∘ o): two threads a row
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.0f;
    if (q0 + r < sq)
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
        acc += __bfloat162float(ob[(q0 + r) * D + c]) *
               __bfloat162float(db[(q0 + r) * D + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      if (q0 + r < sq) delta[bh * sq + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;                  // this warp's rows in the tile
  const long long qpos[2] = {q0 + r0 + g + offset, q0 + r0 + g + 8 + offset};
  const float sl2 = scale * kLog2e;
  const long long n_live = live_kv_tiles(q0, BQ, sq, skv, BK, causal);

  // Pass 1: each row's log-sum-exp (base 2) over its visible keys.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  for (long long kt = 0; kt < n_live; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();
    load_tile<D>(ks, kb, k0, skv, BK);
    __syncthreads();
    float s[NK][4] = {};
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      frag_a<ST>(a, qs, r0, kd * 16, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        frag_b_nk<ST>(b0, b1, ks, n * 8, kd * 16, g, t);
        mma(s[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long kpos = k0 + n * 8 + 2 * t + e;
          if (kpos < skv && (!causal || qpos[h] >= kpos))
            mx = fmaxf(mx, s[n][2 * h + e] * sl2);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long kpos = k0 + n * 8 + 2 * t + e;
          if (kpos < skv && (!causal || qpos[h] >= kpos))
            sum += exp2f(s[n][2 * h + e] * sl2 - m_new);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * exp2f(m[h] - m_new) + sum;
      m[h] = m_new;
    }
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    row_lse[h] = l[h] > 0.0f ? m[h] + log2f(l[h]) : INFINITY;
    row_delta[h] = delta_s[r];
    if (t == 0 && q0 + r < sq) lse2[bh * sq + q0 + r] = row_lse[h];
  }

  // Pass 2: dQ += dS·K.
  float acc[ND][4] = {};
  for (long long kt = 0; kt < n_live; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();
    load_tile<D>(ks, kb, k0, skv, BK);
    load_tile<D>(vs, vb, k0, skv, BK);
    __syncthreads();
    float s[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4], ad[4];
      frag_a<ST>(aq, qs, r0, kd * 16, g, t);
      frag_a<ST>(ad, dos, r0, kd * 16, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        frag_b_nk<ST>(b0, b1, ks, n * 8, kd * 16, g, t);
        mma(s[n], aq, b0, b1);
        frag_b_nk<ST>(b0, b1, vs, n * 8, kd * 16, g, t);
        mma(dp[n], ad, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        const long long kpos = k0 + n * 8 + 2 * t + (i & 1);
        const bool ok = kpos < skv && (!causal || qpos[h] >= kpos);
        const float p = ok ? exp2f(s[n][i] * sl2 - row_lse[h]) : 0.0f;
        s[n][i] = p * (dp[n][i] - row_delta[h]);       // dS
      }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t a[4];
      frag_from_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        frag_b_kn<ST>(b0, b1, ks, kk * 16, nd * 8, g, t);
        mma(acc[nd], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q0 + r0 + g + 8 * h;
    if (row >= sq) continue;
    bf16* out = dq + (bh * sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8 + 2 * t) =
          pack(acc[nd][2 * h] * scale, acc[nd][2 * h + 1] * scale);
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int hq,
                       int hkv, long long sq, long long skv, float scale,
                       int causal) {
  constexpr int BK = kRows, ST = D + 8;
  constexpr int NQ = BQ / 8, ND = D / 8, KD = D / 16, KQ = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BK * ST;
  bf16* qs = vs + BK * ST;
  bf16* dos = qs + BQ * ST;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * ST);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long k0 = static_cast<long long>(blockIdx.x) * BK;
  const long long bkv = blockIdx.y;
  const long long batch = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv;
  const long long offset = skv - sq;
  const int r0 = warp * 16;                  // this warp's keys in the tile
  const long long kpos[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const float sl2 = scale * kLog2e;

  load_tile<D>(ks, k + bkv * skv * D, k0, skv, BK);
  load_tile<D>(vs, v + bkv * skv * D, k0, skv, BK);

  float acc_k[ND][4] = {}, acc_v[ND][4] = {};
  const long long n_qt = (sq + BQ - 1) / BQ;
  long long qt0 = 0;
  if (causal) {
    const long long first = k0 - offset;
    qt0 = first <= 0 ? 0 : first / BQ;
  }
  for (int gh = 0; gh < group; ++gh) {
    const long long bh = batch * hq + kvh * group + gh;
    for (long long qt = qt0; qt < n_qt; ++qt) {
      const long long q0 = qt * BQ;
      __syncthreads();
      load_tile<D>(qs, q + bh * sq * D, q0, sq, BQ);
      load_tile<D>(dos, dout + bh * sq * D, q0, sq, BQ);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse2[bh * sq + q0 + r] : INFINITY;
        delta_s[r] = in ? delta[bh * sq + q0 + r] : 0.0f;
      }
      __syncthreads();
      float s[NQ][4] = {}, dp[NQ][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4];
        frag_a<ST>(ak, ks, r0, kd * 16, g, t);
        frag_a<ST>(av, vs, r0, kd * 16, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          frag_b_nk<ST>(b0, b1, qs, n * 8, kd * 16, g, t);
          mma(s[n], ak, b0, b1);
          frag_b_nk<ST>(b0, b1, dos, n * 8, kd * 16, g, t);
          mma(dp[n], av, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n * 8 + 2 * t + (i & 1);
          const long long qp = q0 + col + offset;
          const long long kp = kpos[i / 2];
          const bool ok = kp < skv && (!causal || qp >= kp);
          const float p = ok ? exp2f(s[n][i] * sl2 - lse_s[col]) : 0.0f;
          s[n][i] = p;                                   // Pᵀ
          dp[n][i] = p * (dp[n][i] - delta_s[col]);       // dSᵀ
        }
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        uint32_t ap[4], ads[4];
        frag_from_acc(ap, s[2 * kq], s[2 * kq + 1]);
        frag_from_acc(ads, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t b0, b1;
          frag_b_kn<ST>(b0, b1, dos, kq * 16, nd * 8, g, t);
          mma(acc_v[nd], ap, b0, b1);
          frag_b_kn<ST>(b0, b1, qs, kq * 16, nd * 8, g, t);
          mma(acc_k[nd], ads, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = kpos[h];
    if (row >= skv) continue;
    bf16* outk = dk + (bkv * skv + row) * D;
    bf16* outv = dv + (bkv * skv + row) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<uint32_t*>(outk + nd * 8 + 2 * t) =
          pack(acc_k[nd][2 * h] * scale, acc_k[nd][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(outv + nd * 8 + 2 * t) =
          pack(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
    }
  }
}

template <int D>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
               const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* lse2,
               float* delta, long long b, long long hq, long long hkv,
               long long sq, long long skv, float scale, long long causal,
               cudaStream_t stream) {
  constexpr int BQ = D <= 64 ? 64 : 32;      // dkdv's query tile
  auto kdq = attention_bwd_dq_mma<D>;
  auto kdkdv = attention_bwd_dkdv_mma<D, BQ>;
  cudaError_t err = allow_smem(kdq, dq_smem<D>());
  if (err == cudaSuccess) err = allow_smem(kdkdv, dkdv_smem<D, BQ>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ih = static_cast<int>(hq), ik = static_cast<int>(hkv);
  const int ic = static_cast<int>(causal);
  const long long step = std::max(1LL, kMaxGridY / hq);
  for (long long b0 = 0; b0 < b; b0 += step) {
    const long long nb = std::min(step, b - b0);
    const long long qoff = b0 * hq * sq * D, koff = b0 * hkv * skv * D;
    const long long roff = b0 * hq * sq;
    const dim3 qgrid(static_cast<unsigned>((sq + kRows - 1) / kRows),
                     static_cast<unsigned>(nb * hq));
    const dim3 kgrid(static_cast<unsigned>((skv + kRows - 1) / kRows),
                     static_cast<unsigned>(nb * hkv));
    kdq<<<qgrid, kThreads, dq_smem<D>(), stream>>>(
        q + qoff, k + koff, v + koff, o + qoff, dout + qoff, lse2 + roff,
        delta + roff, dq + qoff, ih, ik, sq, skv, scale, ic);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kdkdv<<<kgrid, kThreads, dkdv_smem<D, BQ>(), stream>>>(
        q + qoff, k + koff, v + koff, dout + qoff, lse2 + roff,
        delta + roff, dk + koff, dv + koff, ih, ik, sq, skv, scale, ic);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace tc

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* delta, long long b,
           long long hq, long long hkv, long long sq, long long skv,
           long long d, float scale, long long causal, void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d == 64)
      return tc::launch_mma<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b,
                                hq, hkv, sq, skv, scale, causal, stream);
    if (d == 128)
      return tc::launch_mma<128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 b, hq, hkv, sq, skv, scale, causal, stream);
  }
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
