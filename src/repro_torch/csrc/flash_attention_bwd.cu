// flash_attention_bwd: the gradient of flash_attention.  Given q (B, Hq,
// Sq, D), k/v (B, Hkv, Skv, D), the forward's output o (B, Hq, Sq, D) and
// its cotangent do (B, Hq, Sq, D), it writes dq (B, Hq, Sq, D) and dk/dv
// (B, Hkv, Skv, D), dk and dv summed over the Hq/Hkv query heads of each
// kv group.  float32, bfloat16 or float16 in and out, float32 inside.
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
// Two paths, picked from the dtype and the head dim (the wrapper's
// `_bwd_plan`):
//
//   * "wgmma" — bfloat16 or float16 at head dims d <= 128 with
//     d % 8 == 0 (instances of width 64 and 128, the tensor maps reading
//     zeros past d): TMA-fed warpgroup products on the tensor cores, the
//     log-sum-exp from the forward (or recomputed by the dQ kernel), a
//     causally balanced dK/dV grid; see namespace wg below.
//   * "simt" — every other call (float32; 16-bit types at d > 128 or
//     d % 8 != 0): register-tiled products on the CUDA cores in float32
//     fed by a cp.async ring (csrc/attention_simt.cuh), the lse from the
//     forward (recomputed by attention_bwd_lse when none is given), a
//     dK/dV grid split into parts that fills the SMs; see namespace
//     simt_bwd below.  Instances at widths 16, 32, 64, 128, 192 and 256,
//     a d between two taking the wider instance with its columns past d
//     read as zeros and not written.
//
// No atomics on either path: every output element is written once by
// one CTA (or summed from float32 partials in a fixed order), so the
// gradient is the same bits on every run.  Bound on the H100:
// operations (seven products a visible (query, key) pair on "wgmma" at
// D = 64, eight at D = 128, three more in float16 (kSplit); seven on
// "simt", S and dP in each of the dQ and dK/dV kernels).  1-D grids, so any number of heads
// launches once.  A kernel that cannot launch returns its CUDA error; a
// tensor map that cannot be encoded returns hopper::kNoEncoder or
// kBadTensorMap.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attention_simt.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Both paths: delta, and the partial dK / dV sums
// ---------------------------------------------------------------------------

// Σ x·y over the 16 bytes of two loads of T.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(x.x) * __uint_as_float(y.x)
           + __uint_as_float(x.y) * __uint_as_float(y.y)
           + __uint_as_float(x.z) * __uint_as_float(y.z)
           + __uint_as_float(x.w) * __uint_as_float(y.w);
  } else {
    const uint32_t a[4] = {x.x, x.y, x.z, x.w}, b[4] = {y.x, y.y, y.z, y.w};
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = hopper::unpack2<T>(a[i]), w = hopper::unpack2<T>(b[i]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
    return acc;
  }
}

// delta = rowsum(dO ∘ O) in float32, into rows of lse_ld: 8 lanes a row,
// 16 bytes a lane a step where rows are 16-byte multiples (vec), else one
// element; bound by bytes, it reads O and dO once.
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int sq, int d,
                    int lse_ld, int vec) {
  constexpr int kE = 16 / sizeof(T);
  const int sub = threadIdx.x % 8;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 8;
  float acc = 0.0f;
  if (row < rows) {
    const T* a = o + row * d;
    const T* b = dout + row * d;
    if (vec) {
      for (int c = sub * kE; c < d; c += 8 * kE)
        acc += dot16<T>(__ldg(reinterpret_cast<const uint4*>(a + c)),
                        __ldg(reinterpret_cast<const uint4*>(b + c)));
    } else {
      for (int c = sub; c < d; c += 8)
        acc = fmaf(simt::to_f(a[c]), simt::to_f(b[c]), acc);
    }
  }
#pragma unroll
  for (int x = 4; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (row < rows && sub == 0) delta[(row / sq) * lse_ld + row % sq] = acc;
}

// `outs` (1 or 2) tensors of n elements, a then b, from `slices`
// float32 partials (slice-major: slice s's partial of a at outs·s·n, of
// b at (outs·s + 1)·n), summed in slice order: no atomics, the same bits
// on every run.  dK and dV of the dK/dV kernels' slices or parts; dQ of
// the simt dQ kernel's parts.
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_slice_sum(const float* __restrict__ ws, T* __restrict__ dk,
                        T* __restrict__ dv, long long n, int slices,
                        int outs) {
  const long long start = static_cast<long long>(blockIdx.x) * 256
                          + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * 256;
  if (n % 4 == 0) {
    const long long n4 = n / 4;
    const float4* w = reinterpret_cast<const float4*>(ws);
    for (long long i = start; i < outs * n4; i += step) {
      float4 acc = w[i];
      for (int s = 1; s < slices; ++s) {
        const float4 x = w[outs * s * n4 + i];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      T* out = i < n4 ? dk + 4 * i : dv + 4 * (i - n4);
      out[0] = simt::from_f<T>(acc.x);
      out[1] = simt::from_f<T>(acc.y);
      out[2] = simt::from_f<T>(acc.z);
      out[3] = simt::from_f<T>(acc.w);
    }
  } else {
    for (long long i = start; i < outs * n; i += step) {
      float acc = ws[i];
      for (int s = 1; s < slices; ++s) acc += ws[outs * s * n + i];
      (i < n ? dk[i] : dv[i - n]) = simt::from_f<T>(acc);
    }
  }
}

template <typename T>
int launch_delta(const T* o, const T* dout, float* delta, long long rows,
                 long long sq, long long d, long long lse_ld,
                 cudaStream_t stream) {
  attention_bwd_delta<T><<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                           stream>>>(
      o, dout, delta, rows, static_cast<int>(sq), static_cast<int>(d),
      static_cast<int>(lse_ld), static_cast<int>(d * sizeof(T) % 16 == 0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slice_sum(const float* ws, T* dk, T* dv, long long n,
                     long long slices, cudaStream_t stream, int outs = 2) {
  const long long blocks = std::min((outs * n / 4 + 255) / 256, 132LL * 16);
  attention_bwd_slice_sum<T><<<static_cast<unsigned>(std::max(1LL, blocks)),
                               256, 0, stream>>>(
      ws, dk, dv, n, static_cast<int>(slices), outs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "simt": the CUDA cores, float32 inside (csrc/attention_simt.cuh)
// ---------------------------------------------------------------------------
//
// lse and delta are float32 rows of lse_ld (Sq rounded up to 128) a
// (batch, query head), as on "wgmma".  A call runs, in order:
//
//   (a) attention_bwd_delta (above).
//   (a') attention_bwd_lse — only when no lse is given: the forward's
//        online max and sum (simt::forward without V), storing the lse.
//   (b) attention_bwd_dq_simt — one CTA of 4·bq threads per (batch·query
//       head, query tile of bq rows, part of its key tiles), Q (scaled by
//       scale·log2 e) and dO resident, a cp.async ring of (K, V) tiles:
//       S = Q·Kᵀ, dP = dO·Vᵀ (register-tiled, 4 rows x the keys
//       tx + 16·j a thread), P = exp2(S − lse), dS = P ∘ (dP − delta)
//       through shared memory, dQ += dS·K (4 rows x the thread's
//       columns).  With more than one part, float32 partials that
//       attention_bwd_slice_sum adds in part order.
//   (c) attention_bwd_dkdv_simt — one CTA of 256 threads per (key tile,
//       part, batch·kv head), K and V resident, a cp.async ring of
//       (Q, dO, lse, delta) tiles over the part's share of the (query
//       head of the group, query tile that sees the keys) items:
//       Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, Pᵀ and dSᵀ through shared memory,
//       dV += Pᵀ·dO, dK += dSᵀ·Q.  With one part the CTA writes dK and
//       dV; with more, float32 partials that
//   (d) attention_bwd_slice_sum adds in part order.
//
// The wrapper's `_bwd_plan` picks the dK/dV parts (enough CTAs for two
// an SM, the longest no more than an SM's even share) and dQ's query
// tile and parts.

namespace simt_bwd {

using namespace ::simt;

template <typename T, int D>
__global__ void __launch_bounds__(256, Cfg<D>::kMinBlocks)
attention_bwd_lse(const T* __restrict__ q, const T* __restrict__ k,
                  float* __restrict__ lse, int lse_ld, int hq, int hkv,
                  long long n_bh, int sq, int skv, int d, float scale_log2,
                  int causal, int vec) {
  forward<T, D>(q, k, nullptr, nullptr, lse, lse_ld, hq, hkv, n_bh, sq, skv,
                d, scale_log2, causal, vec != 0);
}

template <typename T, int D>
constexpr size_t dq_smem(int bq) {
  using C = Cfg<D>;
  return sizeof(float) * bq * (2 * C::kLd + C::kDqKeys + kPad)
         + sizeof(T) * 2 * 2 * C::kDqKeys * C::kLd;
}

// 1-D grid of (query tiles) x (parts) x (B·Hq), as the forward;
// blockDim.x = 4·bq.  With parts > 1 a CTA walks its part of the key
// tiles and writes float32 partials of dQ (part-major, rows of d) to ws,
// summed in part order by attention_bwd_slice_sum.
template <typename T, int D>
__global__ void __launch_bounds__(256, Cfg<D>::kDqMinBlocks)
attention_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      float* __restrict__ ws, int hq, int hkv,
                      long long n_bh, int sq, int skv, int d, int lse_ld,
                      int parts, float scale, float scale_log2, int causal,
                      int vec) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, BK = C::kDqKeys, CN = BK / kLanes;
  constexpr int kPl = BK + kPad;
  constexpr int kStage = 2 * BK * kLd;             // T elements: K, then V
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq = blockDim.x / kRows;
  float* qs = reinterpret_cast<float*>(smem);      // [bq][kLd], scaled
  float* dos = qs + bq * kLd;                      // [bq][kLd]
  float* dss = dos + bq * kLd;                     // [bq][kPl]
  T* ring = reinterpret_cast<T*>(dss + bq * kPl);  // 2 stages

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const QueryTile qt = query_tile(bq, sq, n_bh, parts);
  const int q0 = qt.q0;
  const long long bh = qt.bh;
  const long long kvh = kv_head(bh, hq, hkv);
  const int offset = skv - sq;
  const T* kb = k + kvh * skv * d;
  const T* vb = v + kvh * skv * d;
  const TileRange range =
      part_range(live_tiles(q0, bq, sq, skv, BK, causal), qt.part, parts);
  const bool vec_ok = vec != 0;

  auto issue = [&](int t) {
    if (t < range.end) {
      T* st = ring + (t & 1) * kStage;
      const long long k0 = static_cast<long long>(t) * BK;
      load_tile<T, D>(st, kb, k0, skv, BK, d, vec_ok);
      load_tile<T, D>(st + BK * kLd, vb, k0, skv, BK, d, vec_ok);
    }
    hopper::cp_async_commit();
  };
  issue(range.first);
  load_rows<T, D>(qs, q + bh * sq * d, q0, sq, bq, d, scale_log2);
  load_rows<T, D>(dos, dout + bh * sq * d, q0, sq, bq, d, 1.0f);

  const int r0 = ty * kRows;
  float row_lse[kRows], row_delta[kRows], acc[kRows][C::kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    row_lse[i] = row < sq ? lse[bh * lse_ld + row] : INFINITY;
    row_delta[i] = row < sq ? delta[bh * lse_ld + row] : 0.0f;
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) acc[i][e] = 0.0f;
  }

  for (int t = range.first; t < range.end; ++t) {
    issue(t + 1);
    hopper::cp_async_wait<1>();
    __syncthreads();                       // tile t (and Q, dO) in place
    const T* ks = ring + (t & 1) * kStage;
    float sc[kRows][CN], dp[kRows][CN];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        sc[i][j] = 0.0f;
        dp[i][j] = 0.0f;
      }
    dot_rows<D, kRows, CN>(sc, qs + r0 * kLd, ks, tx);
    dot_rows<D, kRows, CN>(dp, dos + r0 * kLd, ks + BK * kLd, tx);
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i, pos = row + offset;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        const bool ok = row < sq && kpos < skv && (!causal || kpos <= pos);
        const float p = ok ? exp2f(sc[i][j] - row_lse[i]) : 0.0f;
        dss[(r0 + i) * kPl + tx + kLanes * j] =
            ok ? p * (dp[i][j] - row_delta[i]) : 0.0f;
      }
    }
    __syncthreads();                       // the tile's dS in place
    acc_cols<D, BK, kRows>(acc, dss + r0 * kPl, kPl, ks, tx);
    __syncthreads();                       // stage t & 1 and dS read
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    const long long at = (bh * sq + row) * d;
    float* part = ws + qt.part * n_bh * sq * d + at;
#pragma unroll
    for (int ch = 0; ch < C::kNch; ++ch)
#pragma unroll
      for (int e = 0; e < C::kCe; ++e) {
        const int col = out_col<D>(tx, ch, e);
        if (col >= d) continue;
        const float x = acc[i][C::kCe * ch + e] * scale;
        if (parts == 1) {
          dq[at + col] = from_f<T>(x);
        } else {
          part[col] = x;
        }
      }
  }
}

template <typename T, int D>
constexpr size_t dkdv_smem() {
  using C = Cfg<D>;
  return sizeof(float) * (2 * C::kKeys * (C::kLd + C::kQRows + kPad)
                          + 2 * 2 * C::kQRows)
         + sizeof(T) * 2 * 2 * C::kQRows * C::kLd;
}

// 1-D grid: block b is (key tile b / (n_bkv·parts), part, batch·kv head
// b % n_bkv); 256 threads, 16 row groups of kKeyRows keys.
template <typename T, int D>
__global__ void __launch_bounds__(256, Cfg<D>::kMinBlocks)
attention_bwd_dkdv_simt(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ ws, int hq,
                        int hkv, int n_bkv, int sq, int skv, int d,
                        int lse_ld, int parts, float scale, float scale_log2,
                        int causal, int vec) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, RK = C::kKeyRows, BKV = C::kKeys;
  constexpr int BQ = C::kQRows, CN = BQ / kLanes, kPl = BQ + kPad;
  constexpr int kStage = 2 * BQ * kLd;             // T elements: Q, then dO
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);      // [BKV][kLd]
  float* vs = ks + BKV * kLd;                      // [BKV][kLd]
  float* ps = vs + BKV * kLd;                      // [BKV][kPl]
  float* dss = ps + BKV * kPl;                     // [BKV][kPl]
  float* stats = dss + BKV * kPl;                  // 2 stages x (lse, delta)
  T* ring = reinterpret_cast<T*>(stats + 2 * 2 * BQ);

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int bkv = static_cast<int>(blockIdx.x % n_bkv);
  const int part = static_cast<int>(blockIdx.x / n_bkv % parts);
  const int k0 = static_cast<int>(blockIdx.x / n_bkv / parts) * BKV;
  const int group = hq / hkv;
  const int batch = bkv / hkv, kvh = bkv % hkv;
  const int offset = skv - sq;
  // The query tiles that see key k0 (row i sees it iff i + offset >= k0),
  // times the group's heads: the items, split evenly over the parts.
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt0 = causal ? min(n_qt, max(0, k0 - offset) / BQ) : 0;
  const int n_q = n_qt - qt0;
  const int n_items = group * n_q;
  const int per = (n_items + parts - 1) / parts;
  const int it0 = min(n_items, part * per), it1 = min(n_items, it0 + per);
  const bool vec_ok = vec != 0;

  auto issue = [&](int it) {
    if (it < it1) {
      const int s = it & 1;
      const long long bh =
          static_cast<long long>(batch) * hq + kvh * group + it / n_q;
      const long long row0 = static_cast<long long>(qt0 + it % n_q) * BQ;
      T* st = ring + s * kStage;
      load_tile<T, D>(st, q + bh * sq * d, row0, sq, BQ, d, vec_ok);
      load_tile<T, D>(st + BQ * kLd, dout + bh * sq * d, row0, sq, BQ, d,
                      vec_ok);
      float* stat = stats + s * 2 * BQ;
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const bool in = row0 + i < sq;
        stat[i] = in ? lse[bh * lse_ld + row0 + i] : INFINITY;
        stat[BQ + i] = in ? delta[bh * lse_ld + row0 + i] : 0.0f;
      }
    }
    hopper::cp_async_commit();
  };
  issue(it0);
  const long long kv_base = static_cast<long long>(bkv) * skv * d;
  load_rows<T, D>(ks, k + kv_base, k0, skv, BKV, d, 1.0f);
  load_rows<T, D>(vs, v + kv_base, k0, skv, BKV, d, 1.0f);

  const int r0 = ty * RK;                          // the thread's keys
  float acc_k[RK][C::kCols], acc_v[RK][C::kCols];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) {
      acc_k[i][e] = 0.0f;
      acc_v[i][e] = 0.0f;
    }

  for (int it = it0; it < it1; ++it) {
    issue(it + 1);
    hopper::cp_async_wait<1>();
    __syncthreads();                       // item it (and K, V) in place
    const int s = it & 1;
    const T* qts = ring + s * kStage;
    const T* dots = qts + BQ * kLd;
    const float* lse_t = stats + s * 2 * BQ;
    const float* delta_t = lse_t + BQ;
    const int row0 = (qt0 + it % n_q) * BQ;
    float st[RK][CN], dpt[RK][CN];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        st[i][j] = 0.0f;
        dpt[i][j] = 0.0f;
      }
    dot_rows<D, RK, CN>(st, ks + r0 * kLd, qts, tx);
    dot_rows<D, RK, CN>(dpt, vs + r0 * kLd, dots, tx);
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int key = k0 + r0 + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + kLanes * j, qi = row0 + c;
        const bool ok = qi < sq && key < skv && (!causal || key <= qi + offset);
        const float p = ok ? exp2f(fmaf(st[i][j], scale_log2, -lse_t[c]))
                           : 0.0f;
        ps[(r0 + i) * kPl + c] = p;
        dss[(r0 + i) * kPl + c] = ok ? p * (dpt[i][j] - delta_t[c]) : 0.0f;
      }
    }
    __syncthreads();                       // the item's Pᵀ and dSᵀ in place
    acc_cols<D, BQ, RK>(acc_v, ps + r0 * kPl, kPl, dots, tx);
    acc_cols<D, BQ, RK>(acc_k, dss + r0 * kPl, kPl, qts, tx);
    __syncthreads();                       // stage s, Pᵀ and dSᵀ read
  }

  const long long n = static_cast<long long>(n_bkv) * skv * d;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + r0 + i;
    if (key >= skv) continue;
    const long long at = kv_base + static_cast<long long>(key) * d;
#pragma unroll
    for (int ch = 0; ch < C::kNch; ++ch)
#pragma unroll
      for (int e = 0; e < C::kCe; ++e) {
        const int col = out_col<D>(tx, ch, e);
        if (col >= d) continue;
        const float xk = acc_k[i][C::kCe * ch + e] * scale;
        const float xv = acc_v[i][C::kCe * ch + e];
        if (parts == 1) {
          dk[at + col] = from_f<T>(xk);
          dv[at + col] = from_f<T>(xv);
        } else {
          ws[2 * part * n + at + col] = xk;
          ws[(2 * part + 1) * n + at + col] = xv;
        }
      }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ws: the dK/dV parts' partials (2·parts·B·Hkv·Skv·d floats) when
// parts > 1, then dQ's (q_parts·B·Hq·Sq·d) when q_parts > 1.
template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* o, const T* dout,
             T* dq, T* dk, T* dv, float* lse, float* delta, float* ws,
             long long b, long long hq, long long hkv, long long sq,
             long long skv, long long d, long long lse_ld, float scale,
             long long causal, long long have_lse, long long parts,
             long long bq, long long q_parts, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long bhq = b * hq, bhkv = b * hkv;
  const int ih = static_cast<int>(hq), ik = static_cast<int>(hkv);
  const int isq = static_cast<int>(sq), iskv = static_cast<int>(skv);
  const int id = static_cast<int>(d), ild = static_cast<int>(lse_ld);
  const int ic = static_cast<int>(causal), vec = d % 4 == 0;
  const float sl2 = scale * kLog2e;
  int rc = launch_delta<T>(o, dout, delta, bhq * sq, sq, d, lse_ld, stream);
  if (rc != 0) return rc;
  const long long q_blocks = (sq + bq - 1) / bq * bhq;
  const long long dq_blocks = q_blocks * q_parts;
  float* ws_q = ws + (parts > 1 ? 2 * parts * bhkv * skv * d : 0);
  const long long kv_blocks = (skv + C::kKeys - 1) / C::kKeys * parts * bhkv;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned threads = static_cast<unsigned>(4 * bq);
  cudaError_t err;
  if (!have_lse) {
    const size_t smem = fwd_smem<T, D>(static_cast<int>(bq));
    err = allow_smem(attention_bwd_lse<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_lse<T, D><<<static_cast<unsigned>(q_blocks), threads, smem,
                              stream>>>(q, k, lse, ild, ih, ik, bhq, isq,
                                        iskv, id, sl2, ic, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem_dq = dq_smem<T, D>(static_cast<int>(bq));
  err = allow_smem(attention_bwd_dq_simt<T, D>, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_simt<T, D><<<static_cast<unsigned>(dq_blocks), threads,
                                smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, ws_q, ih, ik, bhq, isq, iskv, id, ild,
      static_cast<int>(q_parts), scale, sl2, ic, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_parts > 1) {
    rc = launch_slice_sum<T>(ws_q, dq, nullptr, bhq * sq * d, q_parts,
                             stream, 1);
    if (rc != 0) return rc;
  }
  const size_t smem_kv = dkdv_smem<T, D>();
  err = allow_smem(attention_bwd_dkdv_simt<T, D>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_simt<T, D><<<static_cast<unsigned>(kv_blocks), 256,
                                  smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, ws, ih, ik, static_cast<int>(bhkv),
      isq, iskv, id, ild, static_cast<int>(parts), scale, sl2, ic, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  return launch_slice_sum<T>(ws, dk, dv, bhkv * skv * d, parts, stream);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* delta, float* ws,
           long long b, long long hq, long long hkv, long long sq,
           long long skv, long long d, long long lse_ld, float scale,
           long long causal, long long have_lse, long long parts,
           long long bq, long long q_parts, void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return 0;
  if ((bq != 16 && bq != 32 && bq != 64) || parts < 1 || q_parts < 1
      || lse_ld < sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WIDTH(D_)                                                          \
  if (d <= D_)                                                             \
    return launch_d<T, D_>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, b, \
                           hq, hkv, sq, skv, d, lse_ld, scale, causal,     \
                           have_lse, parts, bq, q_parts, stream);
  WIDTH(16) WIDTH(32) WIDTH(64) WIDTH(128) WIDTH(192) WIDTH(256)
#undef WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt_bwd

// ---------------------------------------------------------------------------
// "wgmma": bfloat16 or float16 at head dims up to 128 on the tensor cores
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
// D = 128.  An instance of width D (64 or 128) and element type T
// (bf16 or half) takes any d <= D with d % 8 == 0.  Tensor maps are 3-D
// (d, S, B·H) with boxes of 64 columns: a tile past Sq or Skv reads
// zeros inside its own head, and a row reads zeros past d, which add
// nothing to S or dP (the columns past d of dQ, dK and dV are zeros
// and are not stored); with the 128-byte swizzle a box row is at most
// 64 16-bit elements, so a D = 128 row is two boxes.  Every product is a wgmma: both operands in
// shared memory (K-major) where both come from global memory, and the
// first operand in registers where it is P or dS (an m64nN accumulator's
// layout is the A operand's, so P and dS never touch shared memory),
// with the second in shared memory as the MN-major B operand (the
// transpose bit).  P and dS are rounded to T for those products;
// everything else stays float32.
//
// lse and delta are float32 rows of lse_ld (Sq rounded up to kLsePad) a
// (batch, query head); the rows past Sq are never read as values (the
// kernels mask them).  A call runs, in order on the caller's stream:
//
//   (a) attention_bwd_delta — delta = rowsum(dO ∘ O) (above).
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

// float16 operands keep a product's P or dS to about 2^-22: the
// rounding's remainder, rounded again, is a second A operand of the same
// product (three products more a visible pair).  float16's 2e-3
// tolerance needs it at 1,024 causal keys in groups of 7 query heads:
// with one rounding, dV's error reaches the tolerance there.  bfloat16
// keeps one rounding (its tolerance is 2e-2).
template <typename T>
constexpr bool kSplit = hopper::kIsHalf<T>;

template <typename T>
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t rounded) {
  const float2 r = hopper::unpack2<T>(rounded);
  return hopper::pack2<T>(lo - r.x, hi - r.y);
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
// N = D; T operands.
template <typename T, int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    hopper::wgmma_m64n128k16_rs<T>(acc, a, db, 1);
  } else {
    hopper::wgmma_m64n64k16_rs<T>(acc, a, db, 1);
  }
}

// X (64 x 64) = A (64 rows of D, K-major) . B (64 rows of D, K-major)ᵀ
// over D in steps of 16: 32 bytes along a box row, then the next box;
// a_half and b_half are the byte sizes of one box of each.
template <typename T, int D>
__device__ __forceinline__ void mma_ss(float (&x)[32], uint32_t a,
                                       uint32_t a_half, uint32_t b,
                                       uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss<T>(x, desc_at(a, (kk / 4) * a_half + step, 16),
                               desc_at(b, (kk / 4) * b_half + step, 16),
                               kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, registers: a[4·kk ... 4·kk + 3] the k-step
// kk) . B (64 rows of D, MN-major; boxes `half` bytes apart).
template <typename T, int D>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[D / 2],
                                            const uint32_t (&a)[16],
                                            uint32_t b, uint32_t half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    mma_rs<T, D>(acc, ak, desc_at(b, kk * 16 * 128, half));
  }
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

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_wgmma(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_do,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int hq, int hkv, int n_bh, int sq, int skv, int d,
                       int lse_ld, float scale, float scale_log2, int causal) {
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
          mma_ss<T, D>(sc, s_qw, L::kQHalf, s_k + s * L::kKV, L::kKHalf);
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
        mma_ss<T, D>(sc, s_qw, L::kQHalf, s_k + s * L::kKV, L::kKHalf);
        mma_ss<T, D>(dp, s_dow, L::kQHalf, s_v + s * L::kKV, L::kKHalf);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        const bool on_edge = edge(k0);
        uint32_t ds[16], ds_rest[16];
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
          ds[2 * j] = hopper::pack2<T>(e[0], e[1]);
          ds[2 * j + 1] = hopper::pack2<T>(e[2], e[3]);
          if constexpr (kSplit<T>) {
            ds_rest[2 * j] = pack_rest<T>(e[0], e[1], ds[2 * j]);
            ds_rest[2 * j + 1] = pack_rest<T>(e[2], e[3], ds[2 * j + 1]);
          }
        }
        // dQ += dS·K: K as the MN-major B operand (its boxes kKHalf
        // apart).
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        mma_rs_tile<T, D>(acc, ds, s_k + s * L::kKV, L::kKHalf);
        if constexpr (kSplit<T>)
          mma_rs_tile<T, D>(acc, ds_rest, s_k + s * L::kKV, L::kKHalf);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(acc);
      }
      mbar_arrive(empty + 8 * s);
    }

    // Rows of d; the columns past d (zeros) are not stored.
    T* out = dq + static_cast<long long>(bh) * sq * d;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int c = 8 * j + col;
      if (c >= d) continue;
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row0) * d
                                     + c) =
            hopper::pack2<T>(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row0 + 8 < sq)
        *reinterpret_cast<uint32_t*>(
            out + static_cast<long long>(row0 + 8) * d + c) =
            hopper::pack2<T>(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
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
// rows) in T registers, in the A operand's layout: Sᵀ = K·Qᵀ, then
// exp2(Sᵀ·scale·log2 e − lse).  Where the tile crosses Sq or the causal
// diagonal (on_edge), masked elements are 0 and their bits set in off
// (keys past Skv only feed rows of dK and dV that are not written).
template <typename T, int D>
__device__ __forceinline__ void dkdv_probs(uint32_t (&p)[16],
                                           uint32_t (&p_rest)[16],
                                           uint32_t& off,
                                           uint32_t s_kw, uint32_t s_qt,
                                           const float* lt, int q0, int key0,
                                           int col, int sq, int offset,
                                           int causal, bool on_edge,
                                           float scale_log2) {
  using L = DkdvLayout<D>;
  float st[32];
  hopper::wgmma_fence();
  mma_ss<T, D>(st, s_kw, L::kKHalf, s_qt, L::kQHalf);
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
    p[2 * j] = hopper::pack2<T>(e[0], e[1]);
    p[2 * j + 1] = hopper::pack2<T>(e[2], e[3]);
    if constexpr (kSplit<T>) {
      p_rest[2 * j] = pack_rest<T>(e[0], e[1], p[2 * j]);
      p_rest[2 * j + 1] = pack_rest<T>(e[2], e[3], p[2 * j + 1]);
    }
  }
}

// dSᵀ = Pᵀ ∘ (dPᵀ − delta) in T registers, from the rounded Pᵀ (with
// kSplit, from Pᵀ and its remainder, and dSᵀ's own remainder beside it).
template <typename T>
__device__ __forceinline__ void dkdv_dscores(uint32_t (&ds)[16],
                                             uint32_t (&ds_rest)[16],
                                             const float (&dpt)[32],
                                             const uint32_t (&p)[16],
                                             const uint32_t (&p_rest)[16],
                                             uint32_t off, const float* dt,
                                             int col) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * j + col);
    float f[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float2 w = hopper::unpack2<T>(p[2 * j + x / 2]);
      if constexpr (kSplit<T>) {
        const float2 r = hopper::unpack2<T>(p_rest[2 * j + x / 2]);
        w.x += r.x;
        w.y += r.y;
      }
      const float pv = (x & 1) ? w.y : w.x;
      f[x] = off >> (4 * j + x) & 1
                 ? 0.0f
                 : pv * (dpt[4 * j + x] - ((x & 1) ? d2.y : d2.x));
    }
    ds[2 * j] = hopper::pack2<T>(f[0], f[1]);
    ds[2 * j + 1] = hopper::pack2<T>(f[2], f[3]);
    if constexpr (kSplit<T>) {
      ds_rest[2 * j] = pack_rest<T>(f[0], f[1], ds[2 * j]);
      ds_rest[2 * j + 1] = pack_rest<T>(f[2], f[3], ds[2 * j + 1]);
    }
  }
}

// A warpgroup's dK or dV rows (keys key0 and key0 + 8 a lane) times
// `mul`: in T to `out` with one slice, else as float32 partials to the
// workspace, slice-major (part 0 dK's, part 1 dV's), summed by (d).
// Rows of d; the columns past d are not stored.
template <typename T, int D>
__device__ __forceinline__ void dkdv_store(const float (&acc)[D / 2],
                                           T* out, float* ws, int part,
                                           int slice, int slices, int n_bkv,
                                           int bkv, int skv, int d, int key0,
                                           int col, float mul) {
  const long long n = static_cast<long long>(n_bkv) * skv * d;
  const long long head = static_cast<long long>(bkv) * skv * d;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (8 * j + col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= skv) continue;
      const long long at = head + static_cast<long long>(key) * d + 8 * j
                           + col;
      const float x0 = acc[4 * j + 2 * h] * mul;
      const float x1 = acc[4 * j + 2 * h + 1] * mul;
      if (slices == 1)
        *reinterpret_cast<uint32_t*>(out + at) = hopper::pack2<T>(x0, x1);
      else
        *reinterpret_cast<float2*>(ws + (2 * slice + part) * n + at) =
            make_float2(x0, x1);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_wgmma(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ ws, int hq, int hkv, int n_bkv,
                         int sq, int skv, int d, int lse_ld, int slices,
                         float scale, float scale_log2, int causal) {
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
          uint32_t p[16], p_rest[16], ds[16], ds_rest[16];
          uint32_t off;
          dkdv_probs<T, D>(p, p_rest, off, s_kw, s_q + s * L::kQ,
                           lse_s + s * kBQ, q0, key0, col, sq, offset, causal,
                           on_edge(q0), scale_log2);
          float dpt[32];
          hopper::fence_regs(acc_v);
          hopper::wgmma_fence();
          mma_ss<T, D>(dpt, s_vw, L::kKHalf, s_do + s * L::kQ, L::kQHalf);
          mma_rs_tile<T, D>(acc_v, p, s_do + s * L::kQ, L::kQHalf);
          if constexpr (kSplit<T>)
            mma_rs_tile<T, D>(acc_v, p_rest, s_do + s * L::kQ, L::kQHalf);
          hopper::wgmma_commit();
          hopper::wgmma_wait_all();
          hopper::fence_regs(dpt);
          hopper::fence_regs(acc_v);
          dkdv_dscores<T>(ds, ds_rest, dpt, p, p_rest, off,
                          delta_s + s * kBQ, col);
          hopper::fence_regs(acc_k);
          hopper::wgmma_fence();
          mma_rs_tile<T, D>(acc_k, ds, s_q + s * L::kQ, L::kQHalf);
          if constexpr (kSplit<T>)
            mma_rs_tile<T, D>(acc_k, ds_rest, s_q + s * L::kQ, L::kQHalf);
          hopper::wgmma_commit();
          hopper::wgmma_wait_all();
          hopper::fence_regs(acc_k);
        }
        mbar_arrive(empty + 8 * s);
      }
      dkdv_store<T, D>(acc_k, dk, ws, 0, slice, slices, n_bkv, bkv, skv, d,
                       key0, col, scale);
      dkdv_store<T, D>(acc_v, dv, ws, 1, slice, slices, n_bkv, bkv, skv, d,
                       key0, col, 1.0f);
    } else {
      {  // Pass 1: dV += Pᵀ·dO.
        float acc_v[kAcc];
#pragma unroll
        for (int x = 0; x < kAcc; ++x) acc_v[x] = 0.0f;
        for (int i = 0; i < n_steps; ++i) {
          const int s = stage(i), q0 = first_row(i);
          mbar_wait(full + 8 * s, (i / kStages) & 1);
          if (visible(q0)) {
            uint32_t p[16], p_rest[16];
            uint32_t off;
            dkdv_probs<T, D>(p, p_rest, off, s_kw, s_q + s * L::kQ,
                             lse_s + s * kBQ, q0, key0, col, sq, offset,
                             causal, on_edge(q0), scale_log2);
            hopper::fence_regs(acc_v);
            hopper::wgmma_fence();
            mma_rs_tile<T, D>(acc_v, p, s_do + s * L::kQ, L::kQHalf);
            if constexpr (kSplit<T>)
              mma_rs_tile<T, D>(acc_v, p_rest, s_do + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(acc_v);
          }
          mbar_arrive(empty + 8 * s);
        }
        dkdv_store<T, D>(acc_v, dv, ws, 1, slice, slices, n_bkv, bkv, skv,
                         d, key0, col, 1.0f);
      }
      {  // Pass 2: dSᵀ from Sᵀ again and dPᵀ, dK += dSᵀ·Q.
        float acc_k[kAcc];
#pragma unroll
        for (int x = 0; x < kAcc; ++x) acc_k[x] = 0.0f;
        for (int i = n_steps; i < 2 * n_steps; ++i) {
          const int s = stage(i), q0 = first_row(i);
          mbar_wait(full + 8 * s, (i / kStages) & 1);
          if (visible(q0)) {
            uint32_t p[16], p_rest[16], ds[16], ds_rest[16];
            uint32_t off;
            dkdv_probs<T, D>(p, p_rest, off, s_kw, s_q + s * L::kQ,
                             lse_s + s * kBQ, q0, key0, col, sq, offset,
                             causal, on_edge(q0), scale_log2);
            float dpt[32];
            hopper::wgmma_fence();
            mma_ss<T, D>(dpt, s_vw, L::kKHalf, s_do + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(dpt);
            dkdv_dscores<T>(ds, ds_rest, dpt, p, p_rest, off,
                            delta_s + s * kBQ, col);
            hopper::fence_regs(acc_k);
            hopper::wgmma_fence();
            mma_rs_tile<T, D>(acc_k, ds, s_q + s * L::kQ, L::kQHalf);
            if constexpr (kSplit<T>)
              mma_rs_tile<T, D>(acc_k, ds_rest, s_q + s * L::kQ, L::kQHalf);
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs(acc_k);
          }
          mbar_arrive(empty + 8 * s);
        }
        dkdv_store<T, D>(acc_k, dk, ws, 0, slice, slices, n_bkv, bkv, skv,
                         d, key0, col, scale);
      }
    }
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

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* delta, float* ws,
           long long b, long long hq, long long hkv, long long sq,
           long long skv, long long d, long long lse_ld, float scale,
           long long causal, long long have_lse, long long slices,
           cudaStream_t stream) {
  const long long bhq = b * hq, bhkv = b * hkv;
  const int ic = static_cast<int>(causal), ild = static_cast<int>(lse_ld);
  const int id = static_cast<int>(d);
  const float sl2 = scale * kLog2e;
  // delta first: the card runs it while the host encodes the maps.
  int rc = launch_delta<T>(o, dout, delta, bhq * sq, sq, d, lse_ld, stream);
  if (rc != 0) return rc;

  // One map a tensor: boxes of kBQ query rows (the dK/dV tile; the
  // dQ kernel loads its 128 rows as several) and kBK keys (the dQ tile;
  // the dK/dV kernel loads its 128 keys as two); reads past d are zeros.
  CUtensorMap qm, dom, km, vm;
  rc = hopper::tile_map<T>(&qm, q, d, sq, bhq, kBQ);
  if (rc == 0) rc = hopper::tile_map<T>(&dom, dout, d, sq, bhq, kBQ);
  if (rc == 0) rc = hopper::tile_map<T>(&km, k, d, skv, bhkv, kBK);
  if (rc == 0) rc = hopper::tile_map<T>(&vm, v, d, skv, bhkv, kBK);
  if (rc != 0) return rc;
  auto kdq = have_lse ? attention_bwd_dq_wgmma<T, D, false>
                      : attention_bwd_dq_wgmma<T, D, true>;
  rc = have_lse ? prepare<attention_bwd_dq_wgmma<T, D, false>>(
                      DqLayout<D>::kBytes)
                : prepare<attention_bwd_dq_wgmma<T, D, true>>(
                      DqLayout<D>::kBytes);
  if (rc == 0)
    rc = prepare<attention_bwd_dkdv_wgmma<T, D>>(DkdvLayout<D>::kBytes);
  if (rc != 0) return rc;

  const long long n_qt = (sq + kRows - 1) / kRows;
  kdq<<<static_cast<unsigned>(n_qt * bhq), kThreads, DqLayout<D>::kBytes,
        stream>>>(qm, dom, km, vm, lse, delta, dq,
                  static_cast<int>(hq), static_cast<int>(hkv),
                  static_cast<int>(bhq), static_cast<int>(sq),
                  static_cast<int>(skv), id, ild, scale, sl2, ic);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_kt = (skv + kKeys - 1) / kKeys;
  attention_bwd_dkdv_wgmma<T, D>
      <<<static_cast<unsigned>(n_kt * slices * bhkv), kThreads,
         DkdvLayout<D>::kBytes, stream>>>(
      qm, dom, km, vm, lse, delta, dk, dv, ws, static_cast<int>(hq),
      static_cast<int>(hkv), static_cast<int>(bhkv), static_cast<int>(sq),
      static_cast<int>(skv), id, ild, static_cast<int>(slices), scale, sl2,
      ic);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  return launch_slice_sum<T>(ws, dk, dv, bhkv * skv * d, slices, stream);
}

// The instance of width 64 (d <= 64) or 128; d % 8 == 0.
template <typename T>
int launch_width(const T* q, const T* k, const T* v, const T* o,
                 const T* dout, T* dq, T* dk, T* dv, float* lse,
                 float* delta, float* ws, long long b, long long hq,
                 long long hkv, long long sq, long long skv, long long d,
                 long long lse_ld, float scale, long long causal,
                 long long have_lse, long long slices, void* stream) {
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return 0;
  if (slices < 1 || (hq / hkv) % slices != 0 || lse_ld < sq
      || lse_ld % kLsePad != 0 || d < 8 || d > 128 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, b, hq,
                         hkv, sq, skv, d, lse_ld, scale, causal, have_lse,
                         slices, st);
  return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, b, hq,
                        hkv, sq, skv, d, lse_ld, scale, causal, have_lse,
                        slices, st);
}

}  // namespace wg

}  // namespace

// The C entry points.  lse and delta: float32 rows of lse_ld (Sq rounded
// up to 128) a (batch, query head); lse holds the forward's log-sum-exp
// (base 2 of the scaled scores) when have_lse, else the kernels write it.
// ws: slices·2·B·Hkv·Skv·d float32 when slices > 1, else unused.
//
// "simt": float32, bfloat16 or float16, any d <= 256; slices are the
// dK/dV kernel's parts, bq the dQ kernel's query tile (16, 32 or 64) and
// q_parts its parts; ws then also holds q_parts·B·Hq·Sq·d floats after
// the dK/dV partials when q_parts > 1.
#define SIMT_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* o,       \
                      const T* dout, T* dq, T* dk, T* dv, float* lse,       \
                      float* delta, float* ws, long long b, long long hq,   \
                      long long hkv, long long sq, long long skv,           \
                      long long d, long long lse_ld, float scale,           \
                      long long causal, long long have_lse,                 \
                      long long slices, long long bq, long long q_parts,    \
                      void* stream) {                                       \
    return simt_bwd::launch<T>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, \
                               b, hq, hkv, sq, skv, d, lse_ld, scale,       \
                               causal, have_lse, slices, bq, q_parts,       \
                               stream);                                     \
  }
SIMT_ENTRY(flash_attention_bwd_simt_f32, float)
SIMT_ENTRY(flash_attention_bwd_simt_bf16, __nv_bfloat16)
SIMT_ENTRY(flash_attention_bwd_simt_f16, __half)
#undef SIMT_ENTRY

// "wgmma": bfloat16 or float16 at d <= 128, d % 8 == 0; slices a divisor
// of Hq/Hkv.
#define WGMMA_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* o,       \
                      const T* dout, T* dq, T* dk, T* dv, float* lse,       \
                      float* delta, float* ws, long long b, long long hq,   \
                      long long hkv, long long sq, long long skv,           \
                      long long d, long long lse_ld, float scale,           \
                      long long causal, long long have_lse,                 \
                      long long slices, void* stream) {                     \
    return wg::launch_width<T>(q, k, v, o, dout, dq, dk, dv, lse, delta, ws, \
                               b, hq, hkv, sq, skv, d, lse_ld, scale,       \
                               causal, have_lse, slices, stream);           \
  }
WGMMA_ENTRY(flash_attention_bwd_wgmma_bf16, __nv_bfloat16)
WGMMA_ENTRY(flash_attention_bwd_wgmma_f16, __half)
#undef WGMMA_ENTRY

extern "C" const char* kernel_error_string(int code) {
  if (code == wg::kRegisterBudget)
    return "a setmaxnreg kernel was built with too few registers";
  return hopper::error_string(code);
}
