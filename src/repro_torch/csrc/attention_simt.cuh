// The CUDA-core ("simt") attention path's building blocks, shared by the
// forward (csrc/flash_attention.cu: attention_simt) and the backward
// (csrc/flash_attention_bwd.cu: attention_bwd_lse, attention_bwd_dq_simt,
// attention_bwd_dkdv_simt).  float32 inside; q, k, v and the gradients in
// float32, bfloat16 or float16 (T), read and written natively.
//
// The path runs on the CUDA cores (67 TFLOP/s in float32 on the H100:
// wgmma has no full-float32 mode, and TF32 would miss the reference's
// 2e-5), so it is bound by operations and, before them, by how often a
// product reads shared memory.  Its design against both:
//
//   * Register-tiled products.  A thread owns a micro-tile: kRows rows
//     (query rows, or keys in dK/dV) of a score tile times the keys
//     tx + 16·j, and the same rows of the output times the columns
//     kCe·tx + 16·kCe·c + e.  Every shared-memory read is a 16-byte
//     (8-byte for 16-bit T) vector that feeds kRows or more FMAs.  A
//     warp is two row groups of 16 lanes, so the row operand is read by
//     16 lanes at one address (a broadcast) and the other by 16 lanes at
//     16 rows, which the row pitch D + 4 (16 bytes, or 8 for 16-bit T,
//     past a multiple of 128) spreads over distinct banks.
//   * Overlapped loads.  The streamed tiles (K and V in the forward and
//     dQ; Q, dO, lse and delta in dK/dV) go through a two-stage ring
//     filled by cp.async (zero-filled past d and past the sequence), so
//     tile t + 1 is in flight while tile t's products run.  A head dim
//     that is not a multiple of 4 (rows not 16-byte aligned) copies the
//     tile element by element instead, into the same ring.
//   * A full grid.  The launcher picks the query tile (16, 32 or 64 rows,
//     4 a thread, so 64, 128 or 256 threads) that puts two CTAs on each
//     SM where the shape allows; where even 16 rows leave the SMs short
//     of 512 threads each, the forward and dQ split each query tile's
//     key tiles into up to 4 parts, whose float32 partials a second
//     kernel merges in part order.  A 1-D grid walks any number of heads.
//
// Instances at widths 16, 32, 64, 128, 192 and 256; a head dim d between
// two takes the wider instance, its columns past d read as zeros and not
// written.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace simt {

constexpr int kRows = 4;      // query rows a thread (forward, dQ)
constexpr int kLanes = 16;    // lanes a row group
constexpr int kPad = 4;       // elements past D in a shared-memory row

// The tiles of an instance of width D.
template <int D>
struct Cfg {
  static constexpr int kLd = D + kPad;                        // row pitch
  // Keys a ring tile in the forward and in dQ.
  static constexpr int kFwdKeys = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  static constexpr int kDqKeys = D <= 128 ? 32 : 16;
  // dK/dV: keys a thread and a CTA (16 row groups), query rows a ring tile.
  static constexpr int kKeyRows = D <= 64 ? 4 : 2;
  static constexpr int kKeys = kLanes * kKeyRows;
  static constexpr int kQRows = D <= 32 ? 64 : (D <= 128 ? 32 : 16);
  // Output columns a lane: kNch chunks of kCe.
  static constexpr int kCe = D >= 64 ? 4 : D / kLanes;
  static constexpr int kNch = D / (kLanes * kCe);
  static constexpr int kCols = kNch * kCe;
  // Two CTAs of 256 threads an SM fit in registers (128 a thread) up to
  // D = 128; in dQ (S and dP both live) at D = 32 and 64 only, where
  // ptxas keeps it without a spill (D = 16 unrolls its loops whole).
  static constexpr int kMinBlocks = D <= 128 ? 2 : 1;
  static constexpr int kDqMinBlocks = D == 32 || D == 64 ? 2 : 1;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16(x);
  }
}

// N (1, 2 or 4) consecutive elements of shared memory as floats: one
// vector load.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x;
    f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

template <int N, typename T>
__device__ __forceinline__ void lds(const T* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = hopper::unpack2<T>(v.x), b = hopper::unpack2<T>(v.y);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = hopper::unpack2<T>(*reinterpret_cast<const uint32_t*>(p));
    f[0] = a.x;
    f[1] = a.y;
  } else {
    f[0] = to_f(*p);
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// `rows` rows of a tensor of row length d into a shared tile of pitch
// Cfg<D>::kLd, raw: rows row0 .. of src, zeros past `limit` rows and
// past column d.  With `vec` (d a multiple of 4, 16-byte aligned base)
// by cp.async in chunks of 4 elements, to be committed by the caller;
// else element by element.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row0, long long limit,
                                          int rows, int d, bool vec) {
  constexpr int kLd = Cfg<D>::kLd, kChunks = D / 4;
  if (vec) {
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool in = row0 + r < limit && c < d;
      constexpr int kBytes = static_cast<int>(4 * sizeof(T));
      hopper::cp_async<kBytes>(hopper::smem_u32(dst + r * kLd + c),
                               in ? src + (row0 + r) * d + c : src,
                               in ? kBytes : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = row0 + r < limit && c < d;
      dst[r * kLd + c] = in ? src[(row0 + r) * d + c] : from_f<T>(0.0f);
    }
  }
}

// The same rows as float32 times `mul`, by plain loads (resident
// operands, loaded once a CTA).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row0, long long limit,
                                          int rows, int d, float mul) {
  constexpr int kLd = Cfg<D>::kLd;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = row0 + r < limit && c < d;
    dst[r * kLd + c] = in ? to_f(src[(row0 + r) * d + c]) * mul : 0.0f;
  }
}

// acc[i][j] += Σ_e a[i][e] · b[tx + 16·j][e] over e < D: a the thread's R
// rows (float, pitch kLd), b a tile of T rows (pitch kLd).
template <int D, int R, int CN, typename T>
__device__ __forceinline__ void dot_rows(float (&acc)[R][CN], const float* a,
                                         const T* b, int tx) {
  constexpr int kLd = Cfg<D>::kLd;
#pragma unroll 4
  for (int e0 = 0; e0 < D; e0 += 4) {
    float av[R][4], bv[CN][4];
#pragma unroll
    for (int i = 0; i < R; ++i) lds<4>(a + i * kLd + e0, av[i]);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      lds<4>(b + (tx + kLanes * j) * kLd + e0, bv[j]);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          acc[i][j] = fmaf(av[i][x], bv[j][x], acc[i][j]);
  }
}

// acc[i][col] += Σ_c p[i][c] · b[c][col] over c < K: p the thread's R rows
// of a float tile (pitch pl), b a tile of T rows (pitch kLd); the
// thread's columns kCe·tx + 16·kCe·ch + e (acc index kCe·ch + e).
template <int D, int K, int R, typename T>
__device__ __forceinline__ void acc_cols(float (&acc)[R][Cfg<D>::kCols],
                                         const float* p, int pl, const T* b,
                                         int tx) {
  using C = Cfg<D>;
#pragma unroll 2
  for (int c0 = 0; c0 < K; c0 += 4) {
    float pv[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) lds<4>(p + i * pl + c0, pv[i]);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const T* row = b + (c0 + x) * C::kLd + C::kCe * tx;
#pragma unroll
      for (int ch = 0; ch < C::kNch; ++ch) {
        float bv[C::kCe];
        lds<C::kCe>(row + kLanes * C::kCe * ch, bv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < C::kCe; ++e)
            acc[i][C::kCe * ch + e] =
                fmaf(pv[i][x], bv[e], acc[i][C::kCe * ch + e]);
      }
    }
  }
}

// Column of a thread's output element (chunk ch, element e).
template <int D>
__device__ __forceinline__ int out_col(int tx, int ch, int e) {
  return Cfg<D>::kCe * (tx + kLanes * ch) + e;
}

// Shared memory of the forward at query tile bq.
template <typename T, int D>
constexpr size_t fwd_smem(int bq) {
  using C = Cfg<D>;
  return sizeof(float) * bq * (C::kLd + C::kFwdKeys + kPad)
         + sizeof(T) * 2 * 2 * C::kFwdKeys * C::kLd;
}

// Query tiles of bq rows: the CTA of 1-D block b walks part
// (b / n_bh) % parts of query tile n_qt - 1 - b / (n_bh·parts) (the
// last, heaviest causal tiles first) of (batch, query head) b % n_bh
// (the query heads of a kv group side by side, sharing its K/V in L2).
struct QueryTile {
  int q0;
  int part;
  long long bh;
};

__device__ __forceinline__ QueryTile query_tile(int bq, int sq,
                                                long long n_bh, int parts) {
  const long long n_qt = (sq + bq - 1) / bq;
  const long long blk = blockIdx.x, rest = blk / n_bh;
  return {static_cast<int>((n_qt - 1 - rest / parts) * bq),
          static_cast<int>(rest % parts), blk % n_bh};
}

// Part `part` of `parts` of n key tiles: [first, end).
struct TileRange {
  int first, end;
};

__device__ __forceinline__ TileRange part_range(int n, int part, int parts) {
  const int per = (n + parts - 1) / parts;
  return {min(n, part * per), min(n, (part + 1) * per)};
}

__device__ __forceinline__ long long kv_head(long long bh, int hq, int hkv) {
  return (bh / hq) * hkv + (bh % hq) / (hq / hkv);
}

// Key tiles of bk a query tile [q0, q0 + bq) walks: all, or, causal, up
// to the last key its last row sees.
__device__ __forceinline__ int live_tiles(int q0, int bq, int sq, int skv,
                                          int bk, int causal) {
  const int n = (skv + bk - 1) / bk;
  if (!causal) return n;
  const int last = min(q0 + bq, sq) - 1 + (skv - sq);
  return last < 0 ? 0 : min(n, last / bk + 1);
}

// The forward over one query tile (blockDim.x = 4·bq threads): the
// online softmax of S = (scale·log2 e·Q)·Kᵀ in base 2 and, with o, O =
// softmax·V.  lse (may be null): each row's log-sum-exp in base 2 of the
// scaled scores, m + log2 l, +inf for a row that sees no key, at
// lse[bh·lse_ld + row].  o null: the lse alone (no V, no P·V).  With
// parts > 1 the CTA walks its part of the key tiles and writes, for the
// merge, its rows' unnormalised acc (ws_acc, rows of d) and (m, l)
// (ws_ml), part-major over the B·Hq·Sq rows, instead of o and lse.
template <typename T, int D>
__device__ __forceinline__ void forward(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        T* __restrict__ o,
                                        float* __restrict__ lse, int lse_ld,
                                        int hq, int hkv, long long n_bh,
                                        int sq, int skv, int d,
                                        float scale_log2, int causal,
                                        bool vec, int parts = 1,
                                        float* __restrict__ ws_acc = nullptr,
                                        float* __restrict__ ws_ml = nullptr) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, BK = C::kFwdKeys, CN = BK / kLanes;
  constexpr int kPl = BK + kPad;
  constexpr int kStage = 2 * BK * kLd;            // T elements: K, then V
  extern __shared__ __align__(16) unsigned char simt_smem[];
  const int bq = blockDim.x / kRows;
  float* qs = reinterpret_cast<float*>(simt_smem);   // [bq][kLd], scaled
  float* ps = qs + bq * kLd;                         // [bq][kPl]
  T* ring = reinterpret_cast<T*>(ps + bq * kPl);     // 2 stages

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const QueryTile qt = query_tile(bq, sq, n_bh, parts);
  const int q0 = qt.q0;
  const long long bh = qt.bh;
  const long long kvh = kv_head(bh, hq, hkv);
  const int offset = skv - sq;
  const T* kb = k + kvh * skv * d;
  const T* vb = v + kvh * skv * d;
  const bool with_out = o != nullptr || parts > 1;
  const TileRange range =
      part_range(live_tiles(q0, bq, sq, skv, BK, causal), qt.part, parts);

  auto issue = [&](int t) {
    if (t < range.end) {
      T* st = ring + (t & 1) * kStage;
      load_tile<T, D>(st, kb, static_cast<long long>(t) * BK, skv, BK, d, vec);
      if (with_out)
        load_tile<T, D>(st + BK * kLd, vb, static_cast<long long>(t) * BK,
                        skv, BK, d, vec);
    }
    hopper::cp_async_commit();
  };
  issue(range.first);
  load_rows<T, D>(qs, q + bh * sq * d, q0, sq, bq, d, scale_log2);

  const int r0 = ty * kRows;
  float m[kRows], l[kRows], acc[kRows][C::kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) acc[i][e] = 0.0f;
  }

  for (int t = range.first; t < range.end; ++t) {
    issue(t + 1);
    hopper::cp_async_wait<1>();
    __syncthreads();                       // tile t (and Q) in place
    const T* ks = ring + (t & 1) * kStage;
    float s[kRows][CN];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
    dot_rows<D, kRows, CN>(s, qs + r0 * kLd, ks, tx);
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = q0 + r0 + i + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        if (kpos >= skv || (causal && kpos > pos)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      // A row that has seen no key keeps max −inf: shift by 0 instead.
      const float shift = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m[i] - shift);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < C::kCols; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = exp2f(s[i][j] - shift);
        l[i] += p;
        if (with_out) ps[(r0 + i) * kPl + tx + kLanes * j] = p;
      }
    }
    if (with_out) {
      __syncthreads();                     // the tile's P in place
      acc_cols<D, BK, kRows>(acc, ps + r0 * kPl, kPl, ks + BK * kLd, tx);
    }
    __syncthreads();                       // stage t & 1 and P read
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    const float li = group_sum(l[i]);
    if (row >= sq) continue;
    if (parts > 1) {
      const long long w = qt.part * n_bh * sq + bh * sq + row;
      if (tx == 0) {
        ws_ml[2 * w] = m[i];
        ws_ml[2 * w + 1] = li;
      }
#pragma unroll
      for (int ch = 0; ch < C::kNch; ++ch)
#pragma unroll
        for (int e = 0; e < C::kCe; ++e) {
          const int col = out_col<D>(tx, ch, e);
          if (col < d) ws_acc[w * d + col] = acc[i][C::kCe * ch + e];
        }
      continue;
    }
    if (lse != nullptr && tx == 0)
      lse[bh * lse_ld + row] = li > 0.0f ? m[i] + log2f(li) : INFINITY;
    if (with_out) {
      const float inv = li > 0.0f ? 1.0f / li : 0.0f;
      T* ob = o + (bh * sq + row) * d;
#pragma unroll
      for (int ch = 0; ch < C::kNch; ++ch)
#pragma unroll
        for (int e = 0; e < C::kCe; ++e) {
          const int col = out_col<D>(tx, ch, e);
          if (col < d) ob[col] = from_f<T>(acc[i][C::kCe * ch + e] * inv);
        }
    }
  }
}

}  // namespace simt
