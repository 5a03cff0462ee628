// flash_attention: blocked online-softmax attention with GQA and an
// end-aligned causal diagonal.  q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)
// -> o (B, Hq, Sq, D), float32, bfloat16 or float16 in and out, float32
// inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel: (Bq x D).(D x Bk) MXU tiles, the (m, l,
// acc) recurrence in VMEM scratch across the sequential kv grid axis,
// causal blocks above the band skipped with pl.when, kv heads indexed
// through the BlockSpec map).  Query row i sits at absolute position
// i + (Skv - Sq); it sees key j iff j < Skv and, when causal, j <= that
// position.  A row that sees no key returns zeros, as the TPU kernel's
// does.  Head dims: any d <= 128 with d % 8 == 0 on "wgmma" (instances
// of width 64 and 128); any d <= 256 on "simt" and "split", through
// instances at the widths the configs use (16, 32, 64, 128, 192) and
// 256, where a d between two takes the wider instance with its columns
// past d masked (split's widths are multiples of 32).  Other float
// dtypes reach "split" (float16 too) as float32 (the wrapper casts in and
// out).
//
// Bound on the H100: operations for prefill (4·Sq·Skv·D per head,
// about halved by the causal band), bytes for decode (the KV cache is
// read once).  Three kernels; the wrapper's `_plan` picks one:
//
//   * "wgmma" (bfloat16 or float16, Sq > 16, d <= 128, d % 8 == 0): the
//     tensor cores.  A CTA of two
//     consumer warpgroups (64 query rows each, BQ = 128) and one
//     producer warp.  The producer issues TMA loads of the Q tile once
//     and of (K, V) tiles of BK = 64 rows into a two-stage ring,
//     signalled by full/empty mbarrier pairs.  Tensor maps are 3-D
//     (d, S, B·H) with boxes of the instance's width W (64 or 128), so a
//     tile past Sq or Skv reads zeros inside its own head, and a row of
//     d < W reads zeros past d: they add nothing to Q·Kᵀ, and the
//     columns of O past d are never stored.  With the 128-byte swizzle a
//     box row is at most 64 16-bit elements, so a W = 128 row is two
//     boxes.  S = Q·Kᵀ is wgmma m64n64k16 with K
//     as the K-major B operand; O += P·V is m64nWk16 with P in
//     registers (the S accumulator's layout is the A operand's, so P
//     never touches shared memory) and V as the MN-major B operand
//     (transpose bit).  The online softmax stays in float32 registers:
//     a row belongs to a quad of lanes, max and sum by two shuffles,
//     exp2f with scale·log2 e folded in.  Key positions past Skv are
//     masked in S (TMA's zero fill would score 0), causal masks only on
//     diagonal tiles, and tiles above a warpgroup's band are skipped.
//     The grid issues the last (heaviest causal) query tiles first and
//     puts the query heads of one kv group side by side, so they share
//     its K/V in L2.  The output is stored from registers.  Given an
//     lse pointer (a forward under autograd), the epilogue also stores
//     each row's log-sum-exp in base 2 of the scaled scores,
//     m·scale·log2 e + log2 l (+inf for a row that sees no key), which
//     the backward kernel reads.
//   * "split" (both dtypes, Sq <= 16: decode and short chunks): grid
//     (KV splits, B·Hkv, row blocks), launched per 65,535 kv heads.
//     A CTA loads its chunk of one kv head's K/V once, for all
//     (Hq/Hkv)·Sq query rows of that kv group
//     (up to 64 a CTA), one warp a row at a time and one lane a key,
//     on the CUDA cores (the path is bound by bytes), and writes
//     (m, l, acc[D]) per row in float32 to a workspace.  A second
//     kernel merges the splits in split order with log-sum-exp weights:
//     deterministic, no atomics; a split where a row sees no key weighs
//     0, a row that sees none at all gets zeros.
//   * "simt" (float32 prefill, and bfloat16 / float16 at head dims
//     "wgmma" lacks: d > 128 or d % 8 != 0): attention_simt, one CTA of
//     4·BQ threads per (head, query tile of BQ = 16, 32 or 64 rows), on
//     the CUDA cores in float32 with register-tiled products and a
//     cp.async ring of (K, V) tiles (csrc/attention_simt.cuh).  wgmma
//     has no full-float32 mode, and TF32 operands would miss the
//     reference's 2e-5 tolerance, so float32 prefill stays here.  Given
//     an lse pointer it stores each row's log-sum-exp as "wgmma" does.
//     Where even 16-row tiles leave the SMs short of threads, each query
//     tile's key tiles split into parts, merged (with the lse) by the
//     "split" path's attention_combine.
//
// A kernel that cannot launch returns its CUDA error; a tensor map that
// cannot be encoded returns hopper::kNoEncoder or kBadTensorMap.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attention_simt.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kMaxGridY = 65535;   // grid.y limit: more rows, more launches

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
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// "wgmma": bfloat16 or float16 prefill on the tensor cores, TMA-fed
// ---------------------------------------------------------------------------

namespace wg {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::sw128_desc;

constexpr int kBQ = 128;            // query rows a CTA: two warpgroups
constexpr int kBK = 64;             // kv rows a tile
constexpr int kStages = 2;          // (K, V) ring
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kBox = hopper::kBoxCols;   // 16-bit columns of a box row
constexpr uint32_t kAtom = 1024;    // 8 swizzled rows of 128 bytes

template <int D>
struct Layout {
  static constexpr int kHalves = D / kBox;
  static constexpr uint32_t kQHalf = kBQ * 128;   // one box of Q
  static constexpr uint32_t kKVHalf = kBK * 128;  // one box of K or V
  static constexpr uint32_t kQ = kHalves * kQHalf;
  static constexpr uint32_t kKV = kHalves * kKVHalf;
  static constexpr uint32_t kK = kQ;                     // + stage · kKV
  static constexpr uint32_t kV = kK + kStages * kKV;     // + stage · kKV
  static constexpr uint32_t kBars = kV + kStages * kKV;  // 8 bytes each
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + kAtom;
};

// An instance of width D (64 or 128) and element type T (bf16 or
// half) takes head dim d <= D (the maps read zeros past d; o is stored
// in rows of d).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_wgmma(__grid_constant__ const CUtensorMap tm_q,
                __grid_constant__ const CUtensorMap tm_k,
                __grid_constant__ const CUtensorMap tm_v,
                T* __restrict__ o, float* __restrict__ lse,
                int lse_ld, int hq, int hkv, int n_bh, int sq, int skv,
                int d, float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int kAcc = D / 2;                 // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle wants 1,024-byte aligned boxes.
  const uint32_t base = (hopper::smem_u32(smem_raw) + kAtom - 1)
                        & ~(kAtom - 1);
  const uint32_t s_q = base, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full = q_full + 8;                // + 8 · stage
  const uint32_t empty = full + 8 * kStages;       // + 8 · stage

  // Last query tiles first (the causal band makes them the heaviest);
  // the query heads of one kv group are neighbours in the grid.
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kBQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offset = skv - sq;
  const int n_kt = (skv + kBK - 1) / kBK;
  int n_tiles = n_kt;
  if (causal) {
    const int last = min(q0 + kBQ - 1, sq - 1) + offset;
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
    // Producer: Q once, then (K, V) tiles into the ring.
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
        hopper::tma_load_3d(s_q + h * L::kQHalf, &tm_q, q_full, h * kBox, q0,
                            bh);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          const uint32_t at = s * L::kKV + h * L::kKVHalf;
          hopper::tma_load_3d(s_k + at, &tm_k, full + 8 * s, h * kBox,
                              kt * kBK, kvh);
          hopper::tma_load_3d(s_v + at, &tm_v, full + 8 * s, h * kBox,
                              kt * kBK, kvh);
        }
      }
    }
    return;
  }

  // Consumers.  Warpgroup wg owns query rows q0 + 64·wg ... + 63; lane
  // l of warp w in it owns rows r0 = 16·w + l/4 and r0 + 8 of those, and
  // in every 8 columns of an accumulator the two at 2·(l % 4).
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int pos0 = row0 + offset, pos1 = pos0 + 8;
  const int wg_first = q0 + wg * 64 + offset;
  const int wg_last = min(q0 + wg * 64 + 63, sq - 1) + offset;
  const int col = 2 * (lane % 4);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const int k0 = kt * kBK;
    if (!causal || k0 <= wg_last) {
      // S = Q·Kᵀ over D in steps of 16: 32 bytes along a box row, then
      // the next box.
      float sc[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        const uint64_t da = sw128_desc(
            s_q + (kk / 4) * L::kQHalf + wg * 64 * 128 + step, 16, kAtom);
        const uint64_t db = sw128_desc(
            s_k + s * L::kKV + (kk / 4) * L::kKVHalf + step, 16, kAtom);
        hopper::wgmma_m64n64k16_ss<T>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);

      if (k0 + kBK > skv || (causal && k0 + kBK - 1 > wg_first)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
          const int pos = (i & 2) ? pos1 : pos0;
          if (kpos >= skv || (causal && kpos > pos)) sc[i] = -INFINITY;
        }
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
      // A row that has seen no key keeps max −inf: shift by 0 instead.
      const float b0 = mx0 == -INFINITY ? 0.0f : mx0 * scale_log2;
      const float b1 = mx1 == -INFINITY ? 0.0f : mx1 * scale_log2;
      const float c0 = exp2f(fmaf(m0, scale_log2, -b0));
      const float c1 = exp2f(fmaf(m1, scale_log2, -b1));
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
      // P in T, already in the A operand's register layout: the
      // four registers of k-step kk are p[4·kk ... 4·kk + 3].
      uint32_t p[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e0 = exp2f(fmaf(sc[4 * j], scale_log2, -b0));
        const float e1 = exp2f(fmaf(sc[4 * j + 1], scale_log2, -b0));
        const float e2 = exp2f(fmaf(sc[4 * j + 2], scale_log2, -b1));
        const float e3 = exp2f(fmaf(sc[4 * j + 3], scale_log2, -b1));
        l0 += e0 + e1;
        l1 += e2 + e3;
        p[2 * j] = hopper::pack2<T>(e0, e1);
        p[2 * j + 1] = hopper::pack2<T>(e2, e3);
      }
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // O += P·V over the tile's 64 kv rows in steps of 16 (2,048 bytes
      // of a box); the two 64-column boxes of V are LBO apart.
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        const uint64_t db = sw128_desc(s_v + s * L::kKV + kk * 16 * 128,
                                       L::kKVHalf, kAtom);
        if constexpr (D == 128) {
          hopper::wgmma_m64n128k16_rs<T>(acc, a, db, 1);
        } else {
          hopper::wgmma_m64n64k16_rs<T>(acc, a, db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
    }
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  if (lse != nullptr && lane % 4 == 0) {
    // Rows of a head lse_ld apart; a row that saw no key has l = 0.
    float* lb = lse + static_cast<long long>(bh) * lse_ld;
    if (row0 < sq)
      lb[row0] = l0 > 0.0f ? fmaf(m0, scale_log2, log2f(l0)) : INFINITY;
    if (row0 + 8 < sq)
      lb[row0 + 8] = l1 > 0.0f ? fmaf(m1, scale_log2, log2f(l1)) : INFINITY;
  }
  // Columns past d (zeros) are not stored; d % 8 == 0, so a pair at
  // c < d is whole.
  T* ob = o + static_cast<long long>(bh) * sq * d;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int c = 8 * j + col;
    if (c >= d) continue;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0) * d + c) =
          hopper::pack2<T>(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0 + 8) * d
                                   + c) =
          hopper::pack2<T>(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// "split": short query blocks, the kv axis split over CTAs, then merged
// ---------------------------------------------------------------------------

namespace split {

constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;           // keys a shared tile: one a lane
constexpr int kRows = 64;           // query rows a CTA at most
constexpr int kRowsPerWarp = kRows / kWarps;

// A 16-byte load as floats: four float32, or eight bfloat16 (a bf16 is
// the high half of the float with its bits).
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int D>
struct Smem {
  static constexpr int kK = kKeys * (D + 1);   // padded: lanes read rows
  static constexpr int kV = kKeys * D;
  static size_t bytes(int rows) {
    return sizeof(float) * (static_cast<size_t>(rows) * D + kK + kV);
  }
};

// Grid (splits, B·Hkv, row blocks), B·Hkv <= 65535 (the launcher cuts
// larger batches into such launches, each with its own workspace
// region).  Row r of a kv group is query head r / Sq of the group at
// query index r % Sq.  Writes, per row and split, m (the
// running max in log2 units), l and acc[d] unnormalised (rows of d
// floats in ws_acc).  kMasked: an instance of width D for a
// head dim d < D, scalar loads, columns past d zero and not written.
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_split(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, float* __restrict__ ws_acc,
                float* __restrict__ ws_ml, int hq, int hkv, int sq, int skv,
                int d, int chunk, float scale_log2, int causal) {
  constexpr int kVec = 16 / sizeof(T);          // elements a 16-byte load
  constexpr int kCols = D / 32;                 // output columns a lane
  extern __shared__ float smem[];
  const int group = hq / hkv;
  const int n_rows = group * sq;
  const int r_base = blockIdx.z * kRows;
  const int rows = min(kRows, n_rows - r_base);
  float* qs = smem;                             // [rows][D], scaled
  float* ks = qs + rows * D;                    // [kKeys][D + 1]
  float* vs = ks + Smem<D>::kK;                 // [kKeys][D]
  const int ld = kMasked ? d : D;               // row stride of q/k/v
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int offset = skv - sq;
  const long long total_rows = static_cast<long long>(gridDim.y) * group * sq;
  const int c0 = blockIdx.x * chunk;
  int c1 = min(skv, c0 + chunk);
  if (causal) c1 = min(c1, sq + offset);        // no row sees further

  const int bkv = blockIdx.y;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const T* kb = k + static_cast<long long>(bkv) * skv * ld;
  const T* vb = v + static_cast<long long>(bkv) * skv * ld;

  // Global row of local row r: ((b·Hq + h)·Sq + i).
  auto out_row = [&](int r) {
    const int g = (r_base + r) / sq, i = (r_base + r) % sq;
    return (static_cast<long long>(b) * hq + kvh * group + g) * sq + i;
  };
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    qs[idx] = !kMasked || dd < d
                  ? to_float(q[out_row(r) * ld + dd]) * scale_log2 : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[j][e] = 0.0f;
  }

  for (int t0 = c0; t0 < c1; t0 += kKeys) {
    __syncthreads();                // previous tile's reads done (and qs)
    if constexpr (kMasked) {
      for (int idx = tid; idx < kKeys * D; idx += kThreads) {
        const int key = idx / D, dd = idx % D;
        const long long at = static_cast<long long>(t0 + key) * ld + dd;
        const bool in = t0 + key < c1 && dd < d;
        ks[key * (D + 1) + dd] = in ? to_float(kb[at]) : 0.0f;
        vs[key * D + dd] = in ? to_float(vb[at]) : 0.0f;
      }
    } else {
      for (int idx = tid; idx < kKeys * D / kVec; idx += kThreads) {
        const int key = idx / (D / kVec), dd = (idx % (D / kVec)) * kVec;
        const long long at = static_cast<long long>(t0 + key) * D + dd;
        uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
        if (t0 + key < c1) {
          kr = __ldg(reinterpret_cast<const uint4*>(kb + at));
          vr = __ldg(reinterpret_cast<const uint4*>(vb + at));
        }
        float kf[kVec], vf[kVec];
        unpack(kr, kf);
        unpack(vr, vf);
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          ks[key * (D + 1) + dd + x] = kf[x];
          vs[key * D + dd + x] = vf[x];
        }
      }
    }
    __syncthreads();

    const int kpos = t0 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      if (r >= rows) continue;                // warp-uniform
      const int pos = (r_base + r) % sq + offset;
      float s = 0.0f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd)
        s = fmaf(qs[r * D + dd], ks[lane * (D + 1) + dd], s);
      const bool ok = kpos < c1 && (!causal || kpos <= pos);
      s = ok ? s : -INFINITY;
      float mx = s;
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[j], mx);
      const float shift = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m[j] - shift);
      const float p = exp2f(s - shift);
      m[j] = m_new;
      l[j] = l[j] * corr + p;                 // this lane's keys only
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[j][e] *= corr;
#pragma unroll 8
      for (int c = 0; c < kKeys; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[j][e] = fmaf(pc, vs[c * D + lane + 32 * e], acc[j][e]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + kWarps * j;
    if (r >= rows) continue;
    float lt = l[j];
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, x);
    const long long w = blockIdx.x * total_rows + out_row(r);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = lane + 32 * e;
      if (!kMasked || col < d) ws_acc[w * ld + col] = acc[j][e];
    }
    if (lane == 0) {
      ws_ml[2 * w] = m[j];
      ws_ml[2 * w + 1] = lt;
    }
  }
}

// Grid (B·Hq·Sq rows, D / 32): warp w of a CTA sums the splits
// s ≡ w (mod kWarps) for 32 columns of one row, one a lane; the warps'
// partial sums are then added in warp order.  Weights 2^(m_s − max m).
// lse (may be null; the "simt" forward's parts): the row's log-sum-exp
// in base 2, max m + log2 l, at lse[(row / sq)·lse_ld + row % sq].
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_combine(const float* __restrict__ ws_acc,
                  const float* __restrict__ ws_ml, T* __restrict__ o,
                  long long total_rows, int n_split, int d,
                  float* __restrict__ lse, int lse_ld, int sq) {
  extern __shared__ float weight[];           // [n_split]
  __shared__ float red[kWarps];
  __shared__ float part_acc[kWarps][32];
  __shared__ float part_l[kWarps];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.y * 32 + lane;
  const int ld = kMasked ? d : D;
  const bool live = !kMasked || c < d;         // a column past d: no output

  float mx = -INFINITY;
  for (int s = tid; s < n_split; s += kThreads)
    mx = fmaxf(mx, ws_ml[2 * (s * total_rows + row)]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  const bool lse_here = lse != nullptr && blockIdx.y == 0 && tid == 0;
  float* lse_at = lse_here ? lse + (row / sq) * lse_ld + row % sq : nullptr;
  if (mx == -INFINITY) {                       // the row sees no key
    if (warp == 0 && live) o[row * ld + c] = from_float<T>(0.0f);
    if (lse_here) *lse_at = INFINITY;
    return;
  }
  for (int s = tid; s < n_split; s += kThreads)
    weight[s] = exp2f(ws_ml[2 * (s * total_rows + row)] - mx);
  __syncthreads();
  float l = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int s = warp; s < n_split; s += kWarps) {
    const long long w = s * total_rows + row;
    l = fmaf(weight[s], ws_ml[2 * w + 1], l);
    if (live) acc = fmaf(weight[s], ws_acc[w * ld + c], acc);
  }
  part_acc[warp][lane] = acc;
  if (lane == 0) part_l[warp] = l;
  __syncthreads();
  if (warp == 0 && live) {
    l = part_l[0];
    acc = part_acc[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      l += part_l[w];
      acc += part_acc[w][lane];
    }
    o[row * ld + c] = from_float<T>(acc / l);
    if (lse_here) *lse_at = mx + log2f(l);
  }
}

}  // namespace split

// ---------------------------------------------------------------------------
// "simt": the CUDA cores, float32 inside (csrc/attention_simt.cuh)
// ---------------------------------------------------------------------------

namespace simt_fwd {

using namespace ::simt;

// 1-D grid of (query tiles) x (parts) x (B·Hq); blockDim.x = 4·bq.
template <typename T, int D>
__global__ void __launch_bounds__(256, Cfg<D>::kMinBlocks)
attention_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int lse_ld, int hq, int hkv,
               long long n_bh, int sq, int skv, int d, float scale_log2,
               int causal, int vec, int parts, float* __restrict__ ws_acc,
               float* __restrict__ ws_ml) {
  forward<T, D>(q, k, v, o, lse, lse_ld, hq, hkv, n_bh, sq, skv, d,
                scale_log2, causal, vec != 0, parts, ws_acc, ws_ml);
}

// parts > 1 (widths from 32): each query tile's key tiles split into
// parts, their partials in ws_acc / ws_ml merged by the split path's
// combine kernel, which also stores the lse.
template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, float* lse,
             long long lse_ld, long long b, long long hq, long long hkv,
             long long sq, long long skv, long long d, float scale,
             long long causal, long long bq, long long parts, float* ws_acc,
             float* ws_ml, cudaStream_t stream) {
  if (parts > 1 && D < 32) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_simt<T, D>;
  const size_t smem = fwd_smem<T, D>(static_cast<int>(bq));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (sq + bq - 1) / bq * parts * b * hq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(4 * bq), smem,
           stream>>>(q, k, v, o, lse, static_cast<int>(lse_ld),
                     static_cast<int>(hq), static_cast<int>(hkv), b * hq,
                     static_cast<int>(sq), static_cast<int>(skv),
                     static_cast<int>(d), scale * kLog2e,
                     static_cast<int>(causal), static_cast<int>(d % 4 == 0),
                     static_cast<int>(parts), ws_acc, ws_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  if constexpr (D >= 32) {
    const long long rows = b * hq * sq;
    auto combine = d == D ? split::attention_combine<T, D, false>
                          : split::attention_combine<T, D, true>;
    combine<<<dim3(static_cast<unsigned>(rows), D / 32), split::kThreads,
              static_cast<size_t>(parts) * sizeof(float), stream>>>(
        ws_acc, ws_ml, o, rows, static_cast<int>(parts), static_cast<int>(d),
        lse, static_cast<int>(lse_ld), static_cast<int>(sq));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* lse,
           long long lse_ld, long long b, long long hq, long long hkv,
           long long sq, long long skv, long long d, float scale,
           long long causal, long long bq, long long parts, float* ws_acc,
           float* ws_ml, void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  if ((bq != 16 && bq != 32 && bq != 64) || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WIDTH(D_)                                                         \
  if (d <= D_)                                                            \
    return launch_d<T, D_>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv,  \
                           d, scale, causal, bq, parts, ws_acc, ws_ml,    \
                           stream);
  WIDTH(16) WIDTH(32) WIDTH(64) WIDTH(128) WIDTH(192) WIDTH(256)
#undef WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt_fwd

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_wgmma(const T* q, const T* k, const T* v, T* o, float* lse,
                 long long lse_ld, long long b, long long hq, long long hkv,
                 long long sq, long long skv, long long d, float scale,
                 long long causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = hopper::tile_map<T>(&tm_q, q, d, sq, b * hq, wg::kBQ);
  if (rc == 0) rc = hopper::tile_map<T>(&tm_k, k, d, skv, b * hkv, wg::kBK);
  if (rc == 0) rc = hopper::tile_map<T>(&tm_v, v, d, skv, b * hkv, wg::kBK);
  if (rc != 0) return rc;
  auto kernel = wg::attention_wgmma<T, D>;
  const int smem = static_cast<int>(wg::Layout<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qt = (sq + wg::kBQ - 1) / wg::kBQ;
  kernel<<<static_cast<unsigned>(n_qt * b * hq), wg::kThreads, smem,
           stream>>>(tm_q, tm_k, tm_v, o, lse, static_cast<int>(lse_ld),
                     static_cast<int>(hq),
                     static_cast<int>(hkv), static_cast<int>(b * hq),
                     static_cast<int>(sq), static_cast<int>(skv),
                     static_cast<int>(d), scale * kLog2e,
                     static_cast<int>(causal));
  return static_cast<int>(cudaGetLastError());
}

// The instance of width 64 (d <= 64) or 128; d % 8 == 0 (TMA's 16-byte
// row pitch).
template <typename T>
int wgmma_d(const T* q, const T* k, const T* v, T* o, float* lse,
            long long lse_ld, long long b, long long hq, long long hkv,
            long long sq, long long skv, long long d, float scale,
            long long causal, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  if (d < 8 || d > 128 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_wgmma<T, 64>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv,
                               d, scale, causal, st);
  return launch_wgmma<T, 128>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv,
                              d, scale, causal, st);
}

template <typename T, int D, bool kMasked>
int launch_split(const T* q, const T* k, const T* v, T* o, float* ws_acc,
                 float* ws_ml, long long b, long long hq, long long hkv,
                 long long sq, long long skv, long long d, float scale,
                 long long causal, long long n_split, long long chunk,
                 cudaStream_t stream) {
  const long long n_rows = hq / hkv * sq;
  const int rows = static_cast<int>(n_rows < split::kRows ? n_rows
                                                          : split::kRows);
  auto kernel = split::attention_split<T, D, kMasked>;
  const int smem = static_cast<int>(split::Smem<D>::bytes(rows));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Batches cut into launches of at most 65,535 kv heads; launch c's
  // workspace is its own (splits, rows) block after the ones before.
  const long long step = std::max(1LL, kMaxGridY / hkv);
  for (long long b0 = 0; b0 < b; b0 += step) {
    const long long nb = std::min(step, b - b0);
    const dim3 grid(static_cast<unsigned>(n_split),
                    static_cast<unsigned>(nb * hkv),
                    static_cast<unsigned>((n_rows + split::kRows - 1)
                                          / split::kRows));
    kernel<<<grid, split::kThreads, smem, stream>>>(
        q + b0 * hq * sq * d, k + b0 * hkv * skv * d, v + b0 * hkv * skv * d,
        ws_acc, ws_ml, static_cast<int>(hq), static_cast<int>(hkv),
        static_cast<int>(sq), static_cast<int>(skv), static_cast<int>(d),
        static_cast<int>(chunk), scale * kLog2e, static_cast<int>(causal));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total_rows = nb * hq * sq;
    split::attention_combine<T, D, kMasked>
        <<<dim3(static_cast<unsigned>(total_rows), D / 32), split::kThreads,
           static_cast<size_t>(n_split) * sizeof(float), stream>>>(
            ws_acc, ws_ml, o + b0 * hq * sq * d, total_rows,
            static_cast<int>(n_split), static_cast<int>(d), nullptr, 0,
            static_cast<int>(sq));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ws_acc += n_split * total_rows * d;
    ws_ml += n_split * total_rows * 2;
  }
  return 0;
}

// The split path's widths: a multiple of 32 (a column a lane); a head
// dim between two takes the wider instance, masked.
template <typename T>
int split_d(const T* q, const T* k, const T* v, T* o, float* ws_acc,
            float* ws_ml, long long b, long long hq, long long hkv,
            long long sq, long long skv, long long d, float scale,
            long long causal, long long n_split, long long chunk,
            void* stream_ptr) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WIDTH(D_)                                                          \
  if (d <= D_)                                                             \
    return d == D_                                                         \
        ? launch_split<T, D_, false>(q, k, v, o, ws_acc, ws_ml, b, hq,     \
                                     hkv, sq, skv, d, scale, causal,       \
                                     n_split, chunk, stream)               \
        : launch_split<T, D_, true>(q, k, v, o, ws_acc, ws_ml, b, hq, hkv, \
                                    sq, skv, d, scale, causal, n_split,    \
                                    chunk, stream);
  WIDTH(32) WIDTH(64) WIDTH(128) WIDTH(192) WIDTH(256)
#undef WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// "simt": prefill on the CUDA cores, float32, bfloat16 or float16 in
// and out; bq (16, 32 or 64) query rows a CTA.  lse: null, or float32
// rows of lse_ld >= Sq a (batch, query head) for each row's log-sum-exp
// (base 2 of the scaled scores).  parts > 1 (d > 16): the key tiles of
// each query tile split into parts; ws_acc holds parts·B·Hq·Sq·d floats
// and ws_ml parts·B·Hq·Sq·2.
#define SIMT_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* o, float* lse, \
                      long long lse_ld, long long b, long long hq,          \
                      long long hkv, long long sq, long long skv,           \
                      long long d, float scale, long long causal,           \
                      long long bq, long long parts, float* ws_acc,         \
                      float* ws_ml, void* stream) {                         \
    return simt_fwd::launch<T>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv, \
                               d, scale, causal, bq, parts, ws_acc, ws_ml,  \
                               stream);                                     \
  }
SIMT_ENTRY(flash_attention_simt_f32, float)
SIMT_ENTRY(flash_attention_simt_bf16, __nv_bfloat16)
SIMT_ENTRY(flash_attention_simt_f16, __half)
#undef SIMT_ENTRY

// "wgmma": bfloat16 / float16 prefill on the tensor cores, d <= 128,
// d % 8 == 0.  lse: null, or float32 rows of lse_ld >= Sq a (batch,
// query head) for each row's log-sum-exp (base 2 of the scaled scores).
extern "C" int flash_attention_wgmma_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, float* lse, long long lse_ld, long long b,
    long long hq, long long hkv, long long sq, long long skv, long long d,
    float scale, long long causal, void* stream) {
  return wgmma_d<__nv_bfloat16>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv,
                                d, scale, causal, stream);
}

extern "C" int flash_attention_wgmma_f16(
    const __half* q, const __half* k, const __half* v, __half* o, float* lse,
    long long lse_ld, long long b, long long hq, long long hkv, long long sq,
    long long skv, long long d, float scale, long long causal, void* stream) {
  return wgmma_d<__half>(q, k, v, o, lse, lse_ld, b, hq, hkv, sq, skv, d,
                         scale, causal, stream);
}

// "split": short query blocks; ws_acc holds n_split·B·Hq·Sq·D floats and
// ws_ml n_split·B·Hq·Sq·2.
extern "C" int flash_attention_split_f32(
    const float* q, const float* k, const float* v, float* o, float* ws_acc,
    float* ws_ml, long long b, long long hq, long long hkv, long long sq,
    long long skv, long long d, float scale, long long causal,
    long long n_split, long long chunk, void* stream) {
  return split_d<float>(q, k, v, o, ws_acc, ws_ml, b, hq, hkv, sq, skv, d,
                        scale, causal, n_split, chunk, stream);
}

extern "C" int flash_attention_split_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, float* ws_acc, float* ws_ml, long long b, long long hq,
    long long hkv, long long sq, long long skv, long long d, float scale,
    long long causal, long long n_split, long long chunk, void* stream) {
  return split_d<__nv_bfloat16>(q, k, v, o, ws_acc, ws_ml, b, hq, hkv, sq,
                                skv, d, scale, causal, n_split, chunk,
                                stream);
}

extern "C" const char* kernel_error_string(int code) {
  return hopper::error_string(code);
}
