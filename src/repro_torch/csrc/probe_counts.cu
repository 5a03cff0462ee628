// probe_counts: merge-probe run bounds, batched (B, nq) x (B, nr).
//
// Replaces the TPU kernel src/repro/kernels/fused_join.py::
// probe_counts_pallas (_probe_kernel, which streams query-block x
// key-block tiles through VMEM, takes each query block's min and max,
// and pays the dense compare only on the boundary band).  For every
// query q of row b, against that row's sorted keys r:
//
//   lo = #{r < q}  (lower_bound),   hi = #{r <= q}  (upper_bound),
//
// equal to torch.searchsorted left/right as integers for any queries,
// sorted or not, sentinel-padded tails and a valid INT32_MAX /
// INT64_MAX key included (a search cannot return more than nr).
//
// Bound on the H100: device-memory bytes — each query is read once and
// two int32 counts are written.  The join's queries are sorted with a
// sentinel tail that is almost all of the buffer, so most tiles of
// consecutive queries hold one value, and a live tile spans a few dozen
// keys.  The design (a tile-window probe, one warp a tile):
//
//   * warp tiles of 256 consecutive queries of one row, 8 a lane, laid
//     on 16-byte boundaries of the query row (a row whose base is not
//     aligned still gets 16-byte loads); a lane's queries lie in
//     16-byte groups 512 bytes apart, so each warp-wide load or store
//     is one contiguous span.  A group that is not aligned, or crosses
//     a row end, takes scalar loads and stores;
//   * rows of at least 8 tiles, at most 65,535 of them: grid (CTAs, B)
//     of 256 threads, as many CTAs as the card holds at once; each warp
//     walks its row's tiles with a stride and loads its next tile while
//     it counts this one.  More such rows: a 1-D grid whose warps walk
//     the batch's (row, tile) pairs.  Shorter rows (under 2,048
//     queries, any count of them): a thread a query, a binary search of
//     its row in device memory (a warp tile's window would cost more
//     than it saves).  No CTA barrier anywhere;
//   * shuffles give the tile's qmin and qmax; the warp finds
//     lower_bound(qmin) and upper_bound(qmax) in the row by a 32-ary
//     search (31 pivots a step, one load a lane): the window [wlo, whi)
//     that holds every answer of the tile;
//   * qmin == qmax: every query of the tile has (lo, hi) = (wlo, whi),
//     written without a search, and the warp keeps that answer: its
//     later tiles of the same value (the sentinel tail) skip the window
//     search too, so the tail is a pure streaming read and write;
//   * a window of at most kWindow keys is staged into the warp's shared
//     memory and each query binary-searches it (from the previous
//     query's lo where the lane's queries ascend);
//   * a larger window (unsorted queries) is searched in device memory,
//     inside the window only, by a branch-free search whose halving
//     steps do not depend on the data, so a lane's 8 queries take each
//     step together: 8 independent loads in flight, not 8 chains.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * kItems;       // queries of a warp tile
constexpr int kWindow = 512;             // keys a warp stages in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxGridY = 65535;   // grid.y limit

template <typename K> struct Limits;
template <> struct Limits<int> {
  static __device__ __forceinline__ int lowest() { return INT32_MIN; }
  static __device__ __forceinline__ int highest() { return INT32_MAX; }
};
template <> struct Limits<long long> {
  static __device__ __forceinline__ long long lowest() { return INT64_MIN; }
  static __device__ __forceinline__ long long highest() { return INT64_MAX; }
};

// A lane's kItems queries of a warp tile lie in groups of kVec<K>
// consecutive queries (16 bytes), group g at g * 32 * kVec + lane *
// kVec from the tile's start, so each warp-wide load or store of a
// group covers one contiguous span.
template <typename K> constexpr int kVec = 16 / sizeof(K);

__device__ __forceinline__ void load_vec(const int* p, int* q) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
}

__device__ __forceinline__ void load_vec(const long long* p, long long* q) {
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
  q[0] = v.x; q[1] = v.y;
}

// The counts of one group: 16 bytes (int32 keys) or 8 (int64 keys).
template <int V>
__device__ __forceinline__ void store_vec(int* p, const int* c) {
  if constexpr (V == 4)
    *reinterpret_cast<int4*>(p) = make_int4(c[0], c[1], c[2], c[3]);
  else
    *reinterpret_cast<int2*>(p) = make_int2(c[0], c[1]);
}

// lower_bound (kUpper false: first row[m] >= q) or upper_bound (kUpper
// true: first row[m] > q) of q in row[0, n), by the whole warp: each
// step compares 31 pivots that cut the range into 32 parts.  Every lane
// returns the answer.
template <bool kUpper, typename K>
__device__ long long warp_bound(const K* __restrict__ row, long long n,
                                K q) {
  const int lane = threadIdx.x & 31;
  long long first = 0, last = n;        // the answer lies in [first, last]
  while (last - first > 32) {
    const long long span = last - first;
    const long long m = first + (static_cast<long long>(lane) + 1) * span / 32;
    bool below = false;
    if (lane < 31) {
      const K r = __ldg(row + m);
      below = kUpper ? r <= q : r < q;
    }
    const int c = __popc(__ballot_sync(kFull, below));   // a prefix
    const long long m_lo = __shfl_sync(kFull, m, c > 0 ? c - 1 : 0);
    const long long m_hi = __shfl_sync(kFull, m, c < 31 ? c : 0);
    if (c > 0) first = m_lo + 1;
    if (c < 31) last = m_hi;
  }
  const long long m = first + lane;
  bool below = false;
  if (m < last) {
    const K r = __ldg(row + m);
    below = kUpper ? r <= q : r < q;
  }
  return first + __popc(__ballot_sync(kFull, below));
}

// First index in [first, last) of s whose key is >= q (kUpper false) or
// > q (kUpper true); last where there is none.
template <bool kUpper, typename K>
__device__ __forceinline__ long long bound(const K* s, long long first,
                                           long long last, K q) {
  while (first < last) {
    const long long mid = (first + last) >> 1;
    const K r = s[mid];
    if (kUpper ? r <= q : r < q) first = mid + 1; else last = mid;
  }
  return first;
}

// Query index of a lane's item j in the tile that starts at t0.
template <typename K>
__device__ __forceinline__ long long item(long long t0, int j) {
  constexpr int V = kVec<K>;
  return t0 + (j / V) * 32 * V + (threadIdx.x & 31) * V + j % V;
}

template <typename K>
__device__ __forceinline__ void load_tile(const K* __restrict__ qrow,
                                          long long t0, long long nq,
                                          bool aligned, K (&q)[kItems]) {
  constexpr int V = kVec<K>;
#pragma unroll
  for (int j = 0; j < kItems; j += V) {
    const long long i = item<K>(t0, j);
    if (aligned && i >= 0 && i + V <= nq) {
      load_vec(qrow + i, q + j);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        q[j + v] = (i + v >= 0 && i + v < nq) ? __ldg(qrow + i + v) : K(0);
    }
  }
}

template <typename K>
__device__ __forceinline__ void store_tile(int* __restrict__ lrow,
                                           int* __restrict__ hrow,
                                           long long t0, long long nq,
                                           bool aligned, const int (&l)[kItems],
                                           const int (&h)[kItems]) {
  constexpr int V = kVec<K>;
#pragma unroll
  for (int j = 0; j < kItems; j += V) {
    const long long i = item<K>(t0, j);
    if (aligned && i >= 0 && i + V <= nq) {
      store_vec<V>(lrow + i, l + j);
      store_vec<V>(hrow + i, h + j);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (i + v >= 0 && i + v < nq) {
          lrow[i + v] = l[j + v];
          hrow[i + v] = h[j + v];
        }
      }
    }
  }
}

// lower_bound (kUpper false) or upper_bound (kUpper true) of each of a
// lane's queries in row[first, last), first < last, all in lockstep: the
// halving sequence of the range does not depend on the comparisons
// (a branch-free search), so the kItems probes of a step are
// independent loads in flight together.
template <bool kUpper, typename K>
__device__ __forceinline__ void lockstep_bounds(const K* __restrict__ row,
                                                const K (&q)[kItems],
                                                long long first,
                                                long long last,
                                                int (&out)[kItems]) {
  int base[kItems];                      // nr < 2^31 (the wrapper checks)
#pragma unroll
  for (int j = 0; j < kItems; ++j) base[j] = static_cast<int>(first);
  for (int n = static_cast<int>(last - first); n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const K r = __ldg(row + base[j] + half);
      if (kUpper ? r <= q[j] : r < q[j]) base[j] += half;
    }
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const K r = __ldg(row + base[j]);
    out[j] = base[j] + (kUpper ? r <= q[j] : r < q[j]);
  }
}

// Counts of a warp tile's queries against the row, given the tile's
// window [wlo, whi): a broadcast where the tile holds one value, a
// search of the window staged in the warp's shared memory, or of the
// row inside the window.
template <typename K>
__device__ __forceinline__ void tile_counts(const K* __restrict__ krow,
                                            K* window, const K (&q)[kItems],
                                            K qmin, K qmax, long long wlo,
                                            long long whi, int (&l)[kItems],
                                            int (&h)[kItems]) {
  const long long width = whi - wlo;
  if (qmin == qmax) {                   // one value: no search
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      l[j] = static_cast<int>(wlo);
      h[j] = static_cast<int>(whi);
    }
  } else if (width <= kWindow) {        // warp-uniform branch
    __syncwarp();                       // the last tile's reads are done
    for (long long i = threadIdx.x & 31; i < width; i += 32)
      window[i] = __ldg(krow + wlo + i);
    __syncwarp();
    long long prev = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long from = (j > 0 && q[j] >= q[j - 1]) ? prev : 0;
      const long long a = bound<false>(window, from, width, q[j]);
      const long long c = bound<true>(window, a, width, q[j]);
      prev = a;
      l[j] = static_cast<int>(wlo + a);
      h[j] = static_cast<int>(wlo + c);
    }
  } else {
    lockstep_bounds<false>(krow, q, wlo, whi, l);
    lockstep_bounds<true>(krow, q, wlo, whi, h);
  }
}

// Where a row's tiles lie: tile k of the row holds queries
// [k * kTile - shift, (k + 1) * kTile - shift), starting on 16-byte
// boundaries of the query row.  A lane's groups lie 512 bytes of
// queries apart and its tiles kTile queries apart, so its alignment is
// the same in all of them.
template <typename K>
struct RowTiles {
  const K* qrow;
  const K* krow;
  int* lrow;
  int* hrow;
  long long shift, n_tiles;
  bool aligned;

  __device__ __forceinline__ RowTiles(const K* queries, const K* sorted_keys,
                                      int* lo, int* hi, long long b,
                                      long long nq, long long nr)
      : qrow(queries + b * nq), krow(sorted_keys + b * nr),
        lrow(lo + b * nq), hrow(hi + b * nq) {
    shift = static_cast<long long>(
        (reinterpret_cast<uintptr_t>(qrow) & 15) / sizeof(K));
    n_tiles = (nq + shift + kTile - 1) / kTile;
    const long long first = item<K>(-shift, 0);
    aligned = (reinterpret_cast<uintptr_t>(qrow + first) & 15) == 0
              && ((reinterpret_cast<uintptr_t>(lrow + first)
                   | reinterpret_cast<uintptr_t>(hrow + first))
                  & (4 * kVec<K> - 1)) == 0;
  }
};

// The answer of a warp's last one-value tile: the sentinel tail's tiles
// after the first need no search.
template <typename K>
struct TailCache {
  bool valid = false;
  K q = 0;
  long long lo = 0, hi = 0;
};

// Counts and stores one warp tile whose queries q start at t0.
template <typename K>
__device__ __forceinline__ void count_tile(const RowTiles<K>& row,
                                           long long t0, long long nq,
                                           long long nr,
                                           const K (&q)[kItems], K* window,
                                           TailCache<K>& cache) {
  // The tile's qmin and qmax (rows outside [0, nq) count for neither).
  K qmin = Limits<K>::highest(), qmax = Limits<K>::lowest();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = item<K>(t0, j);
    if (i >= 0 && i < nq) {
      qmin = min(qmin, q[j]);
      qmax = max(qmax, q[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(kFull, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(kFull, qmax, off));
  }

  // The window, unless the tile repeats the cached value.
  long long wlo, whi;
  if (cache.valid && qmin == qmax && qmin == cache.q) {
    wlo = cache.lo;
    whi = cache.hi;
  } else {
    wlo = warp_bound<false>(row.krow, nr, qmin);
    whi = warp_bound<true>(row.krow, nr, qmax);
    if (qmin == qmax) cache = {true, qmin, wlo, whi};
  }

  int l[kItems], h[kItems];
  tile_counts(row.krow, window, q, qmin, qmax, wlo, whi, l, h);
  store_tile<K>(row.lrow, row.hrow, t0, nq, row.aligned, l, h);
}

// The counts of row b: the warp tiles of the row, walked by this
// CTA's warps with a stride of the row's CTAs; each warp loads its next
// tile while it counts this one.
template <typename K>
__device__ __forceinline__ void probe_row(const K* __restrict__ queries,
                                          const K* __restrict__ sorted_keys,
                                          int* __restrict__ lo,
                                          int* __restrict__ hi, long long b,
                                          long long nq, long long nr,
                                          K* window) {
  const RowTiles<K> row(queries, sorted_keys, lo, hi, b, nq, nr);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  TailCache<K> cache;
  long long tile = static_cast<long long>(blockIdx.x) * kWarps
                   + (threadIdx.x >> 5);
  K q[kItems], next[kItems];
  if (tile < row.n_tiles)
    load_tile(row.qrow, tile * kTile - row.shift, nq, row.aligned, q);
  for (; tile < row.n_tiles; tile += stride) {          // warp-uniform
    const long long after = tile + stride;
    if (after < row.n_tiles)
      load_tile(row.qrow, after * kTile - row.shift, nq, row.aligned, next);
    count_tile(row, tile * kTile - row.shift, nq, nr, q, window, cache);
#pragma unroll
    for (int j = 0; j < kItems; ++j) q[j] = next[j];
  }
}

// Grid (CTAs, B), B <= 65,535 rows of at least kWarps tiles: one row a
// CTA row.  No CTA barrier: each warp moves on alone.
template <typename K>
__global__ void __launch_bounds__(kThreads)
probe_counts_kernel(const K* __restrict__ queries,
                    const K* __restrict__ sorted_keys, int* __restrict__ lo,
                    int* __restrict__ hi, long long nq, long long nr) {
  __shared__ K windows[kWarps][kWindow];
  probe_row(queries, sorted_keys, lo, hi, static_cast<long long>(blockIdx.y),
            nq, nr, windows[threadIdx.x >> 5]);
}

// More than 65,535 rows of at least kWarps tiles: a 1-D grid whose
// warps walk the (row, tile) pairs of the whole batch with a stride, a
// warp a tile.  `per_row` is the most tiles a row spans (a row whose
// shift needs fewer skips the last).
template <typename K>
__global__ void __launch_bounds__(kThreads)
probe_counts_tiles_kernel(const K* __restrict__ queries,
                          const K* __restrict__ sorted_keys,
                          int* __restrict__ lo, int* __restrict__ hi,
                          long long batch, long long nq, long long nr,
                          long long per_row) {
  __shared__ K windows[kWarps][kWindow];
  K* window = windows[threadIdx.x >> 5];
  const long long tasks = batch * per_row;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  TailCache<K> cache;
  long long cached_row = -1;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps
                     + (threadIdx.x >> 5);
       t < tasks; t += stride) {                        // warp-uniform
    const long long b = t / per_row, tile = t - b * per_row;
    const RowTiles<K> row(queries, sorted_keys, lo, hi, b, nq, nr);
    if (tile >= row.n_tiles) continue;
    if (b != cached_row) {              // the cache holds one row's keys
      cache.valid = false;
      cached_row = b;
    }
    const long long t0 = tile * kTile - row.shift;
    K q[kItems];
    load_tile(row.qrow, t0, nq, row.aligned, q);
    count_tile(row, t0, nq, nr, q, window, cache);
  }
}

// Short rows (fewer than kWarps tiles): a thread a query, walked over
// the whole batch with a grid stride.  A warp tile's window search and
// staging cost more than they save where a row holds a tile or two:
// here each thread binary-searches its row's keys in device memory
// (lower_bound, then upper_bound from it); a warp's queries lie in one
// or two rows, so its loads share the rows' cache lines.
template <typename K>
__global__ void __launch_bounds__(kThreads)
probe_counts_queries_kernel(const K* __restrict__ queries,
                            const K* __restrict__ sorted_keys,
                            int* __restrict__ lo, int* __restrict__ hi,
                            long long batch, long long nq, long long nr) {
  const long long total = batch * nq;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const K* krow = sorted_keys + (i / nq) * nr;
    const K q = __ldg(queries + i);
    const long long a = bound<false>(krow, 0, nr, q);
    lo[i] = static_cast<int>(a);
    hi[i] = static_cast<int>(bound<true>(krow, a, nr, q));
  }
}

// CTAs the card holds at once, for one 256-thread CTA's resources.
// The runtime is asked once a device and kernel: the answer never
// changes while the process runs, and the kernel is launched on every
// fused join.
template <typename Kernel>
int resident_ctas(Kernel kernel, std::atomic<int> (&cache)[64], int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && (*out = cache[device].load()) > 0) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = std::max(1, sms * per_sm);
  if (device < 64) cache[device].store(*out);
  return 0;
}

template <typename K>
int launch(const K* queries, const K* sorted_keys, int* lo, int* hi,
           long long batch, long long nq, long long nr, void* stream) {
  if (batch == 0 || nq == 0) return 0;
  static std::atomic<int> rows_cache[64], tiles_cache[64],  // 0: not asked
      queries_cache[64];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One more tile than nq needs covers the shift of a misaligned row.
  const long long tiles = (nq + 3 + kTile - 1) / kTile;
  int resident = 0;
  if (batch <= kMaxGridY && tiles >= kWarps) {
    // The warps of a row walk its tiles with a stride, all resident at
    // once.
    const int err = resident_ctas(probe_counts_kernel<K>, rows_cache,
                                  &resident);
    if (err != 0) return err;
    const long long ctas = (tiles + kWarps - 1) / kWarps;
    const long long per_row = std::max(1LL, std::min(ctas, resident / batch));
    probe_counts_kernel<K><<<dim3(static_cast<unsigned>(per_row),
                                  static_cast<unsigned>(batch)),
                             kThreads, 0, st>>>(queries, sorted_keys, lo, hi,
                                                nq, nr);
  } else if (tiles < kWarps) {
    const int err = resident_ctas(probe_counts_queries_kernel<K>,
                                  queries_cache, &resident);
    if (err != 0) return err;
    const long long ctas = std::min<long long>(
        resident, (batch * nq + kThreads - 1) / kThreads);
    probe_counts_queries_kernel<K><<<static_cast<unsigned>(ctas), kThreads, 0,
                                     st>>>(queries, sorted_keys, lo, hi, batch,
                                           nq, nr);
  } else {
    const int err = resident_ctas(probe_counts_tiles_kernel<K>, tiles_cache,
                                  &resident);
    if (err != 0) return err;
    const long long ctas = std::min<long long>(
        resident, (batch * tiles + kWarps - 1) / kWarps);
    probe_counts_tiles_kernel<K><<<static_cast<unsigned>(ctas), kThreads, 0,
                                   st>>>(queries, sorted_keys, lo, hi, batch,
                                         nq, nr, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_counts_i32(const int* queries, const int* sorted_keys,
                                int* lo, int* hi, long long batch,
                                long long nq, long long nr, void* stream) {
  return launch<int>(queries, sorted_keys, lo, hi, batch, nq, nr, stream);
}

extern "C" int probe_counts_i64(const long long* queries,
                                const long long* sorted_keys, int* lo,
                                int* hi, long long batch, long long nq,
                                long long nr, void* stream) {
  return launch<long long>(queries, sorted_keys, lo, hi, batch, nq, nr, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
