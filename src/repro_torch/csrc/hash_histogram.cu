// hash_histogram: salted multiplicative hash + bucket counts of the
// valid keys, batched (B, N) keys: per block, (B, n_blocks, n_buckets)
// int32 (hash_histogram_*), or summed over the row, (B, n_buckets)
// int32 (bucket_counts_*).
//
// Replaces the TPU kernel src/repro/kernels/hash_partition.py::
// hash_histogram (_kernel, which hashes a (1, block) VMEM tile on the
// VPU and counts with a one-hot (block x 128-lane) reduction, no
// atomics).  Column j of block i of row b counts the valid keys of
// rows [i*block, (i+1)*block) of that row whose bucket is j; rows past
// N and rows with valid == 0 count nowhere.  Both callers of the
// totals (the executor's skew diagnostic and the heavy-hitter
// detector) want only the sum over blocks, which bucket_counts_*
// computes in one launch.
//
// One hash everywhere: the port's core/hashing.bucket_hash, bit for
// bit — int32 keys hash their 32 bits, int64 keys fold high xor low
// word first — then (u ^ salt) * 2654435761, u ^= u >> 15,
// u *= 0x846CA68B, u ^= u >> 13, u % n_buckets, all in native uint32
// arithmetic (the CPU version emulates it in int64); the remainder is
// taken with a multiply by a reciprocal computed on the host
// (Lemire's fastmod, exact for every 32-bit u and divisor).
//
// Bound on the H100: device-memory bytes — each valid byte is read
// once, a key only where it is valid, each count written once.  The
// main path's buffers are mostly padding and its bucket counts small
// (4 and 16).  The design:
//
//   * per block (hash_histogram_*): grid (n_blocks, B), launched per
//     65,535 rows, one CTA of 256 threads a (row, block); its threads
//     walk the block with a stride of 256
//     (coalesced loads), hash the valid keys and count them with atomics
//     into one shared histogram, written as one row of the output.
//     Past 12,288 buckets (48 KB of ints) they count with global
//     atomics straight into the output, which the caller zeroes.  (Measured on the H100: one warp a block with private
//     histograms was no faster at the path's shape and slower at the
//     others; see PERF.md);
//   * totals (bucket_counts_*): grid (CTAs, min(B, 65535)) of 1,024
//     threads (the rows walked as above), a
//     chunk of 16 rows a thread where the card holds that many CTAs (a
//     grid stride else).  Chunks lie on 16-byte boundaries of the mask:
//     one 16-byte load of the mask a chunk (scalar loads at the row's
//     ends); a warp whose chunks hold no valid row skips them; keys are
//     loaded 16 bytes at a time where a group of rows is all valid and
//     aligned, one at a time where it is valid only;
//   * totals' counts: with at most 4 buckets each lane counts in one
//     register, a byte a bucket, and every 255 rows, and at the end,
//     the warp adds each bucket's bytes over its lanes
//     (__reduce_add_sync).  With more buckets, shared atomics into a
//     histogram private to the warp (up to 384 buckets), else one a CTA
//     (up to 12,288), else global atomics into the caller's zeroed
//     output (any count up to 2^31 - 1).  (Measured on the H100: lane counters for 16
//     buckets, and __match_any_sync aggregation, were slower than
//     shared atomics; see PERF.md);
//   * totals' output: one global atomicAdd a (CTA, nonzero bucket) onto
//     the zeroed output (integer adds commute: every launch gives the
//     same counts).  The launch zeroes the output first
//     (cudaMemsetAsync); a row walked by one CTA is stored directly, and
//     then nothing is zeroed;
//   * short rows (at most 2,048 keys) with at most 384 buckets: a 1-D
//     grid whose warps walk the rows, a warp a row (lane counters, or a
//     shared histogram private to the warp), each row's counts stored
//     directly.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // per-block kernel
constexpr int kTotalsThreads = 1024;        // totals kernel
constexpr int kChunk = 16;                  // rows a thread takes at a time
constexpr int kFlushRows = 255;             // rows a byte count holds
constexpr int kRegisterBuckets = 4;         // a byte each in one register
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSmemBytes = 48 * 1024;
// Buckets a shared histogram holds (48 KB of ints, the default dynamic
// shared memory of a CTA); more count into the zeroed output instead.
constexpr long long kSharedBuckets = kSmemBytes / sizeof(int);
constexpr long long kMaxGridY = 65535;      // grid.y limit: CTAs walk rows
// A row this short (at most 4 chunks a lane of one warp; a CTA would
// keep 1/8 of its threads busy) is counted by one warp, in a histogram
// private to the warp: 32 of them fill 48 KB at 384 buckets.
constexpr long long kShortRow = 32 * 4 * kChunk;
constexpr long long kWarpBuckets = kSharedBuckets / (kTotalsThreads / 32);

__device__ __forceinline__ unsigned fold(int x) {
  return static_cast<unsigned>(x);
}

__device__ __forceinline__ unsigned fold(long long x) {
  const unsigned long long u = static_cast<unsigned long long>(x);
  return static_cast<unsigned>(u ^ (u >> 32));
}

struct Hash {
  unsigned n_buckets;
  unsigned salt;
  unsigned long long magic;                 // 2^64 / n_buckets, rounded up

  template <typename K>
  __device__ __forceinline__ unsigned operator()(K key) const {
    unsigned u = (fold(key) ^ salt) * 2654435761u;
    u ^= u >> 15;
    u *= 0x846CA68Bu;
    u ^= u >> 13;
    return static_cast<unsigned>(__umul64hi(magic * u, n_buckets));
  }
};

Hash make_hash(long long n_buckets, long long salt) {
  const unsigned long long d = static_cast<unsigned long long>(n_buckets);
  return {static_cast<unsigned>(n_buckets), static_cast<unsigned>(salt),
          ~0ULL / d + 1};
}

__device__ __forceinline__ unsigned byte_of(const unsigned (&m)[4], int j) {
  return (m[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// The 16 keys of rows [r0, r0 + 16) that are valid (the rest left 0).
__device__ __forceinline__ void load_keys(const int* krow, long long r0,
                                          const unsigned (&m)[4],
                                          int (&k)[kChunk]) {
#pragma unroll
  for (int g = 0; g < kChunk; g += 4) {
    const int* p = krow + r0 + g;
    if (m[g >> 2] == 0x01010101u
        && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p));
      k[g] = v.x; k[g + 1] = v.y; k[g + 2] = v.z; k[g + 3] = v.w;
    } else {
#pragma unroll
      for (int j = g; j < g + 4; ++j)
        k[j] = byte_of(m, j) ? __ldg(krow + r0 + j) : 0;
    }
  }
}

__device__ __forceinline__ void load_keys(const long long* krow,
                                          long long r0,
                                          const unsigned (&m)[4],
                                          long long (&k)[kChunk]) {
#pragma unroll
  for (int g = 0; g < kChunk; g += 2) {
    const long long* p = krow + r0 + g;
    const unsigned pair = (m[g >> 2] >> (8 * (g & 3))) & 0xffffu;
    if (pair == 0x0101u && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
      k[g] = v.x; k[g + 1] = v.y;
    } else {
#pragma unroll
      for (int j = g; j < g + 2; ++j)
        k[j] = byte_of(m, j) ? __ldg(krow + r0 + j) : 0;
    }
  }
}

// Adds the warp's byte counts of buckets 0..3 over its lanes into lane
// j's total of bucket j, and clears them.
__device__ __forceinline__ void flush(unsigned& c, unsigned n_buckets,
                                      int& mine) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < static_cast<int>(n_buckets)) {              // warp-uniform
      const unsigned s = __reduce_add_sync(kFull, (c >> (8 * b)) & 0xffu);
      if (lane == b) mine += static_cast<int>(s);
    }
  }
  c = 0;
}

// The mask bytes of rows [r0, r0 + 16) that lie in [start, end) (0
// elsewhere): one 16-byte load where the chunk lies inside, scalar
// loads at the range's ends.
__device__ __forceinline__ void load_mask(const unsigned char* vrow,
                                          long long r0, long long start,
                                          long long end, unsigned (&m)[4]) {
  if (r0 >= start && r0 + kChunk <= end) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(vrow + r0));
    m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = r0 + 4 * w + j;
        if (i >= start && i < end && vrow[i]) word |= 1u << (8 * j);
      }
      m[w] = word;
    }
  }
}

// Count the valid rows of one row of n.  The row is cut into 16-row
// chunks on 16-byte boundaries of the mask; this thread takes chunks
// `chunk`, `chunk + stride`, ..., where `chunk` is a warp's first chunk
// plus the lane (the loop is warp-uniform, as the warp collectives
// need).  kRegisters (at most 4 buckets): counts in a register, and the
// return value is the warp's count of bucket `lane` (0 past n_buckets).
// Else shared atomics into hist, and the return value is 0.
template <bool kRegisters, typename K>
__device__ int count_rows(const K* __restrict__ krow,
                          const unsigned char* __restrict__ vrow,
                          long long n, long long chunk, long long stride,
                          int* hist, const Hash& hash) {
  constexpr int kFlushEvery = kFlushRows / kChunk;
  const int lane = threadIdx.x & 31;
  const long long base =
      -static_cast<long long>(reinterpret_cast<uintptr_t>(vrow) & 15);
  const long long n_chunks = (n - base + kChunk - 1) / kChunk;
  unsigned c = 0;
  int mine = 0, pending = 0;
  for (long long c0 = chunk; c0 - lane < n_chunks; c0 += stride) {
    const long long r0 = base + c0 * kChunk;
    unsigned m[4];
    load_mask(vrow, r0, 0, n, m);
    if (!__any_sync(kFull, (m[0] | m[1] | m[2] | m[3]) != 0)) continue;

    K k[kChunk];
    load_keys(krow, r0, m, k);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool live = byte_of(m, j) != 0;
      const unsigned bkt = hash(k[j]);
      if constexpr (kRegisters) {
        c += live ? 1u << (8 * bkt) : 0u;
      } else if (live) {
        atomicAdd(hist + bkt, 1);
      }
    }
    if constexpr (kRegisters) {
      if (++pending == kFlushEvery) {
        flush(c, hash.n_buckets, mine);
        pending = 0;
      }
    }
  }
  if constexpr (kRegisters) flush(c, hash.n_buckets, mine);
  return mine;
}

// Per block: grid (n_blocks, B), B <= 65535 (the launcher cuts more
// rows into such launches), one CTA a (row, block), one shared
// histogram — or (kShared false, past kSharedBuckets) atomics straight
// into the zeroed output.  kShared is a template argument so that the
// shared case's atomics stay shared-memory atomics.
template <bool kShared, typename K>
__global__ void __launch_bounds__(kThreads)
hist_blocks(const K* __restrict__ keys,
            const unsigned char* __restrict__ valid, int* __restrict__ out,
            long long n, long long block, long long n_blocks, Hash hash) {
  extern __shared__ int smem[];
  const long long row = blockIdx.y;
  const long long blk = blockIdx.x;
  const unsigned nb = hash.n_buckets;
  int* o = out + (row * n_blocks + blk) * nb;
  int* hist = kShared ? smem : o;
  if (kShared) {
    for (unsigned j = threadIdx.x; j < nb; j += kThreads) hist[j] = 0;
    __syncthreads();
  }
  const long long start = blk * block;
  const long long end = min(start + block, n);
  const K* k = keys + row * n;
  const unsigned char* v = valid + row * n;
  for (long long i = start + threadIdx.x; i < end; i += kThreads)
    if (v[i]) atomicAdd(&hist[hash(k[i])], 1);
  if (kShared) {
    __syncthreads();
    for (unsigned j = threadIdx.x; j < nb; j += kThreads) o[j] = hist[j];
  }
}

// Totals: grid (CTAs, min(B, 65535)), CTA y walking rows y, y + 65535,
// ... (one launch whatever B: a captured plan launches it once a hop);
// `copies` shared histograms a CTA, one a warp where 32 fit, else one;
// kShared false: atomics straight into the zeroed output row.
template <bool kRegisters, bool kShared, typename K>
__global__ void __launch_bounds__(kTotalsThreads)
bucket_totals(const K* __restrict__ keys,
              const unsigned char* __restrict__ valid, int* __restrict__ out,
              long long batch, long long n, Hash hash, int copies) {
  extern __shared__ int hist[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned nb = hash.n_buckets;
  for (long long row = blockIdx.y; row < batch; row += gridDim.y) {
    int* o = out + row * nb;
    if (kShared) {
      for (unsigned j = threadIdx.x; j < copies * nb; j += kTotalsThreads)
        hist[j] = 0;
      __syncthreads();
    }
    int* mine_hist = kShared ? hist + (warp % copies) * nb : o;
    const int mine = count_rows<kRegisters>(
        keys + row * n, valid + row * n, n,
        static_cast<long long>(blockIdx.x) * kTotalsThreads + threadIdx.x,
        static_cast<long long>(gridDim.x) * kTotalsThreads, mine_hist, hash);
    if (kRegisters && mine) atomicAdd(mine_hist + lane, mine);
    if (kShared) {
      __syncthreads();
      for (unsigned j = threadIdx.x; j < nb; j += kTotalsThreads) {
        int s = 0;
        for (int w = 0; w < copies; ++w) s += hist[w * nb + j];
        if (gridDim.x == 1) o[j] = s;
        else if (s) atomicAdd(o + j, s);
      }
      if (row + gridDim.y < batch) __syncthreads();  // hist read: reuse it
    }
  }
}

// Totals of short rows (a few chunks each): a 1-D grid whose warps
// walk the rows with a stride, a warp a row, so a row of 128 keys costs
// a warp, not a 1,024-thread CTA.  The warp's count goes straight to its
// output row (no atomics on it, no zeroing): lane counters where
// kRegisters, else a shared histogram private to the warp
// (n_buckets <= kWarpBuckets).
template <bool kRegisters, typename K>
__global__ void __launch_bounds__(kTotalsThreads)
bucket_totals_rows(const K* __restrict__ keys,
                   const unsigned char* __restrict__ valid,
                   int* __restrict__ out, long long batch, long long n,
                   Hash hash) {
  extern __shared__ int hist[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned nb = hash.n_buckets;
  int* mine_hist = hist + warp * nb;
  for (long long row = static_cast<long long>(blockIdx.x) * (kTotalsThreads / 32)
                       + warp;
       row < batch; row += static_cast<long long>(gridDim.x) *
                           (kTotalsThreads / 32)) {     // warp-uniform
    int* o = out + row * nb;
    if (!kRegisters) {
      for (unsigned j = lane; j < nb; j += 32) mine_hist[j] = 0;
      __syncwarp();
    }
    const int mine = count_rows<kRegisters>(keys + row * n, valid + row * n,
                                            n, lane, 32, mine_hist, hash);
    if (kRegisters) {
      if (lane < static_cast<int>(nb)) o[lane] = mine;
    } else {
      __syncwarp();
      for (unsigned j = lane; j < nb; j += 32) o[j] = mine_hist[j];
      __syncwarp();                     // read before the next row's zeroing
    }
  }
}

template <typename K>
int launch_blocks(const K* keys, const unsigned char* valid, int* out,
                  long long batch, long long n, long long block,
                  long long n_blocks, long long n_buckets, long long salt,
                  void* stream) {
  if (batch == 0 || n_blocks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hash hash = make_hash(n_buckets, salt);
  for (long long b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const dim3 grid(static_cast<unsigned>(n_blocks),
                    static_cast<unsigned>(std::min(batch - b0, kMaxGridY)));
    const K* k = keys + b0 * n;
    const unsigned char* v = valid + b0 * n;
    int* o = out + b0 * n_blocks * n_buckets;
    if (n_buckets <= kSharedBuckets)
      hist_blocks<true, K><<<grid, kThreads, n_buckets * sizeof(int), st>>>(
          k, v, o, n, block, n_blocks, hash);
    else
      hist_blocks<false, K><<<grid, kThreads, 0, st>>>(k, v, o, n, block,
                                                       n_blocks, hash);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// CTAs of bucket_totals<kRegisters, kShared, K> the current card holds
// at once, for the most shared memory a launch gives it (48 KB: a
// launch with less never fits fewer CTAs; on the H100 a 1,024-thread
// CTA's threads set the count, two an SM, either way).  The runtime is
// asked once a device: the answer never changes while the process
// runs, and the totals are launched on every measured shuffle hop.
template <bool kRegisters, bool kShared, typename K>
int resident_ctas(int* out) {
  constexpr int kDevices = 64;
  static std::atomic<int> cache[kDevices];      // 0: not asked yet
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kDevices && (*out = cache[device].load()) > 0) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucket_totals<kRegisters, kShared, K>, kTotalsThreads,
        kShared ? kSmemBytes : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = std::max(1, sms * per_sm);
  if (device < kDevices) cache[device].store(*out);
  return 0;
}

// kShared false (more buckets than a shared histogram holds): the
// caller zeroes `out`.
template <bool kRegisters, bool kShared, typename K>
int launch_totals_as(const K* keys, const unsigned char* valid, int* out,
                     long long batch, long long n, const Hash& hash,
                     cudaStream_t st) {
  const long long nb = hash.n_buckets;
  const int copies = !kShared ? 0
                     : kTotalsThreads / 32 * nb <= kSharedBuckets
                         ? kTotalsThreads / 32 : 1;
  const size_t smem = copies * nb * sizeof(int);
  int resident = 0;
  const int rc = resident_ctas<kRegisters, kShared, K>(&resident);
  if (rc != 0) return rc;
  // A chunk a thread where the card holds that many CTAs, else as many
  // as it holds; the walk is a grid stride, so any CTA count covers the
  // row.
  const long long per_cta = kChunk * kTotalsThreads;
  const long long spans = (n + kChunk + per_cta - 1) / per_cta;
  const long long ctas =
      std::max(1LL, std::min(spans, std::max(1LL, resident / batch)));
  if (kShared && ctas > 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, batch * nb * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bucket_totals<kRegisters, kShared, K><<<
      dim3(static_cast<unsigned>(ctas),
           static_cast<unsigned>(std::min(batch, kMaxGridY))),
      kTotalsThreads, smem, st>>>(keys, valid, out, batch, n, hash, copies);
  return static_cast<int>(cudaGetLastError());
}

// Short rows, a warp a row (bucket_totals_rows).
template <bool kRegisters, typename K>
int launch_rows_as(const K* keys, const unsigned char* valid, int* out,
                   long long batch, long long n, const Hash& hash,
                   cudaStream_t st) {
  static std::atomic<int> cache[64];            // 0: not asked yet
  const size_t smem =
      kRegisters ? 0 : kTotalsThreads / 32 * hash.n_buckets * sizeof(int);
  int device = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64) resident = cache[device].load();
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bucket_totals_rows<kRegisters, K>, kTotalsThreads,
          kRegisters ? 0 : kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = std::max(1, sms * per_sm);
    if (device < 64) cache[device].store(resident);
  }
  constexpr long long kRowsPerCta = kTotalsThreads / 32;
  const long long ctas = std::min<long long>(
      resident, (batch + kRowsPerCta - 1) / kRowsPerCta);
  bucket_totals_rows<kRegisters, K><<<static_cast<unsigned>(ctas),
                                      kTotalsThreads, smem, st>>>(
      keys, valid, out, batch, n, hash);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_totals(const K* keys, const unsigned char* valid, int* out,
                  long long batch, long long n, long long n_buckets,
                  long long salt, void* stream) {
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hash hash = make_hash(n_buckets, salt);
  // A short row fills a few lanes of a 1,024-thread CTA: a warp takes it
  // instead, where its histogram fits.
  if (n <= kShortRow && n_buckets <= kWarpBuckets) {
    if (n_buckets <= kRegisterBuckets)
      return launch_rows_as<true>(keys, valid, out, batch, n, hash, st);
    return launch_rows_as<false>(keys, valid, out, batch, n, hash, st);
  }
  if (n_buckets <= kRegisterBuckets)
    return launch_totals_as<true, true>(keys, valid, out, batch, n, hash, st);
  if (n_buckets <= kSharedBuckets)
    return launch_totals_as<false, true>(keys, valid, out, batch, n, hash,
                                         st);
  return launch_totals_as<false, false>(keys, valid, out, batch, n, hash, st);
}

}  // namespace

extern "C" int hash_histogram_i32(const int* keys, const unsigned char* valid,
                                  int* out, long long batch, long long n,
                                  long long block, long long n_blocks,
                                  long long n_buckets, long long salt,
                                  void* stream) {
  return launch_blocks<int>(keys, valid, out, batch, n, block, n_blocks,
                            n_buckets, salt, stream);
}

extern "C" int hash_histogram_i64(const long long* keys,
                                  const unsigned char* valid, int* out,
                                  long long batch, long long n,
                                  long long block, long long n_blocks,
                                  long long n_buckets, long long salt,
                                  void* stream) {
  return launch_blocks<long long>(keys, valid, out, batch, n, block,
                                  n_blocks, n_buckets, salt, stream);
}

extern "C" int bucket_counts_i32(const int* keys, const unsigned char* valid,
                                 int* out, long long batch, long long n,
                                 long long n_buckets, long long salt,
                                 void* stream) {
  return launch_totals<int>(keys, valid, out, batch, n, n_buckets, salt,
                            stream);
}

extern "C" int bucket_counts_i64(const long long* keys,
                                 const unsigned char* valid, int* out,
                                 long long batch, long long n,
                                 long long n_buckets, long long salt,
                                 void* stream) {
  return launch_totals<long long>(keys, valid, out, batch, n, n_buckets,
                                  salt, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
