// hash_histogram: salted multiplicative hash + per-block bucket counts,
// batched (B, N) keys -> (B, n_blocks, n_buckets) int32.
//
// Replaces the TPU kernel src/repro/kernels/hash_partition.py::
// hash_histogram (_kernel, which hashes a (1, block) VMEM tile on the
// VPU and counts with a one-hot (block x 128-lane) reduction, no
// atomics).  Column j of block i of row b counts the valid keys of
// rows [i*block, (i+1)*block) of that row whose bucket is j; rows past
// N and rows with valid == 0 count nowhere.
//
// One hash everywhere: the port's core/hashing.bucket_hash, bit for
// bit — int32 keys hash their 32 bits, int64 keys fold high xor low
// word first — then (u ^ salt) * 2654435761, u ^= u >> 15,
// u *= 0x846CA68B, u ^= u >> 13, u % n_buckets, all in native uint32
// arithmetic (the CPU version emulates it in int64).
//
// Bound on the H100: device-memory bytes — each key (4 or 8 bytes) and
// its valid byte are read once, each count written once.  The design:
//
//   * grid (n_blocks, B); one CTA of 256 threads per (row, block);
//   * the CTA zeroes a histogram of n_buckets ints in shared memory,
//     its threads walk the block with a stride of 256 (coalesced
//     loads), hash, and count with shared-memory atomics;
//   * the CTA writes its histogram as one row of the output.
//
// Few buckets (the main path's 4 and 16) make the shared atomics
// collide; privatising a histogram per warp is the later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned fold(int x) {
  return static_cast<unsigned>(x);
}

__device__ __forceinline__ unsigned fold(long long x) {
  const unsigned long long u = static_cast<unsigned long long>(x);
  return static_cast<unsigned>(u ^ (u >> 32));
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
hash_histogram_kernel(const K* __restrict__ keys,
                      const unsigned char* __restrict__ valid,
                      int* __restrict__ out, long long n, long long block,
                      long long n_blocks, unsigned n_buckets,
                      unsigned salt) {
  extern __shared__ int hist[];
  const long long row = blockIdx.y;
  const long long blk = blockIdx.x;
  for (unsigned j = threadIdx.x; j < n_buckets; j += kThreads) hist[j] = 0;
  __syncthreads();

  const long long start = blk * block;
  const long long end = min(start + block, n);
  const K* k = keys + row * n;
  const unsigned char* v = valid + row * n;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    if (v[i]) {
      unsigned u = (fold(k[i]) ^ salt) * 2654435761u;
      u ^= u >> 15;
      u *= 0x846CA68Bu;
      u ^= u >> 13;
      atomicAdd(&hist[u % n_buckets], 1);
    }
  }
  __syncthreads();

  int* o = out + (row * n_blocks + blk) * n_buckets;
  for (unsigned j = threadIdx.x; j < n_buckets; j += kThreads) o[j] = hist[j];
}

template <typename K>
int launch(const K* keys, const unsigned char* valid, int* out,
           long long batch, long long n, long long block, long long n_blocks,
           long long n_buckets, long long salt, void* stream) {
  if (batch == 0 || n_blocks == 0) return 0;
  dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(batch));
  const size_t smem = static_cast<size_t>(n_buckets) * sizeof(int);
  hash_histogram_kernel<K><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      keys, valid, out, n, block, n_blocks, static_cast<unsigned>(n_buckets),
      static_cast<unsigned>(salt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hash_histogram_i32(const int* keys, const unsigned char* valid,
                                  int* out, long long batch, long long n,
                                  long long block, long long n_blocks,
                                  long long n_buckets, long long salt,
                                  void* stream) {
  return launch<int>(keys, valid, out, batch, n, block, n_blocks, n_buckets,
                     salt, stream);
}

extern "C" int hash_histogram_i64(const long long* keys,
                                  const unsigned char* valid, int* out,
                                  long long batch, long long n,
                                  long long block, long long n_blocks,
                                  long long n_buckets, long long salt,
                                  void* stream) {
  return launch<long long>(keys, valid, out, batch, n, block, n_blocks,
                           n_buckets, salt, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
