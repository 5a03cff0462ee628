// probe_counts: merge-probe run bounds, batched (B, nq) x (B, nr).
//
// Replaces the TPU kernel src/repro/kernels/fused_join.py::
// probe_counts_pallas (_probe_kernel, which streams query-block x
// key-block tiles through VMEM and counts with dense compares on the
// diagonal band).  For every query q of row b, against that row's
// sorted keys r:
//
//   lo = #{r < q}  (lower_bound),   hi = #{r <= q}  (upper_bound),
//
// equal to torch.searchsorted left/right as integers, sentinel-padded
// tails and a valid INT32_MAX / INT64_MAX key included (a search
// cannot return more than nr, so the counts are clamped to nr).
//
// Bound on the H100: device-memory bytes — each query is read once and
// two int32 counts are written; the key column is small enough per row
// that its upper search levels stay in L2.  The design is one thread
// per query running two binary searches (the second starts at the
// first's answer), with consecutive threads on consecutive queries so
// loads and stores are coalesced.  A merge-path kernel that walks both
// sorted sides in shared memory is the later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename K>
__global__ void __launch_bounds__(kThreads)
probe_counts_kernel(const K* __restrict__ queries,
                    const K* __restrict__ sorted_keys, int* __restrict__ lo,
                    int* __restrict__ hi, long long nq, long long nr) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nq) return;
  const long long b = blockIdx.y;
  const K* row = sorted_keys + b * nr;
  const K q = queries[b * nq + i];

  long long first = 0, last = nr;  // lower_bound: first row[m] >= q
  while (first < last) {
    const long long mid = (first + last) >> 1;
    if (row[mid] < q) first = mid + 1; else last = mid;
  }
  const long long lower = first;
  last = nr;                        // upper_bound: first row[m] > q
  while (first < last) {
    const long long mid = (first + last) >> 1;
    if (row[mid] <= q) first = mid + 1; else last = mid;
  }
  lo[b * nq + i] = static_cast<int>(lower);
  hi[b * nq + i] = static_cast<int>(first);
}

template <typename K>
int launch(const K* queries, const K* sorted_keys, int* lo, int* hi,
           long long batch, long long nq, long long nr, void* stream) {
  if (batch == 0 || nq == 0) return 0;
  dim3 grid(static_cast<unsigned>((nq + kThreads - 1) / kThreads),
            static_cast<unsigned>(batch));
  probe_counts_kernel<K><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, sorted_keys, lo, hi, nq, nr);
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
