// segment_sum: per-segment float32 sums, batched (B, N) -> (B, S).
//
// Replaces the TPU kernel src/repro/kernels/segment_sum.py::segment_sum
// (_kernel, a one-hot MXU product per segment tile x input block with
// off-band tiles skipped).  Hopper has no reason to spend a matrix unit
// on a scatter: the work is one read of every (id, value) pair and one
// write of every sum, so the kernel is bound by device-memory bytes
// (8 bytes in per row, 4 out per segment).  The design reads each pair
// once, coalesced, and keeps the reduction on chip:
//
//   * grid (ceil(N / 1024), B); one thread per row, 1024 rows a block;
//   * a block-wide segmented inclusive scan (cub::BlockScan over
//     (run-head flag, partial sum) pairs) sums every run of equal ids
//     inside the block;
//   * the last row of each run does one atomicAdd of its run's sum into
//     out[b, id]; ids outside [0, S) are dropped.
//
// On sorted ids (the group-by's case) a segment gets one atomic per
// block it touches, so at most two for a segment shorter than a block.
// Unsorted ids stay correct; only the order of the float additions
// differs from a sequential sum.  The caller zero-fills `out`.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 1024;

struct Partial {
  int head;   // 1 where a run of equal ids starts
  float sum;  // sum from the run's start (within the block) to this row
};

struct SegmentedAdd {
  __device__ __forceinline__ Partial operator()(const Partial& a,
                                                const Partial& b) const {
    return {a.head | b.head, b.head ? b.sum : a.sum + b.sum};
  }
};

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values,
                   const int* __restrict__ ids, float* __restrict__ out,
                   long long n, long long num_segments) {
  using Scan = cub::BlockScan<Partial, kThreads>;
  __shared__ typename Scan::TempStorage scan_storage;
  __shared__ int block_ids[kThreads];

  const long long b = blockIdx.y;
  const int t = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
  const bool in_row = i < n;
  // Rows past the end take id -1: never a real segment, never added.
  const int id = in_row ? ids[b * n + i] : -1;
  const float v = in_row ? values[b * n + i] : 0.0f;
  block_ids[t] = id;
  __syncthreads();

  const bool head = (t == 0) || (block_ids[t - 1] != id);
  const bool tail = (t == kThreads - 1) || (block_ids[t + 1] != id);
  Partial run;
  Scan(scan_storage).InclusiveScan(Partial{head ? 1 : 0, v}, run,
                                   SegmentedAdd());

  if (in_row && tail && id >= 0 && id < num_segments) {
    atomicAdd(out + b * num_segments + id, run.sum);
  }
}

}  // namespace

extern "C" int segment_sum_f32(const float* values, const int* ids,
                               float* out, long long batch, long long n,
                               long long num_segments, void* stream) {
  if (batch == 0 || n == 0) return 0;
  dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
            static_cast<unsigned>(batch));
  segment_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, ids, out, n, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
