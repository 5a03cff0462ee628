// segment_sum: per-segment float32 sums, batched (B, N) -> (B, S).
//
// Replaces the TPU kernel src/repro/kernels/segment_sum.py::segment_sum
// (_kernel, a one-hot MXU product per segment tile x input block with
// off-band tiles skipped).  Hopper has no reason to spend a matrix unit
// on a scatter: the work is one read of every (id, value) pair and one
// write of every sum, so the kernel is bound by device-memory bytes
// (8 bytes in per row, 4 out per segment).  Two passes:
//
//   * pass 1, grid (ceil(N / 2048), min(B, 65535)), 256 threads (CTA
//     y walks rows y, y + 65535, ...: one row a CTA below 65,536 rows,
//     and no limit on B): each thread loads
//     8 contiguous rows (two 16-byte loads of ids, two of values where
//     N % 4 == 0 and the rows are 16-byte aligned; scalar loads else)
//     and sums its runs of equal ids sequentially in registers.  A run
//     that starts and ends inside one thread is complete.  The runs
//     that cross threads are joined by a block-wide segmented exclusive
//     scan of each thread's last run (cub::BlockScan over (id, sum,
//     whole-thread) carries), in a fixed order.  Every run that lies
//     strictly inside the tile is added with one atomicAdd.  The
//     tile's first and last run (they may continue into the tiles
//     beside it) go to a carry buffer instead: (head id, head sum,
//     tail id, tail sum, single-run flag) per tile;
//   * pass 2, one thread per tile (the same row walk): a head run that
//     does not continue the previous tile's tail, and every tail run,
//     starts a chain; the thread sums the chain's parts in tile order
//     over the following single-run tiles and adds the total with one
//     atomicAdd.  Chains of ids outside [0, S) are skipped (the padded
//     tail is one such run).
//
// Sorted ids (the group-by's case) form one run per segment, so each
// segment gets exactly one addend onto the zero-filled output: the sums
// are bit-identical from launch to launch, for non-integer values too.
// Unsorted ids stay correct; runs of one id then meet in the atomics in
// any order.  Ids outside [0, S) are dropped.  A segment that spans m
// tiles costs its pass-2 thread m dependent reads of the carry buffer.
// The caller zero-fills `out` and allocates the carries.

#include <cstdint>

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kPastEnd = -1;           // id of rows past N: never a segment
constexpr long long kMaxGridY = 65535;  // grid.y limit: CTAs walk the rows

struct Carry {
  int id;
  float sum;
  int whole;   // 1 where the range scanned so far is one run
};

struct CarryOp {
  __device__ __forceinline__ Carry operator()(const Carry& a,
                                              const Carry& b) const {
    if (b.whole && a.id == b.id) return {b.id, a.sum + b.sum, a.whole};
    return {b.id, b.sum, 0};
  }
};

struct TileCarry {
  int head_id;
  float head_sum;
  int tail_id;       // == head_id where the tile is one run
  float tail_sum;
  int single;
  int pad[3];
};

__device__ __forceinline__ void add(float* out, long long s, int id,
                                    float v) {
  if (id >= 0 && id < s) atomicAdd(out + id, v);
}

__global__ void __launch_bounds__(kThreads)
segment_sum_tiles(const float* __restrict__ values,
                  const int* __restrict__ ids, float* __restrict__ out,
                  TileCarry* __restrict__ carries, long long batch,
                  long long n, long long num_segments, int vec) {
  using Scan = cub::BlockScan<Carry, kThreads>;
  __shared__ typename Scan::TempStorage scan_storage;
  __shared__ int first_ids[kThreads];

  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {  // CTA-uniform
    __syncthreads();               // the last row's shared reads done
    const int t = threadIdx.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * kTile
                           + static_cast<long long>(t) * kItems;
    const float* vb = values + b * n;
    const int* ib = ids + b * n;
    float* ob = out + b * num_segments;

    int id[kItems];
    float v[kItems];
    if (vec && row0 + kItems <= n) {
#pragma unroll
      for (int j = 0; j < kItems; j += 4) {
        const int4 i4 = __ldg(reinterpret_cast<const int4*>(ib + row0 + j));
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(vb + row0 + j));
        id[j] = i4.x; id[j + 1] = i4.y; id[j + 2] = i4.z; id[j + 3] = i4.w;
        v[j] = v4.x; v[j + 1] = v4.y; v[j + 2] = v4.z; v[j + 3] = v4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool in = row0 + j < n;
        id[j] = in ? __ldg(ib + row0 + j) : kPastEnd;
        v[j] = in ? __ldg(vb + row0 + j) : 0.0f;
      }
    }
    first_ids[t] = id[0];

    // Runs inside the thread: the first is kept (it may continue the
    // previous thread's last run), the middle ones are complete.
    float first_sum = 0.0f, run = v[0];
    bool in_first = true;
#pragma unroll
    for (int j = 1; j < kItems; ++j) {
      if (id[j] == id[j - 1]) {
        run += v[j];
      } else {
        if (in_first) {
          first_sum = run;
          in_first = false;
        } else {
          add(ob, num_segments, id[j - 1], run);
        }
        run = v[j];
      }
    }
    const bool whole = in_first;
    if (whole) first_sum = run;

    Carry prefix;
    Scan(scan_storage).ExclusiveScan(Carry{id[kItems - 1], run, whole ? 1 : 0},
                                     prefix, CarryOp());
    __syncthreads();                     // first_ids complete
    const bool last_thread = t == kThreads - 1;
    const int next_first = last_thread ? 0 : first_ids[t + 1];
    const bool joins_prev = t > 0 && prefix.id == id[0];
    const bool from_row0 = t == 0 || (prefix.whole && joins_prev);
    TileCarry* c = carries + b * gridDim.x + blockIdx.x;

    // The thread's first run ends here unless the whole thread is one run
    // that the next thread continues.
    if (!whole || last_thread || next_first != id[0]) {
      const float total = joins_prev ? prefix.sum + first_sum : first_sum;
      const bool to_end = whole && last_thread;
      if (from_row0) {
        c->head_id = id[0];
        c->head_sum = total;
        if (to_end) {
          c->tail_id = id[0];
          c->tail_sum = total;
          c->single = 1;
        }
      } else if (to_end) {
        c->tail_id = id[0];
        c->tail_sum = total;
        c->single = 0;
      } else {
        add(ob, num_segments, id[0], total);
      }
    }
    // Its last run, when it is not the first, starts here; it ends here
    // unless the next thread continues it.
    if (!whole && (last_thread || next_first != id[kItems - 1])) {
      if (last_thread) {
        c->tail_id = id[kItems - 1];
        c->tail_sum = run;
        c->single = 0;
      } else {
        add(ob, num_segments, id[kItems - 1], run);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_fixup(const TileCarry* __restrict__ carries,
                  float* __restrict__ out, long long batch,
                  long long n_tiles, long long num_segments) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n_tiles) return;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const TileCarry* cb = carries + b * n_tiles;
    float* ob = out + b * num_segments;
    const TileCarry c = cb[i];

    // Sum a chain from tile i over the heads of the tiles after it, while
    // the run reaches the end of each tile, in tile order.
    auto chain = [&](int id, float sum, bool reaches_end) {
      if (id < 0 || id >= num_segments) return;
      for (long long j = i + 1; reaches_end && j < n_tiles; ++j) {
        const TileCarry& d = cb[j];
        if (d.head_id != id) break;
        sum += d.head_sum;
        reaches_end = d.single;
      }
      atomicAdd(ob + id, sum);
    };
    if (i == 0 || cb[i - 1].tail_id != c.head_id)
      chain(c.head_id, c.head_sum, c.single);
    if (!c.single) chain(c.tail_id, c.tail_sum, true);
  }
}

}  // namespace

extern "C" int segment_sum_f32(const float* values, const int* ids,
                               float* out, void* carries, long long batch,
                               long long n, long long num_segments,
                               void* stream) {
  if (batch == 0 || n == 0) return 0;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = n % 4 == 0
                  && reinterpret_cast<uintptr_t>(values) % 16 == 0
                  && reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  TileCarry* tc = static_cast<TileCarry*>(carries);
  const unsigned rows = static_cast<unsigned>(batch < kMaxGridY ? batch
                                                                : kMaxGridY);
  segment_sum_tiles<<<dim3(static_cast<unsigned>(n_tiles), rows),
                      kThreads, 0, st>>>(values, ids, out, tc, batch, n,
                                         num_segments, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sum_fixup<<<dim3(static_cast<unsigned>(
                               (n_tiles + kThreads - 1) / kThreads), rows),
                      kThreads, 0, st>>>(tc, out, batch, n_tiles,
                                         num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
