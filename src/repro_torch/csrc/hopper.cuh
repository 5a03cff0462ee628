// Hopper (sm_90a) building blocks in inline PTX: shared-memory
// mbarriers, TMA tensor and bulk loads, cp.async copies, register
// reallocation between warpgroups (setmaxnreg), and warpgroup matrix
// products (wgmma, bfloat16 or float16 operands) with their
// shared-memory descriptors; on the host, the 16-bit tensor maps the TMA
// loads read.  Included by the kernels that use them;
// `_build.library_path` hashes every header here, so an edit rebuilds
// them.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`
// (the first completion is phase 0).  A wait that never ends is a bug
// (a parity or byte-count error): after about 2^26 polls the kernel
// traps, so the launch fails instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a box of a 3-D tensor into shared memory and
// the copy completes on an mbarrier.  Coordinates innermost first; a box
// past the tensor's edge is filled with zeros.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One thread copies `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) into shared memory; the copy completes on
// an mbarrier, as a TMA load does.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// cp.async: each thread copies kBytes (4, 8 or 16; both addresses
// aligned to it) into shared memory, of which the first `src_bytes` come
// from `src` and the rest are zeros (src_bytes = 0: all zeros, nothing
// read).  A thread's copies form a group at commit; wait<N> returns when
// at most N of its latest groups are still in flight.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         uint32_t src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// setmaxnreg: a warpgroup (or a lone warp) gives back or takes registers
// a thread.  Executed by every thread of it; the roles must never
// reconverge after it, or ptxas ignores it.
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a shared-memory operand in the 128-byte swizzle layout
// (what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128
// bytes, 8-row atoms of 1,024 bytes, 1,024-byte aligned).  Offsets in
// bytes: `lbo` is the leading and `sbo` the stride byte offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's reads and writes of an accumulator register
// around the asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma operand type of element type T: "bf16" or "f16".
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

#define HOPPER_ACC32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define HOPPER_ACC64                                                        \
  HOPPER_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),    \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),    \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),    \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),    \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (64 x 16, smem,
// K-major); T (bf16 or half) operands.
#define HOPPER_SS_64(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               HOPPER_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"              \
               : HOPPER_ACC32                                               \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  if constexpr (kIsHalf<T>) {
    HOPPER_SS_64("f16");
  } else {
    HOPPER_SS_64("bf16");
  }
}

// D (64 x 64, f32) (+)= A (64 x 16, registers) . B (16 x 64, smem,
// MN-major: the transpose bit set); T operands.
#define HOPPER_RS_64(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               HOPPER_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : HOPPER_ACC32                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),   \
                 "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  if constexpr (kIsHalf<T>) {
    HOPPER_RS_64("f16");
  } else {
    HOPPER_RS_64("bf16");
  }
}

// D (64 x 128, f32) (+)= A (64 x 16, registers) . B (16 x 128, smem,
// MN-major: the transpose bit set); T operands.
#define HOPPER_RS_128(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               HOPPER_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : HOPPER_ACC64                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),   \
                 "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  if constexpr (kIsHalf<T>) {
    HOPPER_RS_128("f16");
  } else {
    HOPPER_RS_128("bf16");
  }
}

// Two floats as one register of two T (bf16 or half), lo in the low
// half, rounded to nearest; and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (kIsHalf<T>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
}

// ---------------------------------------------------------------------------
// Host: 16-bit tensor maps for the TMA loads
// ---------------------------------------------------------------------------

constexpr int kNoEncoder = -1;     // cuTensorMapEncodeTiled not found
constexpr int kBadTensorMap = -2;  // cuTensorMapEncodeTiled refused
constexpr int kBoxCols = 64;       // 16-bit columns of one 128-byte box row

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// a library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B·H, S, d) tensor of T (bf16 or half) as a 3-D map (d, S, B·H)
// with boxes of (64, rows, 1) in the 128-byte swizzle; reads past d or S
// fill zeros.  Rows of d elements: d·2 must be a multiple of 16.
template <typename T>
inline int tile_map(CUtensorMap* map, const void* ptr, long long d,
                    long long s, long long bh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d * 2),
                                 static_cast<cuuint64_t>(s * d * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

// The message of a library's error code: a CUDA error, or one of the
// tensor-map codes above.
inline const char* error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through the runtime";
  if (code == kBadTensorMap)
    return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
