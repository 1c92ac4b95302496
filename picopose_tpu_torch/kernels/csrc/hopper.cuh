// Hopper building blocks shared by the port's sm_90a kernels: mbarriers,
// TMA loads over tensor maps (the encoder looked up at run time, so no
// library links libcuda), wgmma shared-memory descriptors, SS products
// with fp32 accumulators (bf16) and s32 accumulators (s8).
#pragma once

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums

#include <cstdint>

// internal linkage throughout: a function-local static would otherwise be
// one object across every library loaded in the process
namespace {
namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's generic shared-memory accesses before later TMA
// (async-proxy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over the first `threads` threads of the block (id 1..15; 0 is
// __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA tile loads; coordinates are signed, and elements outside the tensor
// arrive as zeros (and count towards the transaction bytes)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile whose rows are 128 B (64 bf16) under
// the 128-byte swizzle, 8-row atoms of 1024 B packed (SBO), LBO unused.
// Step along K by adding 32 B (16 bf16) to addr.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {  // all but the newest group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma registers across the
// asynchronous window
template <int n>
__device__ __forceinline__ void pin(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void pin(int32_t (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void pin(uint32_t (&r)[n][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define PP_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define PP_F8(a, i) PP_F4(a, i), PP_F4(a, i + 4)
#define PP_R4(a, i) "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3])
#define PP_R8(a, i) PP_R4(a, i), PP_R4(a, i + 4)
#define PP_ACC128(R) R(d, 0), R(d, 8), R(d, 16), R(d, 24), R(d, 32), R(d, 40), R(d, 48), R(d, 56), \
    R(d, 64), R(d, 72), R(d, 80), R(d, 88), R(d, 96), R(d, 104), R(d, 112), R(d, 120)
#define PP_REGS128                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "        \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "  \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127"

// d (+)= A B with A, B from shared memory, both K-major, bf16 -> fp32.
// Accumulator layout of m64nNk16 (per warp 16 rows): element i sits at row
// lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" PP_REGS128 "}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : PP_ACC128(PP_F8)
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B with A, B from shared memory, both K-major, s8 -> s32 (exact
// sums; integer wgmma has no scale or transpose operands).  Each call
// consumes 32 bytes of K, as a bf16 k16 step does, and the s32
// accumulators sit where m64nNk16's fp32 ones do.
__device__ __forceinline__ void mma_ss_n256(int32_t (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" PP_REGS128 "}, "
      "%128, %129, p;\n}\n"
      : PP_ACC128(PP_R8)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : PP_F8(d, 0), PP_F8(d, 8), PP_F8(d, 16), PP_F8(d, 24), PP_F8(d, 32), PP_F8(d, 40),
        PP_F8(d, 48), PP_F8(d, 56)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : PP_F8(d, 0)
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B with A from registers, B from shared memory MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PP_F8(d, 0), PP_F8(d, 8), PP_F8(d, 16), PP_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : PP_F8(d, 0), PP_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef PP_REGS128
#undef PP_ACC128
#undef PP_R8
#undef PP_R4
#undef PP_F8
#undef PP_F4

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time, without linking libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &res);
#endif
    return e == cudaSuccess && res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dims (dims[0] contiguous; strides[k] in bytes of
// dim k + 1) whose box rows are 128 bytes (64 bf16, 128 int8 as uint8)
// under the 128-byte swizzle.  Returns false where the encoder refuses it.
inline bool encode_sw128(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode_tiled() == nullptr) return false;
  return encode_tiled()(map, dtype, rank, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count, cached per device
inline int sm_count() {
  static int sms_of[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (sms_of[dev] == 0) cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms_of[dev];
}

}  // namespace hop
}  // namespace
