// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace pp {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One 16-byte vector of T (8 bf16 or 4 fp32) per lane: loads through the
// read-only path and widened to fp32, stores rounded once from fp32.
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
// eight bf16 widened to fp32
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// v rounded to T and widened back (the TPU kernels' weight rounding).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

}  // namespace pp

// Every library exports the runtime's message for the codes it returns.
#define PP_EXPORT_ERROR_STRING                                   \
  extern "C" const char* pp_error_string(int e) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(e));      \
  }
