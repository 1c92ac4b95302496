// LayerNorm over the last axis of a (rows, C) token stream.
//
// Replaces picopose_tpu/ops/pallas/layernorm.py::layernorm_pallas
// (_ln_kernel): fp32 sums of x and of x*x, where the square is taken in
// x's dtype (bf16 products rounded to bf16, as the TPU kernel does);
// var = max(E[x^2] - E[x]^2, 0); y = (x - mean) * (rsqrt(var + eps) * scale)
// + bias in fp32, written in x's dtype.  scale and bias stay fp32.
//
// Bound: bytes.  At (16*257, 1024) bf16 the kernel must read 8.4 MB and
// write 8.4 MB, ~5 us at 3.35 TB/s, against ~30 MFLOP.  One block per
// row: the row (2 KB in bf16) is read once from device memory for the
// sums; the second pass for the output finds it in L1/L2.  Neighbouring
// threads touch neighbouring elements so every load is coalesced.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float square_in_dtype(float v) { return v * v; }
__device__ __forceinline__ float square_in_dtype(__nv_bfloat16 v) {
  return __bfloat162float(__hmul(v, v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, int C,
                 float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * C;
  T* yr = y + static_cast<size_t>(blockIdx.x) * C;

  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const T v = xr[c];
    s += pp::to_f(v);
    ss += square_in_dtype(v);
  }
  s = pp::warp_sum(s);
  ss = pp::warp_sum(ss);

  __shared__ float red[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  s = 0.f;
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    s += red[0][w];
    ss += red[1][w];
  }

  const float inv_c = 1.f / static_cast<float>(C);
  const float mean = s * inv_c;
  const float var = fmaxf(ss * inv_c - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    yr[c] = pp::from_f<T>((pp::to_f(xr[c]) - mean) * (inv * scale[c]) + bias[c]);
  }
}

}  // namespace

extern "C" int pp_layernorm(const void* x, const void* scale, const void* bias,
                            void* y, long long rows, int C, float eps,
                            int is_bf16, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || C <= 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    layernorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc, bi,
        static_cast<__nv_bfloat16*>(y), C, eps);
  } else {
    layernorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), sc, bi, static_cast<float*>(y), C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

PP_EXPORT_ERROR_STRING
