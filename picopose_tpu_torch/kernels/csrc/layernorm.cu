// LayerNorm over the last axis of a (rows, C) token stream.
//
// Replaces picopose_tpu/ops/pallas/layernorm.py::layernorm_pallas
// (_ln_kernel): fp32 sums of x and of x*x, where the square is taken in
// x's dtype (bf16 products rounded to bf16, as the TPU kernel does);
// var = max(E[x^2] - E[x]^2, 0); y = (x - mean) * (rsqrt(var + eps) * scale)
// + bias in fp32, written in x's dtype.  scale and bias stay fp32.
//
// Bound: bytes.  At (16*257, 1024) bf16 the kernel must read 8.4 MB and
// write 8.4 MB, ~5 us at 3.35 TB/s, against ~30 MFLOP.
//
// One warp per row, 8 rows per block, no block-wide barrier.  For the ViT
// widths (C = 128, 384, 768, 1024, 1536) the elements per lane are a
// compile-time count: each lane loads its share in 16-byte vectors (8-byte
// where the share is not a multiple of 8 bf16), neighbouring lanes on
// neighbouring vectors, and keeps the row in registers between the warp-
// shuffle sums and the output, so x is read from device memory once and y
// written once with vector stores; scale and bias are read as float4.
// Any other C that is a multiple of 16 bytes takes a runtime loop that
// reads the row a second time for the output (from L1/L2).

#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;

// W consecutive elements of T, widened to fp32; ss gets the squares taken
// in T (bf16 products rounded to bf16, as on the TPU)
template <typename T, int W> struct Vec;

template <int W>
struct Vec<float, W> {
  static_assert(W == 4, "fp32 moves in 16-byte vectors");
  __device__ static void load(const float* p, float* v, float& s, float& ss) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int W>
struct Vec<__nv_bfloat16, W> {
  static_assert(W == 4 || W == 8, "bf16 moves in 8- or 16-byte vectors");
  using Raw = typename std::conditional<W == 8, uint4, uint2>::type;
  __device__ static void load(const __nv_bfloat16* p, float* v, float& s, float& ss) {
    const Raw raw = __ldg(reinterpret_cast<const Raw*>(p));
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      const float2 q = __bfloat1622float2(__hmul2(h[i], h[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
      s += f.x + f.y;
      ss += q.x + q.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    Raw raw;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<Raw*>(p) = raw;
  }
};

// v <- (v - mean) * (inv * scale[c..c+W)) + bias[c..c+W), W a multiple of 4
template <int W>
__device__ __forceinline__ void affine(float* v, const float* __restrict__ scale,
                                       const float* __restrict__ bias, int c, float mean,
                                       float inv) {
#pragma unroll
  for (int i = 0; i < W; i += 4) {
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + c + i));
    const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + c + i));
    v[i] = (v[i] - mean) * (inv * sc.x) + bi.x;
    v[i + 1] = (v[i + 1] - mean) * (inv * sc.y) + bi.y;
    v[i + 2] = (v[i + 2] - mean) * (inv * sc.z) + bi.z;
    v[i + 3] = (v[i + 3] - mean) * (inv * sc.w) + bi.w;
  }
}

__device__ __forceinline__ void stats(float s, float ss, float inv_c, float eps, float& mean,
                                      float& inv) {
  s = pp::warp_sum(s);
  ss = pp::warp_sum(ss);
  mean = s * inv_c;
  const float var = fmaxf(ss * inv_c - mean * mean, 0.f);
  inv = rsqrtf(var + eps);
}

// C = 32 * EPL: the row stays in registers
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
layernorm_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, long long rows,
                     float eps) {
  constexpr int C = 32 * EPL;
  constexpr int W = (EPL % (16 / sizeof(T)) == 0) ? 16 / sizeof(T) : 4;  // per load
  constexpr int NL = EPL / W;
  static_assert(EPL % W == 0, "elements per lane come in whole vectors");
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * C;
  float v[EPL];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NL; ++i) Vec<T, W>::load(xr + (i * 32 + lane) * W, v + i * W, s, ss);
  float mean, inv;
  stats(s, ss, 1.f / C, eps, mean, inv);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c = (i * 32 + lane) * W;
    affine<W>(v + i * W, scale, bias, c, mean, inv);
    Vec<T, W>::store(yr + c, v + i * W);
  }
}

// any C that is a multiple of one 16-byte vector: two passes over the row
template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_loop_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y, long long rows, int C,
                      float eps) {
  constexpr int W = 16 / sizeof(T);
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float v[W];
  float s = 0.f, ss = 0.f;
  for (int c = lane * W; c < C; c += 32 * W) Vec<T, W>::load(xr + c, v, s, ss);
  float mean, inv;
  stats(s, ss, 1.f / static_cast<float>(C), eps, mean, inv);
  for (int c = lane * W; c < C; c += 32 * W) {
    float unused = 0.f, unused2 = 0.f;
    Vec<T, W>::load(xr + c, v, unused, unused2);
    affine<W>(v, scale, bias, c, mean, inv);
    Vec<T, W>::store(yr + c, v);
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y, long long rows,
           int C, float eps, cudaStream_t s) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL || C % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (C) {
#define PP_LN_WIDTH(c)                                                                   \
  case c:                                                                                \
    layernorm_row_kernel<T, c / 32><<<grid, kThreads, 0, s>>>(xi, scale, bias, yo, rows, eps); \
    break;
    PP_LN_WIDTH(128)
    PP_LN_WIDTH(384)
    PP_LN_WIDTH(768)
    PP_LN_WIDTH(1024)
    PP_LN_WIDTH(1536)
#undef PP_LN_WIDTH
    default:
      layernorm_loop_kernel<T><<<grid, kThreads, 0, s>>>(xi, scale, bias, yo, rows, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, C) contiguous, 16-byte aligned, C a multiple of 16 bytes;
// scale, bias: (C,) fp32, 16-byte aligned.
extern "C" int pp_layernorm(const void* x, const void* scale, const void* bias,
                            void* y, long long rows, int C, float eps,
                            int is_bf16, void* stream) {
  if (rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  return is_bf16 ? launch<__nv_bfloat16>(x, sc, bi, y, rows, C, eps, s)
                 : launch<float>(x, sc, bi, y, rows, C, eps, s);
}

PP_EXPORT_ERROR_STRING
