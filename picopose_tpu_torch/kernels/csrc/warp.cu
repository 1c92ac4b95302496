// Bilinear feature warp: sample a (Hp, Wp, C) source map at (x, y) pixel
// coordinates, align_corners=True pixel space, zero padding.
//
// Replaces picopose_tpu/ops/pallas/warp.py::warp_pallas (_warp_kernel,
// _onehot_matmul).  The TPU kernel evaluates the sample as a one-hot
// (TP, Q) x (Q, C) matmul because the TPU gathers slowly; on Hopper the
// same function is a 4-tap gather.  Rounding follows the TPU kernel: each
// weight wy*wx is formed in fp32 and rounded to the feature dtype, the four
// products are summed in fp32 (taps in the order (0,0), (0,1), (1,0),
// (1,1), those outside the map left out), and the output is rounded once.
// Stream b reads source map b / group (hypotheses folded into the batch
// axis share one query map; the repeated map never exists in memory).
//
// Bound: bytes.  At the 64^2 level (80 streams over 16 maps, C = 256,
// bf16) it must read 34 MB of source and 2.6 MB of coordinates and write
// 168 MB, ~0.06 ms at 3.35 TB/s, against ~0.3 GFLOP.  Per output byte the
// work is small (four fused multiply-adds and a widening per channel), so
// the instructions that every pixel pays once (its corner and weights, its
// tap addresses, their bounds) weigh as much as the data: with one warp per
// pixel and eight channels per lane the warp pays them for every 512
// bytes of output.  This version:
//  * gives each pixel a group of kLanes = 8 lanes, four pixels per warp;
//    a lane holds kVecs = 4 vectors of 16 bytes of a tap (8 lanes x 64 B
//    = one 512-byte bf16 row per pass), so the per-pixel instructions are
//    paid once per 64 bytes of a lane's output, not once per 16, and each
//    lane computes its pixel's corner and weights itself (no shuffles);
//  * starts all four taps' loads of a pass (16 vectors per lane) before
//    it uses any: each warp keeps 8 KB of loads in flight.  That takes ~96
//    registers per thread, so the SM holds ~20 warps; blocks of 4 warps
//    fill them, where blocks of 8 would leave 4 idle (16 warps);
//  * reads taps through L1 (the read-only path): consecutive pixels of a
//    warp share tap columns on smooth flows, and the second read of a
//    column finds it there;
//  * writes the output with streaming stores (st.global.cs): it is written
//    once and never read here, and kept out of L2's way it leaves the
//    source maps there for the other streams of their group.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                   // warps per block
constexpr int kLanes = 8;                   // lanes per output pixel
constexpr int kPixels = 32 / kLanes;        // output pixels per warp
constexpr int kVecs = 32 / kLanes;          // 16-byte vectors per lane, tap and pass

// A 16-byte vector of T widened to fp32, and fp32 values rounded into one.
template <typename T> __device__ __forceinline__ void widen(const uint4& raw, float* v);
template <> __device__ __forceinline__ void widen<float>(const uint4& raw, float* v) {
  v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw, float* v) {
  pp::unpack8(raw, v);
}
template <typename T> __device__ __forceinline__ uint4 narrow(const float* v);
template <> __device__ __forceinline__ uint4 narrow<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 narrow<__nv_bfloat16>(const float* v) {
  uint4 raw;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ cen,
            T* __restrict__ out, long long pixels, int P, int Hp, int Wp,
            int C, int group) {
  constexpr int V = pp::Vec16<T>::N;
  const int lane = threadIdx.x & 31, l = lane % kLanes;
  const long long pix =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kPixels + lane / kLanes;
  if (pix >= pixels) return;  // nothing below is warp-collective

  // The corner is clamped before the conversion (a float far out of int
  // range has no defined conversion): a clamped centre has every tap
  // outside the map.  Every lane of the pixel's group computes the same.
  const float cx = __ldg(cen + 2 * pix), cy = __ldg(cen + 2 * pix + 1);
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(Wp) + 1.f));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), static_cast<float>(Hp) + 1.f));
  const T* src = feat + static_cast<size_t>(pix / P / group) * Hp * Wp * C;
  float w[4];
  bool in[4];
  const uint4* tap[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xx = x0 + (t & 1), yy = y0 + (t >> 1);
    w[t] = pp::round_to<T>(((t >> 1) ? fy : 1.f - fy) * ((t & 1) ? fx : 1.f - fx));
    in[t] = xx >= 0 && xx < Wp && yy >= 0 && yy < Hp;
    tap[t] = reinterpret_cast<const uint4*>(src + (in[t] ? static_cast<size_t>(yy) * Wp + xx : 0) * C);
  }

  const int vecs = C / V;  // per row
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(pix) * C);
  for (int base = l; base < vecs; base += 32) {  // a pass covers 32 vectors of the row
    uint4 raw[4][kVecs];  // every tap's vectors in flight before any is used
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = base + kLanes * i;
        raw[t][i] = in[t] && q < vecs ? __ldg(tap[t] + q) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!in[t]) continue;
        float v[V];
        widen<T>(raw[t][i], v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(w[t], v[e], acc[e]);
      }
      if (base + kLanes * i < vecs) __stcs(dst + base + kLanes * i, narrow<T>(acc));
    }
  }
}

template <typename T>
int launch(const void* feat, const void* cen, void* out, int B, int P, int Hp,
           int Wp, int C, int group, cudaStream_t s) {
  if (C % pp::Vec16<T>::N != 0) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(B) * P;
  const long long blocks = (pixels + kWarps * kPixels - 1) / (kWarps * kPixels);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(cen),
      static_cast<T*>(out), pixels, P, Hp, Wp, C, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat (B / group, Hp*Wp, C), cen (B, P, 2) fp32 (x, y), out (B, P, C);
// feat and out bf16 (is_bf16) or fp32, all 16-byte aligned.
extern "C" int pp_warp(const void* feat, const void* cen, void* out, int B,
                       int P, int Hp, int Wp, int C, int group, int is_bf16,
                       void* stream) {
  if (B <= 0 || P <= 0 || Hp <= 0 || Wp <= 0 || C <= 0 || group <= 0 || B % group != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(feat, cen, out, B, P, Hp, Wp, C, group, s)
                 : launch<float>(feat, cen, out, B, P, Hp, Wp, C, group, s);
}

PP_EXPORT_ERROR_STRING
