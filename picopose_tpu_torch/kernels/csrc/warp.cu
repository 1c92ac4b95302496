// Bilinear feature warp: sample a (Hp, Wp, C) source map at (x, y) pixel
// coordinates, align_corners=True pixel space, zero padding.
//
// Replaces picopose_tpu/ops/pallas/warp.py::warp_pallas (_warp_kernel,
// _onehot_matmul).  The TPU kernel evaluates the sample as a one-hot
// (TP, Q) x (Q, C) matmul because the TPU gathers slowly; on Hopper the
// same function is a 4-tap gather.  Rounding follows the TPU kernel: each
// weight wy*wx is formed in fp32 and rounded to the feature dtype, the four
// products are summed in fp32, and the output is rounded once.  Stream b
// reads source map b / group (hypotheses folded into the batch axis share
// one query map; the repeated map never exists in memory).
//
// Bound: bytes.  At the 64^2 level (80 streams over 16 maps, C = 256,
// bf16) it must read 34 MB of source and 2.6 MB of coordinates and write
// 168 MB, ~0.06 ms at 3.35 TB/s, against ~0.3 GFLOP.  One warp per output
// pixel: each lane moves one 16-byte vector of channels per tap, so every
// tap row is one coalesced 512-byte read, and the output row one
// coalesced write.  The five hypotheses of a query read the same source
// rows, which L2 holds.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // output pixels per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ cen,
            T* __restrict__ out, long long pixels, int P, int Hp, int Wp,
            int C, int group) {
  constexpr int V = pp::Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pix >= pixels) return;
  const int b = static_cast<int>(pix / P);

  const float cx = cen[2 * pix], cy = cen[2 * pix + 1];
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  // clamp before converting (a float far out of int range has no defined
  // conversion): a clamped centre has every tap outside the map
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(Wp) + 1.f));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), static_cast<float>(Hp) + 1.f));

  const T* src = feat + static_cast<size_t>(b / group) * Hp * Wp * C;
  const T* row[4];
  float w[4];
  bool ok[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dy = t >> 1, dx = t & 1;
    const int yy = y0 + dy, xx = x0 + dx;
    ok[t] = yy >= 0 && yy < Hp && xx >= 0 && xx < Wp;
    row[t] = src + (static_cast<size_t>(ok[t] ? yy : 0) * Wp + (ok[t] ? xx : 0)) * C;
    w[t] = pp::round_to<T>((dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx));
  }

  T* dst = out + static_cast<size_t>(pix) * C;
  for (int c = lane * V; c < C; c += 32 * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!ok[t]) continue;
      float v[V];
      pp::load16(row[t] + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(w[t], v[i], acc[i]);
    }
    pp::store16(dst + c, acc);
  }
}

template <typename T>
int launch(const void* feat, const void* cen, void* out, int B, int P, int Hp,
           int Wp, int C, int group, cudaStream_t s) {
  if (C % pp::Vec16<T>::N != 0) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(B) * P;
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
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
