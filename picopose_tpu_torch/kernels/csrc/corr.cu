// Windowed correlation lookup for one pyramid level (the RAFT lookup).
//
// Replaces picopose_tpu/ops/pallas/corr.py::corr_window_pallas (the
// transposed variant, _window_kernel_transposed / _transposed_body).  For
// stream b and pixel p: corr(p, q) = f1[b, p] . f2[b / group, q] * C^-0.5,
// sampled bilinearly (zero padding) on a (2r+1)^2 window around cen[b, p];
// output channel k = kx*(2r+1) + ky (the outer index walks x).
//
// The TPU kernel computes whole correlation rows on the MXU and reduces
// the window with masked sums, because the TPU gathers slowly.  A bilinear
// window of radius r touches only the (2r+2)^2 integer cells
// [floor(cx)-r, floor(cx)+r+1] x [floor(cy)-r, floor(cy)+r+1], so this
// kernel computes just those dot products (36 for r = 2, against 1024 row
// entries at 64^2): fp32 sums of the products, times C^-0.5; a cell
// outside the map is exactly 0; the taps are lerped in y, then in x, in
// fp32, as the TPU kernel does, and rounded once to f1's dtype.
//
// Bound: bytes.  At G = Hp = 64 (80 streams over 16 maps, C = 256, bf16)
// it must read 168 MB of f1, 34 MB of f2 and 2.6 MB of centres and write
// 16 MB, ~0.066 ms at 3.35 TB/s, against 6 GFLOP of products.  One warp
// per pixel: each lane holds one 16-byte vector of f1's channels and reads
// the same slice of each of the 36 cells (coalesced 512-byte rows), then
// 36 warp-shuffle sums.  Neighbouring pixels and the hypotheses of one
// query read overlapping cells, which L1 and L2 hold.  The 36 independent
// loads in flight per lane are what hides their latency, so the kernel
// is capped at 128 registers (two 256-thread blocks per SM; uncapped it
// took 184 and ran one block per SM) rather than made to reduce each cell
// as it goes.  Tensor cores, TMA and one launch for all levels are later
// work.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // pixels per block

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32, 2)
corr_window_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   const float* __restrict__ cen, T* __restrict__ out,
                   long long pixels, int P, int Hp, int Wp, int C, int group,
                   float scale) {
  constexpr int V = pp::Vec16<T>::N;
  constexpr int M = 2 * R + 2;  // cells per window side
  constexpr int N = 2 * R + 1;  // taps per window side
  constexpr int NN = N * N;
  static_assert(NN <= 32, "one tap per lane");
  const int lane = threadIdx.x & 31;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pix >= pixels) return;
  const int b = static_cast<int>(pix / P);

  const float cx = cen[2 * pix], cy = cen[2 * pix + 1];
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  // clamp before converting (a float far out of int range has no defined
  // conversion): a clamped centre has every cell outside the map
  const float lo = -static_cast<float>(R + 2);
  const int bx = static_cast<int>(fminf(fmaxf(x0f, lo), static_cast<float>(Wp + R))) - R;
  const int by = static_cast<int>(fminf(fmaxf(y0f, lo), static_cast<float>(Hp + R))) - R;

  const T* q = f1 + static_cast<size_t>(pix) * C;
  const T* src = f2 + static_cast<size_t>(b / group) * Hp * Wp * C;
  float part[M * M];
#pragma unroll
  for (int j = 0; j < M * M; ++j) part[j] = 0.f;

  for (int c = lane * V; c < C; c += 32 * V) {
    float a[V];
    pp::load16(q + c, a);
#pragma unroll
    for (int j = 0; j < M * M; ++j) {
      const int yy = by + j / M, xx = bx + j % M;
      if (yy < 0 || yy >= Hp || xx < 0 || xx >= Wp) continue;  // warp-uniform
      float v[V];
      pp::load16(src + (static_cast<size_t>(yy) * Wp + xx) * C + c, v);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) s = fmaf(a[i], v[i], s);
      part[j] += s;
    }
  }
#pragma unroll
  for (int j = 0; j < M * M; ++j) part[j] = pp::warp_sum(part[j]) * scale;

  // every lane holds all cells; lane k writes tap k
  float mine = 0.f;
#pragma unroll
  for (int kx = 0; kx < N; ++kx) {
#pragma unroll
    for (int ky = 0; ky < N; ++ky) {
      const float r0 = (1.f - fy) * part[ky * M + kx] + fy * part[(ky + 1) * M + kx];
      const float r1 = (1.f - fy) * part[ky * M + kx + 1] + fy * part[(ky + 1) * M + kx + 1];
      if (kx * N + ky == lane) mine = (1.f - fx) * r0 + fx * r1;
    }
  }
  if (lane < NN) out[static_cast<size_t>(pix) * NN + lane] = pp::from_f<T>(mine);
}

template <typename T>
int launch(const void* f1, const void* f2, const void* cen, void* out, int B,
           int P, int Hp, int Wp, int C, int group, float scale, cudaStream_t s) {
  constexpr int R = 2;  // the flow decoder's lookup radius
  if (C % pp::Vec16<T>::N != 0) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(B) * P;
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  corr_window_kernel<T, R><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(cen), static_cast<T*>(out), pixels, P, Hp, Wp,
      C, group, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1 (B, P, C), f2 (B / group, Hp*Wp, C), cen (B, P, 2) fp32 (x, y),
// out (B, P, (2r+1)^2); f1, f2 and out bf16 (is_bf16) or fp32, f1 and f2
// 16-byte aligned; radius 2.
extern "C" int pp_corr_window(const void* f1, const void* f2, const void* cen,
                              void* out, int B, int P, int Hp, int Wp, int C,
                              int radius, int group, float scale, int is_bf16,
                              void* stream) {
  if (B <= 0 || P <= 0 || Hp <= 0 || Wp <= 0 || C <= 0 || group <= 0 || B % group != 0 || radius != 2)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(f1, f2, cen, out, B, P, Hp, Wp, C, group, scale, s)
                 : launch<float>(f1, f2, cen, out, B, P, Hp, Wp, C, group, scale, s);
}

PP_EXPORT_ERROR_STRING
