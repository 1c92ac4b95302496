// Windowed correlation lookup over the pyramid levels of one decoder level
// (the RAFT lookup), one launch for all of them.
//
// Replaces picopose_tpu/ops/pallas/corr.py::corr_window_pallas (the
// transposed variant, _window_kernel_transposed / _transposed_body), which
// the JAX package calls once per pyramid level.  For stream b, pixel p and
// level l: corr(p, q) = f1[b, p] . f2_l[b / group, q] * C^-0.5, sampled
// bilinearly (zero padding) on a (2r+1)^2 window around cen[b, p] / 2^s_l;
// output channel l*(2r+1)^2 + kx*(2r+1) + ky (the outer index walks x).
//
// A bilinear window of radius r touches only the (2r+2)^2 integer cells
// [floor(cx)-r, floor(cx)+r+1] x [floor(cy)-r, floor(cy)+r+1]: fp32 sums of
// their dot products, times C^-0.5; a cell outside the map is exactly 0;
// the taps are lerped in y, then in x, in fp32, as the TPU kernel does, and
// rounded once to f1's dtype.
//
// Bound: bytes.  At r = 2 and the 64^2 decoder level (80 streams over 16 maps, C =
// 256, bf16, three pyramid levels) it must read 168 MB of f1, 45 MB of f2
// and 2.6 MB of centres and write 49 MB, ~0.08 ms at 3.35 TB/s, against
// 18 GFLOP of window products.
//
// bf16 (C a multiple of 64 up to 256): one 256-thread block per
// 8 x 8 tile of one stream's pixels, two blocks per SM.  f1's tile (64 x C)
// arrives once by TMA (128-byte swizzle) and serves every level.  Per
// level, the tile's windows usually overlap: the block picks a 16 x 16 box
// of cells that holds the window of every pixel when the tile's window
// corners span at most 16 - (2r+2) cells (10 at r = 2), else the box
// around the centre pixel's window.  The box arrives by TMA in 64-channel slices through a two-slot
// ring (cells outside the map arrive as zeros), and the tile's 64 x 256
// dot products are one wgmma product over C (each warpgroup 128 cells,
// m64n128k16, fp32).  The products, scaled, go to shared memory, and each
// (pixel, tap) gathers its four cells and lerps.  A pixel whose window
// leaves the box (rotated or scaled flow, the edge of an object mask, a
// far-off centre) takes the per-pixel path inside the same launch: one
// warp per pixel, f1 from shared memory, its (2r+2)^2 cells from device memory
// (L2) and warp-shuffle sums.  `stats` (optional) counts tile-levels,
// tile-levels with per-pixel pixels, and per-pixel pixel-levels.
//
// fp32 (tests, small sizes): the per-pixel path alone on the CUDA cores,
// one warp per (pixel, level), no TF32.
//
// The lookup radius r is a template argument of both kernels for r in
// 1..4 (the flow decoder's config radius 2..9; PicoPose ships r = 2, RAFT
// r = 4).  The box stays 16 x 16 cells, so the span of window corners one
// box covers shrinks with r (10 cells at r = 2, 6 at r = 4) and wider
// windows leave it more often for the per-pixel path.  Any other radius
// (r = 0, r >= 5) runs corr_any_kernel: one warp per (pixel, level) on
// the CUDA cores for either dtype, two rows of cells in shared memory at a
// time, so its footprint does not grow with r.  A launch takes at most
// kMaxLevels levels; the caller launches once per group of levels and
// each launch writes its levels' channels of the shared output.

#include "hopper.cuh"

#include <climits>

namespace {

constexpr int kMaxLevels = 4;  // levels per launch

// a window of lookup radius R: M cells and NT taps per side, NN taps
template <int R>
struct Win {
  static constexpr int M = 2 * R + 2;
  static constexpr int NT = 2 * R + 1;
  static constexpr int NN = NT * NT;
};

struct Level {
  const void* f2;  // (B / group, Hp, Wp, C)
  int Hp, Wp, shift;
};

struct Args {
  Level lv[kMaxLevels];
  const float* cen;  // (B, H, W, 2) level-0 centres (x, y)
  void* out;         // (B, H, W, Lout * NN); this launch writes levels l0 .. l0 + L - 1
  int* stats;
  int B, H, W, C, L, group;
  int l0, Lout;
  int radius;        // corr_any_kernel's; the templates carry their own
  float scale;
};

// the window's clamped corner cell (a float far out of int range has no
// defined conversion: a clamped centre has every cell outside the map) and
// its fractions
struct Window {
  int bx, by;
  float fx, fy;
};

__device__ __forceinline__ Window window_of(float cx, float cy, int Hp, int Wp, int R) {
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float lo = -static_cast<float>(R + 2);
  Window w;
  w.fx = cx - x0f;
  w.fy = cy - y0f;
  w.bx = static_cast<int>(fminf(fmaxf(x0f, lo), static_cast<float>(Wp + R))) - R;
  w.by = static_cast<int>(fminf(fmaxf(y0f, lo), static_cast<float>(Hp + R))) - R;
  return w;
}

// tap (kx, ky) from the window's cells c(row, col)
template <typename Cell>
__device__ __forceinline__ float lerp_tap(int kx, int ky, float fx, float fy, Cell c) {
  const float r0 = (1.f - fy) * c(ky, kx) + fy * c(ky + 1, kx);
  const float r1 = (1.f - fy) * c(ky, kx + 1) + fy * c(ky + 1, kx + 1);
  return (1.f - fx) * r0 + fx * r1;
}

// every lane holds all cells (part[row * M + col]); lane k % 32 returns
// tap k of pass k / 32
template <int R>
__device__ __forceinline__ float lane_tap(const float (&part)[Win<R>::M * Win<R>::M], float fx,
                                          float fy, int lane, int pass) {
  constexpr int M = Win<R>::M, NT = Win<R>::NT;
  float mine = 0.f;
#pragma unroll
  for (int kx = 0; kx < NT; ++kx)
#pragma unroll
    for (int ky = 0; ky < NT; ++ky) {
      const float t = lerp_tap(kx, ky, fx, fy, [&](int r, int c) { return part[r * M + c]; });
      if (kx * NT + ky == lane + 32 * pass) mine = t;
    }
  return mine;
}

// ---- bf16: tiles of pixels on wgmma --------------------------------------

namespace tile {

constexpr int kSide = 8;                 // pixels per tile side
constexpr int kPix = kSide * kSide;      // wgmma M
constexpr int kBox = 16;                 // cells per box side
// window corners of radius R within [o, o + span<R>] lie in a box at o
template <int R> constexpr int span = kBox - Win<R>::M;
constexpr int kThreads = 256;
constexpr int kF1Slice = kPix * 128;     // 64 pixels x 64 channels
constexpr int kBoxSlice = kBox * kBox * 128;  // 256 cells x 64 channels
constexpr int kStgLd = kBox * kBox + 8;  // fp32 row stride of the staged products
constexpr int kF1 = 0;                   // [C / 64] slices
constexpr int kWork = 4 * kF1Slice;      // the ring's two slots, later the staging
constexpr int kWorkBytes = kPix * kStgLd * 4;
static_assert(kWorkBytes >= 2 * kBoxSlice, "staging covers the ring");
constexpr int kBar = kWork + kWorkBytes;  // f1, full[2]
constexpr int kInfo = kBar + 64;          // per pixel: bx, by, fx, fy, mode
constexpr int kRed = 10 + 3 * 8;          // ints: corner extremes and counts, candidates
constexpr int kBytes = kInfo + kPix * 20 + kRed * 4 + 1024;  // + alignment
constexpr int kRounds = 3;  // boxes per tile and level at most
constexpr int kMinBox = 8;  // pixels a box after the first must serve

// pixels whose windows centre the candidate boxes, one per warp: (4, 4)
// at the tile's centre, (1, 1), (1, 6), (6, 1), (6, 6) near its corners and
// (1, 4), (4, 1), (7, 4) near its edges ((row, column) in the tile)
__constant__ int kCand[8] = {36, 9, 14, 49, 54, 12, 33, 60};

struct Maps {
  CUtensorMap f1;
  CUtensorMap f2[kMaxLevels];
};

__device__ __forceinline__ void load_slice(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int s, int ox, int oy, int b2) {
  hop::mbar_expect_tx(bar, kBoxSlice);
  hop::tma_load_4d(dst, map, bar, s * 64, ox, oy, b2);
}

// this lane's 16 bytes of cell (yy, xx) of a map (src offset to the lane's
// channels), zeros for a cell outside the map
__device__ __forceinline__ uint4 cell_row(const __nv_bfloat16* src, bool has, int yy, int xx,
                                          int Hp, int Wp, int C) {
  if (!has || yy < 0 || yy >= Hp || xx < 0 || xx >= Wp) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(src + (static_cast<size_t>(yy) * Wp + xx) * C));
}

template <int R>
__device__ __forceinline__ bool in_box(int bx, int by, int ox, int oy) {
  const int dx = bx - ox, dy = by - oy;
  return dx >= 0 && dx <= span<R> && dy >= 0 && dy <= span<R>;
}

// Pick the next box among the pending pixels (mode 0); where it serves at
// least `min_fit` of them, mark those with `tag` and return their number,
// else return 0 (the whole block calls it).
// When the pending windows' corners span <= span<R> cells the box holds
// them all; else the best of eight boxes centred on candidate pixels'
// windows (first on ties).
template <int R>
__device__ int choose_box(const int* bxs, const int* bys, int* mode, int* red, int tag,
                          int min_fit, int& ox, int& oy) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const unsigned all = 0xffffffffu;
  if (t < kPix) {  // warps 0-1: extremes and count of the pending corners
    const bool pend = mode[t] == 0;
    int minx = pend ? bxs[t] : INT_MAX, maxx = pend ? bxs[t] : INT_MIN;
    int miny = pend ? bys[t] : INT_MAX, maxy = pend ? bys[t] : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      minx = min(minx, __shfl_xor_sync(all, minx, o));
      maxx = max(maxx, __shfl_xor_sync(all, maxx, o));
      miny = min(miny, __shfl_xor_sync(all, miny, o));
      maxy = max(maxy, __shfl_xor_sync(all, maxy, o));
    }
    const int n = __popc(__ballot_sync(all, pend));
    if (lane == 0) {
      int* r = red + 5 * warp;
      r[0] = minx, r[1] = maxx, r[2] = miny, r[3] = maxy, r[4] = n;
    }
  }
  {  // every warp: the pending windows inside the box centred on its candidate
    const int c = kCand[warp];
    const int cx = bxs[c] - span<R> / 2, cy = bys[c] - span<R> / 2;
    int n = 0;
    if (mode[c] == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        n += __popc(__ballot_sync(all, mode[p] == 0 && in_box<R>(bxs[p], bys[p], cx, cy)));
      }
    }
    if (lane == 0) {
      int* r = red + 10 + 3 * warp;
      r[0] = n, r[1] = cx, r[2] = cy;
    }
  }
  __syncthreads();
  const int minx = min(red[0], red[5]), maxx = max(red[1], red[6]);
  const int miny = min(red[2], red[7]), maxy = max(red[3], red[8]);
  if (red[4] + red[9] > 0 && maxx - minx <= span<R> && maxy - miny <= span<R>) {
    ox = minx;
    oy = miny;
  } else {
    int best = 0;
    for (int w = 1; w < 8; ++w)
      if (red[10 + 3 * w] > red[10 + 3 * best]) best = w;
    ox = red[11 + 3 * best];
    oy = red[12 + 3 * best];
  }
  const bool fit = t < kPix && mode[t] == 0 && in_box<R>(bxs[t], bys[t], ox, oy);
  const int n = __syncthreads_count(fit);
  if (n < min_fit) return 0;
  if (fit) mode[t] = tag;  // read by others only after the box's next barrier
  return n;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
corr_tile_kernel(const __grid_constant__ Maps maps, const Args args) {
  using bf16 = __nv_bfloat16;
  constexpr int M = Win<R>::M, NT = Win<R>::NT, NN = Win<R>::NN;
  constexpr int kCells = M * M <= 64 ? 64 : M * M;  // per-pixel sums per warp
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* f1_bar = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* full = f1_bar + 1;
  int* bxs = reinterpret_cast<int*>(smem + kInfo);
  int* bys = bxs + kPix;
  float* fxs = reinterpret_cast<float*>(bys + kPix);
  float* fys = fxs + kPix;
  int* mode = reinterpret_cast<int*>(fys + kPix);  // -1 past the image, 0 pending, r: box r
  int* red = mode + kPix;                          // [kRed]
  float* stg = reinterpret_cast<float*>(smem + kWork);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int tiles_x = (args.W + kSide - 1) / kSide, tiles_y = (args.H + kSide - 1) / kSide;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int ty = blockIdx.x / tiles_x % tiles_y, tx = blockIdx.x % tiles_x;
  const int b2 = b / args.group, C = args.C, slices = C / 64, L = args.L;
  const int LN = args.Lout * NN;

  if (t == 0) {
    hop::mbar_init(f1_bar, 1);
    hop::mbar_init(full, 1);
    hop::mbar_init(full + 1, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    hop::mbar_expect_tx(f1_bar, slices * kF1Slice);
    for (int s = 0; s < slices; ++s)
      hop::tma_load_4d(smem + kF1 + s * kF1Slice, &maps.f1, f1_bar, s * 64, tx * kSide,
                       ty * kSide, b);
  }
  bool f1_ready = false;
  uint32_t phases = 0;  // bit s: the parity slot s waits for next

  // this thread's pixel (threads 0-63)
  const int py = ty * kSide + t / kSide, px = tx * kSide + t % kSide;
  const bool mine = t < kPix && py < args.H && px < args.W;
  const long long pix = (static_cast<long long>(b) * args.H + py) * args.W + px;
  float cx = 0.f, cy = 0.f;
  if (mine) {
    cx = args.cen[2 * pix];
    cy = args.cen[2 * pix + 1];
  }
  bf16* out = static_cast<bf16*>(args.out);

  for (int l = 0; l < L; ++l) {
    const Level lv = args.lv[l];
    if (t < kPix) {
      const float inv = ldexpf(1.f, -lv.shift);
      const Window w = window_of(cx * inv, cy * inv, lv.Hp, lv.Wp, R);
      bxs[t] = w.bx;
      bys[t] = w.by;
      fxs[t] = w.fx;
      fys[t] = w.fy;
      mode[t] = mine ? 0 : -1;
    }
    const int n_pix = __syncthreads_count(mine);
    int n_box = 0;  // pixels of this level done on the box path

    for (int round = 0; round < kRounds; ++round) {
      int ox, oy;
      const int n_fit =
          choose_box<R>(bxs, bys, mode, red, round + 1, round == 0 ? 1 : kMinBox, ox, oy);
      if (n_fit == 0) break;
      n_box += n_fit;
      if (t == 0)
        for (int s = 0; s < min(2, slices); ++s)
          load_slice(smem + kWork + s * kBoxSlice, &maps.f2[l], full + s, s, ox, oy, b2);
      if (!f1_ready) {
        hop::mbar_wait(f1_bar, 0);
        f1_ready = true;
      }
      const int wg = t / 128;
      float acc[64];
      for (int s = 0; s < slices; ++s) {
        const int slot = s & 1;
        hop::mbar_wait(full + slot, (phases >> slot) & 1);
        phases ^= 1u << slot;
        const uint32_t a = hop::smem_u32(smem + kF1 + s * kF1Slice);
        const uint32_t bb = hop::smem_u32(smem + kWork + slot * kBoxSlice + wg * (kBoxSlice / 2));
        hop::pin(acc);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::mma_ss_n128(acc, hop::desc_sw128(a + kk * 32), hop::desc_sw128(bb + kk * 32),
                           s > 0 || kk > 0);
        hop::wg_commit();
        hop::wg_wait_all();
        hop::pin(acc);
        __syncthreads();  // both warpgroups are done with the slot
        if (t == 0 && s + 2 < slices)
          load_slice(smem + kWork + slot * kBoxSlice, &maps.f2[l], full + slot, s + 2, ox, oy, b2);
      }
      // stage the scaled products: row = pixel, column = cell (16 * y + x)
      {
        const int r = (warp % 4) * 16 + lane / 4, c0 = wg * 128 + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int row = r + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2);
          *reinterpret_cast<float2*>(stg + row * kStgLd + col) =
              make_float2(acc[i] * args.scale, acc[i + 1] * args.scale);
        }
      }
      __syncthreads();
      for (int i = t; i < kPix * NN; i += kThreads) {
        const int p = i / NN, k = i % NN;
        if (mode[p] != round + 1) continue;
        const float* row = stg + p * kStgLd + (bys[p] - oy) * kBox + (bxs[p] - ox);
        const float v = lerp_tap(k / NT, k % NT, fxs[p], fys[p],
                                 [&](int r, int c) { return row[r * kBox + c]; });
        const long long q = (static_cast<long long>(b) * args.H + ty * kSide + p / kSide) * args.W +
                            tx * kSide + p % kSide;
        out[q * LN + (args.l0 + l) * NN + k] = __float2bfloat16_rn(v);
      }
      hop::fence_proxy_async();  // the staging becomes the next box's TMA ring
      __syncthreads();
    }

    if (n_pix > n_box) {  // the per-pixel path: one warp per pixel
      if (!f1_ready) {
        hop::mbar_wait(f1_bar, 0);
        f1_ready = true;
      }
      const bf16* src = static_cast<const bf16*>(lv.f2) +
                        static_cast<size_t>(b2) * lv.Hp * lv.Wp * C + 8 * lane;
      float* cells = stg + warp * kCells;
      for (int p = warp; p < kPix; p += kThreads / 32) {
        if (mode[p] != 0) continue;  // warp-uniform
        // this lane's 8 channels of f1: slice lane / 8, 16-byte chunk lane % 8
        // of the pixel's 128-byte row, under the 128-byte swizzle
        const bool has = 8 * lane < C;
        float a[8] = {};
        if (has)
          pp::unpack8(*reinterpret_cast<const uint4*>(smem + kF1 + (lane / 8) * kF1Slice +
                                                      p * 128 + (((lane % 8) ^ (p & 7)) * 16)),
                      a);
        const int bx = bxs[p], by = bys[p];
        // one window row of cells in flight while the previous one is summed;
        // the sums go to this warp's M * M floats of the (idle) staging area
        uint4 cur[M], nxt[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            if (j == 0) cur[i] = cell_row(src, has, by, bx + i, lv.Hp, lv.Wp, C);
            if (j + 1 < M) nxt[i] = cell_row(src, has, by + j + 1, bx + i, lv.Hp, lv.Wp, C);
          }
#pragma unroll
          for (int i = 0; i < M; ++i) {
            float v[8];
            pp::unpack8(cur[i], v);
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(a[e], v[e], s);
            s = pp::warp_sum(s);
            if (lane == 0) cells[j * M + i] = s * args.scale;
            cur[i] = nxt[i];
          }
        }
        __syncwarp();
        const long long q = (static_cast<long long>(b) * args.H + ty * kSide + p / kSide) * args.W +
                            tx * kSide + p % kSide;
        for (int k = lane; k < NN; k += 32) {
          const float v = lerp_tap(k / NT, k % NT, fxs[p], fys[p],
                                   [&](int r, int c) { return cells[r * M + c]; });
          out[q * LN + (args.l0 + l) * NN + k] = __float2bfloat16_rn(v);
        }
        __syncwarp();  // the cells are rewritten for the warp's next pixel
      }
    }
    if (args.stats != nullptr && t == 0) {
      atomicAdd(args.stats, 1);
      if (n_pix > n_box) {
        atomicAdd(args.stats + 1, 1);
        atomicAdd(args.stats + 2, n_pix - n_box);
      }
    }
    hop::fence_proxy_async();  // the per-pixel sums sat in the next box's TMA ring
    __syncthreads();           // the pixel table is rewritten for the next level
  }
  if (!f1_ready) hop::mbar_wait(f1_bar, 0);  // no load may outlive the block
}

template <int R>
int launch(const void* f1, const Args& a, cudaStream_t stream) {
  if (a.C % 64 != 0 || a.C > 256) return cudaErrorInvalidValue;
  Maps maps;
  const cuuint64_t C = static_cast<cuuint64_t>(a.C), row = C * 2;
  {
    const cuuint64_t dims[4] = {C, static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[3] = {row, row * a.W, row * a.W * a.H};
    const cuuint32_t box[4] = {64, kSide, kSide, 1};
    if (!hop::encode_sw128(&maps.f1, f1, 4, dims, strides, box)) return cudaErrorInvalidPitchValue;
  }
  for (int l = 0; l < a.L; ++l) {
    const Level& lv = a.lv[l];
    const cuuint64_t dims[4] = {C, static_cast<cuuint64_t>(lv.Wp), static_cast<cuuint64_t>(lv.Hp),
                                static_cast<cuuint64_t>(a.B / a.group)};
    const cuuint64_t strides[3] = {row, row * lv.Wp, row * lv.Wp * lv.Hp};
    const cuuint32_t box[4] = {64, kBox, kBox, 1};
    if (!hop::encode_sw128(&maps.f2[l], lv.f2, 4, dims, strides, box))
      return cudaErrorInvalidPitchValue;
  }
  for (int l = a.L; l < kMaxLevels; ++l) maps.f2[l] = maps.f2[0];
  const cudaError_t e = cudaFuncSetAttribute(corr_tile_kernel<R>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(a.B) * ((a.H + kSide - 1) / kSide) *
                           ((a.W + kSide - 1) / kSide);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  corr_tile_kernel<R><<<static_cast<unsigned>(blocks), kThreads, kBytes, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

// ---- fp32: one warp per (pixel, level) on the CUDA cores -----------------

constexpr int kWarps = 8;  // pixels per block

template <int R>
__global__ void __launch_bounds__(kWarps * 32, 2)
corr_f32_kernel(const float* __restrict__ f1, const Args args, long long pixels) {
  constexpr int V = 4, M = Win<R>::M, NN = Win<R>::NN;
  const int lane = threadIdx.x & 31, l = blockIdx.y;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pix >= pixels) return;
  const Level lv = args.lv[l];
  const int b = static_cast<int>(pix / (static_cast<long long>(args.H) * args.W)), C = args.C;
  const float inv = ldexpf(1.f, -lv.shift);
  const Window w =
      window_of(args.cen[2 * pix] * inv, args.cen[2 * pix + 1] * inv, lv.Hp, lv.Wp, R);

  const float* q = f1 + static_cast<size_t>(pix) * C;
  const float* src = static_cast<const float*>(lv.f2) +
                     static_cast<size_t>(b / args.group) * lv.Hp * lv.Wp * C;
  float part[M * M];
#pragma unroll
  for (int j = 0; j < M * M; ++j) part[j] = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float a[V];
    pp::load16(q + c, a);
#pragma unroll
    for (int j = 0; j < M * M; ++j) {
      const int yy = w.by + j / M, xx = w.bx + j % M;
      if (yy < 0 || yy >= lv.Hp || xx < 0 || xx >= lv.Wp) continue;  // warp-uniform
      float v[V];
      pp::load16(src + (static_cast<size_t>(yy) * lv.Wp + xx) * C + c, v);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) s = fmaf(a[i], v[i], s);
      part[j] += s;
    }
  }
#pragma unroll
  for (int j = 0; j < M * M; ++j) part[j] = pp::warp_sum(part[j]) * args.scale;
  float* o = static_cast<float*>(args.out) + pix * (args.Lout * NN) + (args.l0 + l) * NN;
#pragma unroll
  for (int pass = 0; pass * 32 < NN; ++pass) {
    const float mine = lane_tap<R>(part, w.fx, w.fy, lane, pass);
    if (lane + 32 * pass < NN) o[lane + 32 * pass] = mine;
  }
}

// ---- any radius, either dtype: one warp per (pixel, level) ---------------
//
// The window's cells row by row: lane 0 keeps each row's M sums in this
// warp's two rows of shared memory, and once rows j - 1 and j are there
// the lanes lerp the NT taps of window row j - 1.  Shared memory: 2 M
// floats per warp, whatever the radius.

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_any_kernel(const T* __restrict__ f1, const Args args, long long pixels) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float rows_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, l = blockIdx.y;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pix >= pixels) return;  // warp-uniform; the block never synchronises
  const int R = args.radius, M = 2 * R + 2, NT = 2 * R + 1, C = args.C;
  const Level lv = args.lv[l];
  const int b = static_cast<int>(pix / (static_cast<long long>(args.H) * args.W));
  const float inv = ldexpf(1.f, -lv.shift);
  const Window w =
      window_of(args.cen[2 * pix] * inv, args.cen[2 * pix + 1] * inv, lv.Hp, lv.Wp, R);

  const T* q = f1 + static_cast<size_t>(pix) * C;
  const T* src = static_cast<const T*>(lv.f2) +
                 static_cast<size_t>(b / args.group) * lv.Hp * lv.Wp * C;
  float* rows = rows_smem + warp * 2 * M;
  T* o = static_cast<T*>(args.out) + pix * (static_cast<long long>(args.Lout) * NT * NT) +
         static_cast<long long>(args.l0 + l) * NT * NT;
  for (int j = 0; j < M; ++j) {
    float* cur = rows + (j & 1) * M;
    const int yy = w.by + j;
    for (int i = 0; i < M; ++i) {
      const int xx = w.bx + i;
      float s = 0.f;
      if (yy >= 0 && yy < lv.Hp && xx >= 0 && xx < lv.Wp) {  // warp-uniform
        const T* cell = src + (static_cast<size_t>(yy) * lv.Wp + xx) * C;
        for (int c = lane * V; c < C; c += 32 * V) {
          float a[V], v[V];
          pp::load16(q + c, a);
          pp::load16(cell + c, v);
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(a[e], v[e], s);
        }
        s = pp::warp_sum(s);
      }
      if (lane == 0) cur[i] = s * args.scale;
    }
    __syncwarp();
    if (j > 0) {
      const float* prev = rows + ((j - 1) & 1) * M;
      const int ky = j - 1;
      for (int kx = lane; kx < NT; kx += 32) {
        const float v = lerp_tap(kx, ky, w.fx, w.fy,
                                 [&](int r, int c) { return r == ky ? prev[c] : cur[c]; });
        o[kx * NT + ky] = pp::from_f<T>(v);
      }
    }
    __syncwarp();  // row j - 1 is overwritten by row j + 1
  }
}

template <int R>
int launch_radius(const void* f1, const Args& a, int is_bf16, cudaStream_t s) {
  if (is_bf16) return tile::launch<R>(f1, a, s);
  if (a.C % 4 != 0) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(a.B) * a.H * a.W;
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  corr_f32_kernel<R><<<dim3(static_cast<unsigned>(blocks), a.L), kWarps * 32, 0, s>>>(
      static_cast<const float*>(f1), a, pixels);
  return static_cast<int>(cudaGetLastError());
}

int launch_any(const void* f1, const Args& a, int is_bf16, cudaStream_t s) {
  if ((is_bf16 && a.C % 64 != 0) || (!is_bf16 && a.C % 4 != 0)) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(a.B) * a.H * a.W;
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * 2 * (2 * static_cast<size_t>(a.radius) + 2);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), a.L);
  if (is_bf16)
    corr_any_kernel<__nv_bfloat16><<<grid, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(f1), a, pixels);
  else
    corr_any_kernel<float><<<grid, kWarps * 32, smem, s>>>(static_cast<const float*>(f1), a,
                                                           pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1 (B, H, W, C) contiguous; cen (B, H, W, 2) fp32 level-0 centres (x, y);
// out (B, H, W, Lout * (2r+1)^2), of which this launch writes the channels
// of levels l0 .. l0 + L - 1; levels: L <= 4 x (f2 pointer, Hp, Wp, shift)
// as int64, f2 (B / group, Hp, Wp, C) contiguous, level l's centres
// cen / 2^shift.  bf16 (is_bf16, C a multiple of 64, up to 256 for r in
// 1..4) or fp32 (C a multiple of 4); all pointers 16-byte aligned; any
// lookup radius r >= 0 whose two cell rows per warp fit 48 KB of shared
// memory (r <= 383).  stats: null, or 3 ints the bf16 tile kernel (r in
// 1..4) adds its tile counts to.
extern "C" int pp_corr_window(const void* f1, const void* cen, void* out, const long long* levels,
                              int L, int l0, int Lout, int B, int H, int W, int C, int radius,
                              int group, float scale, int is_bf16, void* stats, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || L <= 0 || L > kMaxLevels || l0 < 0 ||
      l0 + L > Lout || group <= 0 || B % group != 0 || radius < 0)
    return cudaErrorInvalidValue;
  Args a{};
  for (int l = 0; l < L; ++l) {
    a.lv[l].f2 = reinterpret_cast<const void*>(levels[4 * l]);
    a.lv[l].Hp = static_cast<int>(levels[4 * l + 1]);
    a.lv[l].Wp = static_cast<int>(levels[4 * l + 2]);
    a.lv[l].shift = static_cast<int>(levels[4 * l + 3]);
    if (a.lv[l].Hp <= 0 || a.lv[l].Wp <= 0 || a.lv[l].shift < 0 || a.lv[l].shift > 30)
      return cudaErrorInvalidValue;
  }
  a.cen = static_cast<const float*>(cen);
  a.out = out;
  a.stats = static_cast<int*>(stats);
  a.B = B, a.H = H, a.W = W, a.C = C, a.L = L, a.group = group, a.scale = scale;
  a.l0 = l0, a.Lout = Lout, a.radius = radius;
  auto s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch_radius<1>(f1, a, is_bf16, s);
    case 2: return launch_radius<2>(f1, a, is_bf16, s);
    case 3: return launch_radius<3>(f1, a, is_bf16, s);
    case 4: return launch_radius<4>(f1, a, is_bf16, s);
    default: return launch_any(f1, a, is_bf16, s);
  }
}

PP_EXPORT_ERROR_STRING
