// Template-matching scores: (B, S, C) queries x (N, S, C) bank -> (B, N).
//
// Replaces picopose_tpu/ops/pallas/matching.py::match_scores_pallas
// (_score_kernel).  Per (query b, view n): sim = q_b t_n^T (S x S, fp32
// sums of storage-dtype products), rows scaled by the query mask (masked
// rows are zeros, not -inf, and still take part in the column maxima);
// rowmax, colmax; t_valid[i] = sim[i,0] < rowmax[i], s_valid[i] =
// sim[0,i] < colmax[i] (argmax != 0 with first-index ties); score =
// sum_i (qm[i] > 0) t_valid[i] s_valid[i] rowmax[i] / S, or 0 where no
// index passes (the reference's aligned-index quirk).
//
// Bound: operations.  At B = 16, N = 162, S = 256, C = 1024 in bf16 the
// products are 348 GFLOP (~0.35 ms on the bf16 tensor cores) over 93 MB
// of input (~28 us).  The TPU kernel holds the whole 256 x 256 fp32 sim
// block in VMEM; that is 256 KB, more than a Hopper block's 227 KB of
// shared memory.  So one block per (b, n) computes sim in passes of
// 128 x 128 and keeps only per-block vectors: running row maxima, per-warp
// column maxima, sim[:,0] and sim[0,:].  Each of 8 warps owns 16 rows of
// the pass and all 8 of its 16-column tiles.  bf16: the pass is a
// tensor-core (wmma / mma.sync) product over 64-channel tiles of q and t
// staged in shared memory by cp.async, double-buffered so the next tile
// loads while this one multiplies.  fp32: plain FMAs from global memory.
// Blocks of one view n are adjacent in the grid, so the B query blocks
// that read t_n run together and share it in L2.

#include "common.cuh"

#include <cuda_pipeline.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPass = kWarps * 16;  // rows and columns of one pass
constexpr int kFrags = kPass / 16;  // 16-column tiles per warp and pass
constexpr int kScratchLd = 20;      // padded row stride of a warp's 16x16 tile
constexpr int kKTile = 64;          // channels per staged bf16 tile
constexpr int kTileLd = kKTile + 8; // bf16 row stride of a staged tile (144 B)
constexpr int kTileElems = kPass * kTileLd;
constexpr size_t kMaxSmem = 232448;

// Shared memory of one block, in floats: the bf16 staging ring first (two
// stages of A and B tiles), then the per-block vectors.
size_t smem_floats(int S, bool staged) {
  return (staged ? 4 * static_cast<size_t>(kTileElems) / 2 : 0)
         + static_cast<size_t>(kWarps) * 16 * kScratchLd  // tile scratch
         + static_cast<size_t>(kWarps) * S               // per-warp column maxima
         + 4 * static_cast<size_t>(S)                    // rowmax, sim[:,0], sim[0,:], mask
         + 2 * kWarps;                                   // final reduction
}

struct Vectors {
  float *scratch, *colmax_part, *rowmax, *col0, *row0, *mask, *red;
};

__device__ Vectors carve(float* p, int S, int b, const float* qm) {
  Vectors v;
  v.scratch = p;
  v.colmax_part = v.scratch + kWarps * 16 * kScratchLd;
  v.rowmax = v.colmax_part + kWarps * S;
  v.col0 = v.rowmax + S;  // sim[:, 0]
  v.row0 = v.col0 + S;    // sim[0, :]
  v.mask = v.row0 + S;
  v.red = v.mask + S;
  for (int i = threadIdx.x; i < kWarps * S; i += kThreads) v.colmax_part[i] = -CUDART_INF_F;
  for (int i = threadIdx.x; i < S; i += kThreads) v.mask[i] = qm[static_cast<size_t>(b) * S + i];
  __syncthreads();
  return v;
}

// The 16x16 tile of sim at rows r0.., columns cb.. sits in this warp's
// scratch: fold it into the running row maxima (lanes 0-15, one row each),
// this warp's column maxima (lanes 16-31, one column each), sim[:,0], sim[0,:].
__device__ __forceinline__ void fold_tile(const Vectors& v, const float* scratch,
                                          int warp, int lane, int r0, int cb,
                                          float& rmax, int S) {
  if (lane < 16) {
    const int r = r0 + lane;
    const float m = v.mask[r];
    const float* srow = scratch + lane * kScratchLd;
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) rmax = fmaxf(rmax, srow[cc] * m);
    if (cb == 0) v.col0[r] = srow[0] * m;
  } else {
    const int cc = lane - 16, col = cb + cc;
    float cm = -CUDART_INF_F;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) cm = fmaxf(cm, scratch[rr * kScratchLd + cc] * v.mask[r0 + rr]);
    float* cmax = v.colmax_part + warp * S;
    cmax[col] = fmaxf(cmax[col], cm);
    if (r0 == 0) v.row0[col] = scratch[cc] * v.mask[0];
  }
}

__device__ void write_score(const Vectors& v, float* out, int S) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float count = 0.f, total = 0.f;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    float cm = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) cm = fmaxf(cm, v.colmax_part[w * S + i]);
    if (v.mask[i] > 0.f && v.col0[i] < v.rowmax[i] && v.row0[i] < cm) {
      count += 1.f;
      total += v.rowmax[i];
    }
  }
  count = pp::warp_sum(count);
  total = pp::warp_sum(total);
  if (lane == 0) {
    v.red[warp] = count;
    v.red[kWarps + warp] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f, s = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      c += v.red[w];
      s += v.red[kWarps + w];
    }
    *out = c > 0.f ? s / static_cast<float>(S) : 0.f;
  }
}

// Stage channels [k0, k0 + kKTile) of `rows` rows (from `src`, row stride C)
// into a kPass x kTileLd tile; rows or channels past the end become zeros.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows, int C, int k0) {
  for (int i = threadIdx.x; i < kPass * (kKTile / 8); i += kThreads) {
    const int r = i / (kKTile / 8), c = (i % (kKTile / 8)) * 8;
    bf16* d = dst + r * kTileLd + c;
    if (r < rows && k0 + c < C)
      __pipeline_memcpy_async(d, src + static_cast<size_t>(r) * C + k0 + c, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
match_scores_tc_kernel(const bf16* __restrict__ q, const float* __restrict__ qm,
                       const bf16* __restrict__ t, float* __restrict__ out, int B,
                       int N, int S, int C) {
  using namespace nvcuda;
  const int b = blockIdx.x % B, n = blockIdx.x / B;
  const bf16* qb = q + static_cast<size_t>(b) * S * C;
  const bf16* tn = t + static_cast<size_t>(n) * S * C;

  extern __shared__ __align__(128) float smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [stage][A, B][kPass][kTileLd]
  const Vectors v = carve(smem + 2 * kTileElems, S, b, qm);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = v.scratch + warp * 16 * kScratchLd;
  const int nkt = (C + kKTile - 1) / kKTile;
  for (int r0 = 0; r0 < S; r0 += kPass) {
    const int wr0 = r0 + warp * 16;  // this warp's first row
    const bool active = wr0 < S;
    float rmax = -CUDART_INF_F;      // lanes 0-15: running max of row wr0 + lane
    for (int c0 = 0; c0 < S; c0 += kPass) {
      const int ncf = min(kFrags, (S - c0) / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
      for (int f = 0; f < kFrags; ++f) wmma::fill_fragment(acc[f], 0.f);

      stage(ring, qb + static_cast<size_t>(r0) * C, S - r0, C, 0);
      stage(ring + kTileElems, tn + static_cast<size_t>(c0) * C, S - c0, C, 0);
      __pipeline_commit();
      for (int kt = 0; kt < nkt; ++kt) {
        bf16* cur = ring + (kt & 1) * 2 * kTileElems;
        if (kt + 1 < nkt) {
          bf16* nxt = ring + ((kt + 1) & 1) * 2 * kTileElems;
          stage(nxt, qb + static_cast<size_t>(r0) * C, S - r0, C, (kt + 1) * kKTile);
          stage(nxt + kTileElems, tn + static_cast<size_t>(c0) * C, S - c0, C, (kt + 1) * kKTile);
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);  // tile kt has landed
        __syncthreads();
        if (active) {
#pragma unroll
          for (int ks = 0; ks < kKTile; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, cur + warp * 16 * kTileLd + ks, kTileLd);
#pragma unroll
            for (int f = 0; f < kFrags; ++f) {
              if (f < ncf) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
                wmma::load_matrix_sync(bt, cur + kTileElems + f * 16 * kTileLd + ks, kTileLd);
                wmma::mma_sync(acc[f], a, bt, acc[f]);
              }
            }
          }
        }
        __syncthreads();  // every warp is done with `cur` before it is refilled
      }
      if (active) {
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (f < ncf) {
            wmma::store_matrix_sync(scratch, acc[f], kScratchLd, wmma::mem_row_major);
            __syncwarp();
            fold_tile(v, scratch, warp, lane, wr0, c0 + f * 16, rmax, S);
            __syncwarp();
          }
        }
      }
    }
    if (active && lane < 16) v.rowmax[wr0 + lane] = rmax;
  }
  __syncthreads();
  write_score(v, out + static_cast<size_t>(b) * N + n, S);
}

__global__ void __launch_bounds__(kThreads)
match_scores_f32_kernel(const float* __restrict__ q, const float* __restrict__ qm,
                        const float* __restrict__ t, float* __restrict__ out, int B,
                        int N, int S, int C) {
  const int b = blockIdx.x % B, n = blockIdx.x / B;
  const float* qb = q + static_cast<size_t>(b) * S * C;
  const float* tn = t + static_cast<size_t>(n) * S * C;

  extern __shared__ __align__(128) float smem[];
  const Vectors v = carve(smem, S, b, qm);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = v.scratch + warp * 16 * kScratchLd;
  const int r = lane / 2, e0 = (lane % 2) * 8;  // this lane's 8 outputs of a tile
  for (int wr0 = warp * 16; wr0 < S; wr0 += kPass) {
    float rmax = -CUDART_INF_F;
    for (int c0 = 0; c0 < S; c0 += kPass) {
      const int ncf = min(kFrags, (S - c0) / 16);
      float acc[kFrags][8];
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[f][e] = 0.f;
      const float* qrow = qb + static_cast<size_t>(wr0 + r) * C;
      const float* tcol = tn + static_cast<size_t>(c0 + e0) * C;
      for (int k = 0; k < C; ++k) {
        const float a = qrow[k];
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (f < ncf) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[f][e] += a * tcol[static_cast<size_t>(f * 16 + e) * C + k];
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        if (f < ncf) {
#pragma unroll
          for (int e = 0; e < 8; ++e) scratch[r * kScratchLd + e0 + e] = acc[f][e];
          __syncwarp();
          fold_tile(v, scratch, warp, lane, wr0, c0 + f * 16, rmax, S);
          __syncwarp();
        }
      }
    }
    if (lane < 16) v.rowmax[wr0 + lane] = rmax;
  }
  __syncthreads();
  write_score(v, out + static_cast<size_t>(b) * N + n, S);
}

}  // namespace

extern "C" int pp_match_scores(const void* q, const void* qm, const void* t,
                               void* out, int B, int N, int S, int C, int is_bf16,
                               void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || C <= 0 || S % 16 != 0 || C % 16 != 0 ||
      static_cast<long long>(B) * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_floats(S, is_bf16 != 0) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * N);
  const auto* qmf = static_cast<const float*>(qm);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    e = cudaFuncSetAttribute(match_scores_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // all of L1 as shared memory: two blocks (~88 KB each at S = 256) per SM
    e = cudaFuncSetAttribute(match_scores_tc_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    match_scores_tc_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const bf16*>(q), qmf, static_cast<const bf16*>(t), o, B, N, S, C);
  } else {
    e = cudaFuncSetAttribute(match_scores_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    match_scores_f32_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(q), qmf, static_cast<const float*>(t), o, B, N, S, C);
  }
  return static_cast<int>(cudaGetLastError());
}

PP_EXPORT_ERROR_STRING
