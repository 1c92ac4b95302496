// Softmax attention for short sequences: (B, H, N, D) -> (B, H, N, D).
//
// Replaces picopose_tpu/ops/pallas/flash_attention.py::flash_attention
// (_attn_kernel): S = Q K^T in fp32 from storage-dtype operands, the scale
// applied to the fp32 scores, keys >= N masked, fp32 softmax over the whole
// row, P rounded to V's dtype once, P V accumulated in fp32, output in Q's
// dtype.
//
// Bound: bytes.  At (16*16, 257, 64) bf16 the kernel must move 33.7 MB
// (~10 us at 3.35 TB/s) for 4.3 GFLOP (~4.4 us on the bf16 tensor cores).
//
// Three kernels, chosen by shape in pp_attention:
//
// bf16, N <= 272 (the main path, N = 257): Hopper's wgmma, TMA and
// mbarriers.  q, k and v are read in place by strides (the ViT hands views
// of its (B, N, 3, H, D) qkv projection), O is written by strides (the ViT
// passes a (B, N, H, D) buffer, so its head merge is a view).  One
// persistent block per SM walks over (batch, head) pairs; per head, one
// producer warp loads K and V once (two 136-row TMA boxes each, keys past N
// zero-filled) into a double-buffered slot, so the next head's K/V arrive
// while this head computes, and the Q tiles of 64 rows into a ring of two
// slots per consumer.  Two consumer warpgroups take the head's row tiles in
// turn (the 257th row's tile is one tile among five, and the turns run on
// across heads, so neither consumer idles on it); warps whose 16 rows all
// lie past N skip the softmax.  A consumer computes S = Q K^T for its 64
// rows over all 272 keys with SS wgmma (m64n256k16 + m64n16k16 per 16 of
// D: 136 fp32 registers a thread), so Q K^T is computed once and the
// score row never leaves registers.  The row maximum and sum are quad
// shuffles in the accumulator layout; P = exp2(s*c - m*c) * (1/l), with
// c = D^-0.5 * log2(e) folded in and the reciprocal of the row sum taken
// once per row, is rounded to bf16 once the whole row is known (the TPU
// kernel's rounding, hence no online softmax) and packed straight into
// wgmma's register-A fragments: the accumulator layout of a k16 column
// chunk is the A layout.  O += P V is 17 RS wgmmas with V read from shared
// memory as a transposed (MN-major) B operand.  Swizzle: 128 B for D = 64
// (one row), 64 B for D = 32.  setmaxnreg gives the consumers 240
// registers and the producer warpgroup 24.
//
// bf16, 272 < N <= 512: one block of 4 warps per (batch*head, 64 query
// rows) with K, V and the Q tile copied to shared memory by cp.async; each
// warp computes 16 query rows with wmma (mma.sync) products, recomputing
// the chunked Q K^T in two passes (row maximum and sum, then P and P V).
//
// fp32 (any N <= 512): one warp per query row on the CUDA cores (keys
// spread over lanes, P shuffled to the lane owning each output column); V
// is read from device memory where it does not fit beside K (N = 512 at
// D = 64).
//
// The last two take contiguous (BH, N, D) tensors only.

#include "hopper.cuh"

#include <cuda_pipeline.h>
#include <mma.h>

#include <cstdint>

namespace {
namespace hop {

using bf16 = __nv_bfloat16;
constexpr int kMaxKeys = 272;   // a score row held in registers: n256 + n16
constexpr int kRows = 64;       // query rows per tile (wgmma M)
constexpr int kKvBox = 136;     // rows per K/V TMA box; two boxes cover 272
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kQSlots = 2;      // Q tiles in flight per consumer
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kPSteps = kMaxKeys / 16;  // k16 steps of P V

template <int D>
struct Layout {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kGroup = 8 * kRowBytes;      // one 8-row swizzle atom
  static constexpr int kKv = kMaxKeys * kRowBytes;  // K or V of one head
  static constexpr int kQ = kRows * kRowBytes;
  static constexpr int kK0 = 0;                     // K[2]
  static constexpr int kV0 = 2 * kKv;               // V[2]
  static constexpr int kQ0 = 4 * kKv;               // Q[consumer][slot]
  static constexpr int kBar = kQ0 + kConsumers * kQSlots * kQ;
  static constexpr int kNumBars = 4 + 2 * kConsumers * kQSlots;
  static constexpr int kBytes = kBar + kNumBars * 8 + 1024;  // + alignment slack
  static_assert(kKv % 1024 == 0 && kQ % 1024 == 0 && (kKvBox * kRowBytes) % kGroup == 0,
                "tiles must start on swizzle-pattern boundaries");
  static_assert(kPSteps == 17, "P V steps: 16 from the n256 chunk, 1 from the n16 chunk");
};

struct Args {
  bf16* o;
  long long o_sb, o_sh, o_sn;     // output strides in elements (D contiguous)
  int N, H, BH;
  int roles_q, roles_k, roles_v;  // per sorted map dim: 0 = n, 1 = h, 2 = b
  float scale_log2;               // D^-0.5 * log2(e)
};

// coordinate of sorted map dim k (of n, h, b) for this tile
__device__ __forceinline__ int coord(int roles, int k, int row, int h, int b) {
  const int r = (roles >> (2 * k)) & 3;
  return r == 0 ? row : (r == 1 ? h : b);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int roles, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(coord(roles, 0, row, h, b)), "r"(coord(roles, 1, row, h, b)),
      "r"(coord(roles, 2, row, h, b))
      : "memory");
}

// wgmma shared-memory descriptor of a tile whose rows are one swizzle
// width long (128 B for D = 64, 64 B for D = 32), 8-row atoms packed.
// K-major (Q, K): the stride between 8-row groups is SBO, LBO unused.
// MN-major (V as the transposed B of P V): SBO steps 8 keys; the row is
// one atom wide in D, so LBO is unused too and set to the same stride.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, bool mn_major) {
  constexpr uint64_t kSwizzle = D == 64 ? 1 : 2;  // 128 B : 64 B
  constexpr uint64_t kGroup16 = Layout<D>::kGroup >> 4;
  const uint64_t lbo = mn_major ? kGroup16 : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) | (kGroup16 << 32) |
         (kSwizzle << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx: ~2 ulp, denormal results flushed; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of m64nNk16 (per warp 16 rows): element i sits at row
// r + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * qd + (i & 1), with
// r = lane / 4 and qd = lane % 4; the n256 chunk holds keys 0..255, the
// n16 chunk keys 256..271.
template <int D>
__device__ __forceinline__ void consume_tile(const Args& args, uint32_t qs, uint32_t ks,
                                             uint32_t vs, int row0, int b, int h,
                                             uint64_t* q_empty) {
  constexpr int kRowBytes = Layout<D>::kRowBytes;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4, qd = lane % 4;
  float sc[128], st[8];
#pragma unroll
  for (int i = 0; i < 128; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = 0.f;

  pin(sc);
  pin(st);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = desc<D>(qs + kk * 32, false);
    mma_ss_n256(sc, a, desc<D>(ks + kk * 32, false), kk);
    mma_ss_n16(st, a, desc<D>(ks + 256 * kRowBytes + kk * 32, false), kk);
  }
  wg_commit();
  wg_wait_all();
  pin(sc);
  pin(st);
  __syncwarp();
  if (lane == 0) mbar_arrive(q_empty);  // this warp is done with the Q tile

  const int N = args.N;
  uint32_t pa[kPSteps][4];
  if (row0 < N) {  // warp-uniform: past N the rows are zero-filled and unused
    // keys >= N to -inf: the n16 chunk always, the n256 chunk when N < 256
    if (N < 256) {
#pragma unroll
      for (int i = 0; i < 128; ++i)
        if (8 * (i >> 2) + 2 * qd + (i & 1) >= N) sc[i] = -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (256 + 8 * (i >> 2) + 2 * qd + (i & 1) >= N) st[i] = -CUDART_INF_F;
    // four partial maxima and sums per row (by column group j % 4), so the
    // reductions are four short dependency chains instead of one long one
    float m0[4], m1[4], l0[4], l1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m0[j] = m1[j] = -CUDART_INF_F, l0[j] = l1[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      if (i & 2) m1[(i >> 2) & 3] = fmaxf(m1[(i >> 2) & 3], sc[i]);
      else m0[(i >> 2) & 3] = fmaxf(m0[(i >> 2) & 3], sc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & 2) m1[i >> 2] = fmaxf(m1[i >> 2], st[i]);
      else m0[i >> 2] = fmaxf(m0[i >> 2], st[i]);
    }
    float r0 = fmaxf(fmaxf(m0[0], m0[1]), fmaxf(m0[2], m0[3]));
    float r1 = fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3]));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, o));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, o));
    }
    const float c2 = args.scale_log2, mc0 = -r0 * c2, mc1 = -r1 * c2;
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const float p = exp2_approx(fmaf(sc[i], c2, (i & 2) ? mc1 : mc0));
      sc[i] = p;
      if (i & 2) l1[(i >> 2) & 3] += p; else l0[(i >> 2) & 3] += p;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = exp2_approx(fmaf(st[i], c2, (i & 2) ? mc1 : mc0));
      st[i] = p;
      if (i & 2) l1[i >> 2] += p; else l0[i >> 2] += p;
    }
    float s0 = (l0[0] + l0[1]) + (l0[2] + l0[3]), s1 = (l1[0] + l1[1]) + (l1[2] + l1[3]);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const float i0 = 1.f / s0, i1 = 1.f / s1;
    // k16 step u of P V: columns 16u..16u+15 are accumulator elements
    // 8u..8u+7, already in register-A order
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float* e = sc + 8 * u;
      pa[u][0] = pack_bf16(e[0] * i0, e[1] * i0);
      pa[u][1] = pack_bf16(e[2] * i1, e[3] * i1);
      pa[u][2] = pack_bf16(e[4] * i0, e[5] * i0);
      pa[u][3] = pack_bf16(e[6] * i1, e[7] * i1);
    }
    pa[16][0] = pack_bf16(st[0] * i0, st[1] * i0);
    pa[16][1] = pack_bf16(st[2] * i1, st[3] * i1);
    pa[16][2] = pack_bf16(st[4] * i0, st[5] * i0);
    pa[16][3] = pack_bf16(st[6] * i1, st[7] * i1);
  } else {
#pragma unroll
    for (int u = 0; u < kPSteps; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[u][j] = 0u;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  pin(o);
  pin(pa);
  wg_fence();
#pragma unroll
  for (int u = 0; u < kPSteps; ++u)
    mma_rs(o, pa[u], desc<D>(vs + u * 16 * kRowBytes, true), u);
  wg_commit();
  wg_wait_all();
  pin(o);

  const int n0 = row0 + r, n1 = n0 + 8;
  bf16* ob = args.o + b * args.o_sb + h * args.o_sh + 2 * qd;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (n0 < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + n0 * args.o_sn + 8 * j) =
          __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
    if (n1 < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + n1 * args.o_sn + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Args args) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bars;                        // [slot]
  uint64_t* kv_empty = bars + 2;                   // [slot]
  uint64_t* q_full = bars + 4;                     // [consumer * kQSlots + slot]
  uint64_t* q_empty = q_full + kConsumers * kQSlots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, kConsumers * 4);  // every consumer warp
    }
    for (int i = 0; i < kConsumers * kQSlots; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 4);  // the owning consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile g = it * tiles + t (t-th row tile of this block's it-th head)
  // belongs to consumer g % 2, as its (g / 2)-th tile.
  const int tiles = (args.N + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int bh = blockIdx.x; bh < args.BH; bh += gridDim.x, ++it) {
        const int b = bh / args.H, h = bh % args.H, s = it & 1;
        mbar_wait(kv_empty + s, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full + s, 2 * L::kKv);
        for (int box = 0; box < kMaxKeys / kKvBox; ++box) {
          const int off = box * kKvBox * L::kRowBytes;
          tma_load(smem + L::kK0 + s * L::kKv + off, &kmap, kv_full + s, args.roles_k,
                   box * kKvBox, h, b);
          tma_load(smem + L::kV0 + s * L::kKv + off, &vmap, kv_full + s, args.roles_v,
                   box * kKvBox, h, b);
        }
        for (int t = 0; t < tiles; ++t) {
          const int g = it * tiles + t, lt = g / kConsumers;
          const int i = (g % kConsumers) * kQSlots + lt % kQSlots;
          mbar_wait(q_empty + i, ((lt / kQSlots) & 1) ^ 1);
          mbar_expect_tx(q_full + i, L::kQ);
          tma_load(smem + L::kQ0 + i * L::kQ, &qmap, q_full + i, args.roles_q, t * kRows, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int it = 0;
    for (int bh = blockIdx.x; bh < args.BH; bh += gridDim.x, ++it) {
      const int b = bh / args.H, h = bh % args.H, s = it & 1;
      mbar_wait(kv_full + s, (it >> 1) & 1);
      const uint32_t ks = smem_u32(smem + L::kK0 + s * L::kKv);
      const uint32_t vs = smem_u32(smem + L::kV0 + s * L::kKv);
      for (int t = 0; t < tiles; ++t) {
        const int g = it * tiles + t, lt = g / kConsumers;
        if (g % kConsumers != c) continue;
        const int i = c * kQSlots + lt % kQSlots;
        mbar_wait(q_full + i, (lt / kQSlots) & 1);
        consume_tile<D>(args, smem_u32(smem + L::kQ0 + i * L::kQ), ks, vs,
                        t * kRows + warp * 16, b, h, q_empty + i);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + s);  // this warp is done with K, V
    }
  }
}

// A 4-D tensor map over the (B, H, N, D) view at ptr (strides in elements,
// D contiguous), its three outer dims sorted by stride; a box is box_rows
// rows of one (b, h).  Returns the roles word for coord(), or -1.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int H, int N, long long sb,
           long long sh, long long sn, int box_rows) {
  const long long size[3] = {N, H, B}, stride[3] = {sn, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int roles = 0;
  for (int k = 0; k < 3; ++k) {
    dims[k + 1] = static_cast<cuuint64_t>(size[order[k]]);
    strides[k] = static_cast<cuuint64_t>(stride[order[k]]) * sizeof(bf16);
    if (order[k] == 0) box[k + 1] = static_cast<cuuint32_t>(box_rows);
    roles |= order[k] << (2 * k);
  }
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? roles : -1;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           const long long* st, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  Args a{};
  a.roles_q = encode<D>(&qm, q, B, H, N, st[0], st[1], st[2], kRows);
  a.roles_k = encode<D>(&km, k, B, H, N, st[3], st[4], st[5], kKvBox);
  a.roles_v = encode<D>(&vm, v, B, H, N, st[6], st[7], st[8], kKvBox);
  if (a.roles_q < 0 || a.roles_k < 0 || a.roles_v < 0) return cudaErrorInvalidPitchValue;
  a.o = static_cast<bf16*>(o);
  a.o_sb = st[9];
  a.o_sh = st[10];
  a.o_sn = st[11];
  a.N = N;
  a.H = H;
  a.BH = B * H;
  a.scale_log2 = scale * 1.4426950408889634f;
  constexpr int smem = Layout<D>::kBytes;
  // per device, once: the shared-memory opt-in and the SM count
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaFuncSetAttribute(attention_hopper_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    sms_of[dev] = sms;
  }
  const int grid = a.BH < sms_of[dev] ? a.BH : sms_of[dev];
  attention_hopper_kernel<D><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

constexpr int kMaxKeys = 512;
constexpr size_t kMaxSmem = 232448;  // what one Hopper block may opt in to

// ---- bf16, 272 < N <= 512: wmma tensor cores, two passes ------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcRows = kTcWarps * 16;  // query rows per block
constexpr int kChunk = 64;              // keys per pass step (4 fragments)

template <int D>
struct TcLayout {
  static constexpr int kv_ld = D + 8;       // bf16 row stride of K, V, Q
  static constexpr int s_ld = kChunk + 4;   // fp32 scores of a chunk; later O
  static constexpr int p_ld = kChunk + 8;   // bf16 P of a chunk
  static constexpr int warp_bytes = 16 * s_ld * 4 + 16 * p_ld * 2;
  static size_t smem(int npad) {
    return static_cast<size_t>(2 * npad + kTcRows) * kv_ld * sizeof(bf16) +
           static_cast<size_t>(kTcWarps) * warp_bytes;
  }
};

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                    int npad, float scale) {
  using namespace nvcuda;
  using L = TcLayout<D>;
  constexpr int kVecs = D / 8;  // 16-byte pieces per row
  constexpr int kDF = D / 16;   // fragments along D

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + npad * L::kv_ld;
  bf16* qs = vs + npad * L::kv_ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(qs + kTcRows * L::kv_ld) +
                                       warp * L::warp_bytes);
  bf16* pw = reinterpret_cast<bf16*>(sw + 16 * L::s_ld);

  const size_t base = static_cast<size_t>(blockIdx.y) * N * D;
  const int row0 = blockIdx.x * kTcRows;
  // every copy is issued before any is waited for (cp.async)
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < npad * kVecs; i += blockDim.x) {
    const int j = i / kVecs, c = (i % kVecs) * 8;
    bf16* kd = ks + j * L::kv_ld + c;
    bf16* vd = vs + j * L::kv_ld + c;
    if (j < N) {
      __pipeline_memcpy_async(kd, k + base + static_cast<size_t>(j) * D + c, 16);
      __pipeline_memcpy_async(vd, v + base + static_cast<size_t>(j) * D + c, 16);
    } else {
      *reinterpret_cast<uint4*>(kd) = zero;
      *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  for (int i = threadIdx.x; i < kTcRows * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8, row = row0 + r;
    bf16* qd = qs + r * L::kv_ld + c;
    if (row < N)
      __pipeline_memcpy_async(qd, q + base + static_cast<size_t>(row) * D + c, 16);
    else
      *reinterpret_cast<uint4*>(qd) = zero;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (row0 + warp * 16 >= N) return;  // no block-wide barrier follows

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kDF];
#pragma unroll
  for (int d = 0; d < kDF; ++d)
    wmma::load_matrix_sync(qa[d], qs + warp * 16 * L::kv_ld + d * 16, L::kv_ld);

  // S[:, 16*f0 : 16*(f0+nfc)] of this warp's 16 rows (unscaled) into sw;
  // the nfc <= 4 tiles are independent accumulation chains
  auto scores = [&](int f0, int nfc) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[kChunk / 16];
#pragma unroll
    for (int f = 0; f < kChunk / 16; ++f) wmma::fill_fragment(s[f], 0.f);
#pragma unroll
    for (int d = 0; d < kDF; ++d) {
#pragma unroll
      for (int f = 0; f < kChunk / 16; ++f) {
        if (f < nfc) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, ks + (f0 + f) * 16 * L::kv_ld + d * 16, L::kv_ld);
          wmma::mma_sync(s[f], qa[d], kb, s[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kChunk / 16; ++f)
      if (f < nfc) wmma::store_matrix_sync(sw + f * 16, s[f], L::s_ld, wmma::mem_row_major);
    __syncwarp();
  };

  const int nf = npad / 16;
  const int r = lane / 2, half = lane % 2;  // this lane: row r, every other column
  // pass 1: the exact row maximum m and the row sum l of exp(s - m), the
  // sum rescaled whenever m grows (every chunk holds a key < N)
  float m = -CUDART_INF_F, l = 0.f;
  for (int f0 = 0; f0 < nf; f0 += 4) {
    const int nfc = min(4, nf - f0);
    scores(f0, nfc);
    const int cols = min(nfc * 16, N - f0 * 16);  // valid keys of the chunk
    float x[kChunk / 2];  // this lane's scaled scores of the chunk
    float cm = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int c = 2 * i + half;
      x[i] = c < cols ? sw[r * L::s_ld + c] * scale : -CUDART_INF_F;
      cm = fmaxf(cm, x[i]);
    }
    const float m_new = fmaxf(m, fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1)));
    float add = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) add += expf(x[i] - m_new);  // exp(-inf) = 0
    l = l * expf(m - m_new) + add;
    m = m_new;
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kDF];
#pragma unroll
  for (int n = 0; n < kDF; ++n) wmma::fill_fragment(oacc[n], 0.f);
  for (int f0 = 0; f0 < nf; f0 += 4) {  // pass 2: P (bf16) and O += P V
    const int nfc = min(4, nf - f0);
    scores(f0, nfc);
    const int cols = min(nfc * 16, N - f0 * 16);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int c = 2 * i + half;
      const float p = c < cols ? expf(sw[r * L::s_ld + c] * scale - m) / l : 0.f;
      pw[r * L::p_ld + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
    for (int kk = 0; kk < nfc; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, pw + kk * 16, L::p_ld);
#pragma unroll
      for (int n = 0; n < kDF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + (f0 + kk) * 16 * L::kv_ld + n * 16, L::kv_ld);
        wmma::mma_sync(oacc[n], pa, vb, oacc[n]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < kDF; ++n)
    wmma::store_matrix_sync(sw + n * 16, oacc[n], L::s_ld, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D, c = i % D, row = row0 + warp * 16 + rr;
    if (row < N) o[base + static_cast<size_t>(row) * D + c] = __float2bfloat16_rn(sw[rr * L::s_ld + c]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int N,
              float scale, cudaStream_t stream) {
  const int npad = (N + 15) / 16 * 16;
  const size_t smem = TcLayout<D>::smem(npad);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // all of L1 as shared memory: two blocks of ~114 KB fit on one SM
  e = cudaFuncSetAttribute(attention_tc_kernel<D>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTcRows - 1) / kTcRows, BH);
  attention_tc_kernel<D><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), N, npad, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: CUDA cores ----------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr int kSlots = kMaxKeys / 32;

// row stride of K in shared memory: D plus one 32-bit word of padding, so
// 32 lanes reading 32 different key rows hit 32 different banks
template <int D>
__host__ __device__ constexpr int key_stride() { return D + 1; }

// K, the warps' query rows and (v_shared) V; without V it is read from
// device memory (through L1) where the block's 227 KB cannot hold it, as
// at N = 512, D = 64
template <int D>
size_t smem_bytes(int N, bool v_shared) {
  return static_cast<size_t>(N) * (key_stride<D>() + (v_shared ? D : 0)) * sizeof(float) +
         kWarps * D * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N,
                     float scale, bool v_shared) {
  constexpr int KS = key_stride<D>();
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* qs = ks + N * KS + (v_shared ? N * D : 0);

  const size_t base = static_cast<size_t>(blockIdx.y) * N * D;
  const float* vs = v_shared ? ks + N * KS : v + base;
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    ks[(i / D) * KS + (i % D)] = k[base + i];
    if (v_shared) ks[N * KS + i] = v[base + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qs + warp * D;
  const int row_end = min(N, static_cast<int>(blockIdx.x + 1) * kRowsPerBlock);
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    for (int d = lane; d < D; d += 32) qw[d] = q[base + static_cast<size_t>(row) * D + d];
    __syncwarp();

    float sc[kSlots];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      sc[s] = -CUDART_INF_F;
      if (j < N) {
        const float* kr = ks + j * KS;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc += qw[d] * kr[d];
        sc[s] = acc * scale;
        m = fmaxf(m, sc[s]);
      }
    }
    m = pp::warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      sc[s] = (s * 32 + lane < N) ? expf(sc[s] - m) : 0.f;
      sum += sc[s];
    }
    sum = pp::warp_sum(sum);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) sc[s] /= sum;

    float acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s * 32 < N) {
        const int jn = min(32, N - s * 32);
        for (int src = 0; src < jn; ++src) {
          const float p = __shfl_sync(0xffffffffu, sc[s], src);
          const float* vr = vs + (s * 32 + src) * D + lane * DPL;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[e] += p * vr[e];
        }
      }
    }
    float* orow = o + base + static_cast<size_t>(row) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) orow[e] = acc[e];
    __syncwarp();  // qw is rewritten for the next row
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int N,
               float scale, cudaStream_t stream) {
  const bool v_shared = smem_bytes<D>(N, true) <= kMaxSmem;
  const size_t smem = smem_bytes<D>(N, v_shared);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  attention_f32_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, scale, v_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, H, N, D) with strides st[0..2], st[3..5], st[6..8] (b, h, n;
// elements, D contiguous); o: strides st[9..11].  bf16 with N <= 272 takes
// any such 16-byte-aligned strides (the Hopper kernel); the other kernels
// take contiguous (B, H, N, D) tensors only.
extern "C" int pp_attention(const void* q, const void* k, const void* v, void* o, int B,
                            int H, int N, int D, const long long* st, float scale,
                            int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || N > kMaxKeys) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && N <= hop::kMaxKeys) {
    if (D == 64) return hop::launch<64>(q, k, v, o, B, H, N, st, scale, s);
    if (D == 32) return hop::launch<32>(q, k, v, o, B, H, N, st, scale, s);
    return cudaErrorInvalidValue;
  }
  const long long BH = static_cast<long long>(B) * H;
  if (BH > 65535) return cudaErrorInvalidValue;
  for (int t = 0; t < 4; ++t)  // contiguous (B, H, N, D)
    if (st[3 * t] != static_cast<long long>(H) * N * D || st[3 * t + 1] != static_cast<long long>(N) * D ||
        st[3 * t + 2] != D)
      return cudaErrorInvalidValue;
  const int bh = static_cast<int>(BH);
  if (is_bf16) {
    if (D == 64) return launch_tc<64>(q, k, v, o, bh, N, scale, s);
    if (D == 32) return launch_tc<32>(q, k, v, o, bh, N, scale, s);
  } else {
    if (D == 64) return launch_f32<64>(q, k, v, o, bh, N, scale, s);
    if (D == 32) return launch_f32<32>(q, k, v, o, bh, N, scale, s);
  }
  return cudaErrorInvalidValue;
}

PP_EXPORT_ERROR_STRING
