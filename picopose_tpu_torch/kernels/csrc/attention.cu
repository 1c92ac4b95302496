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
// fp32 (any N <= 512): full fp32 on the CUDA cores (no TF32, as the fp32
// contract asks), so bound by operations at the FFMA rate: at the accuracy
// loop's ViT-S (32, 6, 257, 64) 3.25 GFLOP, ~48.5 us at 67 TFLOP/s, over
// 50.5 MB (~15 us).  A register-tiled FFMA kernel with an online softmax:
// a block of 4 warps takes 64 query rows of one (batch, head) (warps
// whose 16 rows all lie past N only stage, so the 257th row costs one
// warp) and walks K and V in tiles of 32 keys, double-buffered by 16-byte
// cp.async copies read in place by strides (the ViT's qkv views; O is
// written by strides into its (B, N, H, D) buffer).  Each thread holds a
// 4-row x 4-key tile of scores (8 FMAs per float4 read from shared
// memory, K rows padded so a quarter-warp's reads hit 8 bank groups), the
// running maximum and sum of its 4 rows and a 4 x D/8 tile of O; P goes
// through shared memory (the warp's own rows: __syncwarp) into a
// register-tiled P V.  The tail key tile pays only for the 8-key slots
// below N (one slot for the 257th key).  A last row tile that fits one
// warp (the 257th row's) splits the keys over its four warps instead and
// combines their softmax states in a fixed order; the grid runs the row
// tiles slowest, so those short blocks run together after the full
// ones.  ~60 KB of shared memory (D = 64): three blocks per SM.
//
// The bf16 two-pass kernel takes contiguous (BH, N, D) tensors only.

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

// ---- fp32: register-tiled FFMA, online softmax ---------------------------

namespace ff {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 32;           // keys per staged K / V tile
constexpr int kSlots = kKeys / 8;   // keys per lane and tile
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;         // Q and K row stride in floats (bank groups)
  static constexpr int kPLd = kKeys + 4;    // P row stride
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLd;      // K[2]
  static constexpr int kV = kK + 2 * kKeys * kLd;  // V[2], rows of D
  static constexpr int kP = kV + 2 * kKeys * D;
  static constexpr int kBytes = (kP + kRows * kPLd) * static_cast<int>(sizeof(float));
};

struct Args {
  float* o;
  long long sq[3], sk[3], sv[3], so[3];  // (b, h, n) strides in elements, D contiguous
  int N, H;
  float scale_log2;  // D^-0.5 * log2(e)
};

// ROWS rows of K, V or Q from row0 on, as 16-byte copies by NT threads
// (thread t of them); rows past N zero-filled
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long sn, int row0,
                                           int N, int t) {
  constexpr int kQuads = D / 4, kCopies = ROWS * kQuads;
#pragma unroll
  for (int it = 0; it < (kCopies + NT - 1) / NT; ++it) {
    const int c = it * NT + t, r = c / kQuads, part = c % kQuads;
    if (kCopies % NT != 0 && c >= kCopies) break;
    const bool ok = row0 + r < N;
    pp::cp_async16(dst + r * LD + part * 4, src + (ok ? row0 + r : 0) * sn + part * 4, ok);
  }
}

// Scores of this thread's 4 rows x its first NJ key slots (keys kg + 8 j
// of the tile); NJ is the least count that holds every key below N, so
// the tail tile (the 257th key) pays for one slot
template <int D, int NJ>
__device__ __forceinline__ void scores(int nj, float (&s)[4][kSlots], const float* qw,
                                       const float* kt, int kg) {
  if constexpr (NJ > 1) {
    if (nj < NJ) return scores<D, NJ - 1>(nj, s, qw, kt, kg);
  }
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kSlots; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qw + 4 * i * L::kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(kt + (kg + 8 * j) * L::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(a[i].x, k.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, k.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, k.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, k.w, s[i][j]);
      }
    }
  }
}

// This thread's running state: rows rg + 4 i of its warp's 16, the
// running maximum m (base 2), its lanes' share of the sum l and its
// output columns 32 h + 4 kg.. of O
template <int D>
struct State {
  float o[4][D / 8], m[4], l[4];
  __device__ __forceinline__ State() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < D / 8; ++e) o[i][e] = 0.f;
    }
  }
};

// One key tile of nk keys below N (K rows kt, V rows vt in shared memory):
// scores, the online softmax in base 2 (x = s D^-0.5 log2(e), keys past
// N at -inf), P through the warp's own rows pw, O += P V four keys at a
// time (P is 0 and V's zero-filled rows are finite past N)
template <int D>
__device__ __forceinline__ void step(State<D>& st, const float* qw, const float* kt,
                                     const float* vt, float* pw, int nk, int kg,
                                     float scale_log2) {
  using L = Layout<D>;
  constexpr int kH = D / 32;  // float4 output columns per lane
  float s[4][kSlots];
  scores<D, kSlots>((nk + 7) / 8, s, qw, kt, kg);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      s[i][j] = kg + 8 * j < nk ? s[i][j] * scale_log2 : -CUDART_INF_F;
      mt = fmaxf(mt, s[i][j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
    const float mn = fmaxf(st.m[i], mt);  // finite: every tile holds a key below N
    const float alpha = exp2f(st.m[i] - mn);
    st.m[i] = mn;
    st.l[i] *= alpha;
#pragma unroll
    for (int e = 0; e < 4 * kH; ++e) st.o[i][e] *= alpha;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const float pj = exp2f(s[i][j] - mn);
      st.l[i] += pj;
      pw[4 * i * L::kPLd + kg + 8 * j] = pj;
    }
  }
  __syncwarp();  // the warp's P rows are written
  const int nc = (nk + 3) & ~3;
  for (int c = 0; c < nc; c += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(pw + 4 * i * L::kPLd + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int hh = 0; hh < kH; ++hh) {
        const float4 w = *reinterpret_cast<const float4*>(vt + (c + cc) * D + 32 * hh + 4 * kg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
          st.o[i][4 * hh + 0] = fmaf(p, w.x, st.o[i][4 * hh + 0]);
          st.o[i][4 * hh + 1] = fmaf(p, w.y, st.o[i][4 * hh + 1]);
          st.o[i][4 * hh + 2] = fmaf(p, w.z, st.o[i][4 * hh + 2]);
          st.o[i][4 * hh + 3] = fmaf(p, w.w, st.o[i][4 * hh + 3]);
        }
      }
    }
  }
  __syncwarp();  // P is rewritten by the next tile
}

__device__ __forceinline__ float row_group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// A block takes 64 query rows of one (b, h) and walks K and V in tiles of
// 32 keys, double-buffered by cp.async.  Warp w owns rows 16 w.. ; lane
// (rg = lane / 8, kg = lane % 8) owns rows 16 w + rg + 4 i (i < 4), keys
// kg + 8 j of a tile (j < kSlots) and output columns 32 h + 4 kg.. (h < D / 32).
// A block whose rows past row0 fit one warp (the 257th row's) splits the
// keys instead: warp w walks the 16-key tiles w, w + 4, .. of the same 16
// rows, each staging its own tiles, and the four partial softmax states
// are combined in shared memory in a fixed order; so that block costs a
// quarter of a warp's walk, not a whole block's.
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const Args a) {
  using L = Layout<D>;
  constexpr int kH = D / 32;  // float4 output columns per lane
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::kQ;
  float* ks = sm + L::kK;
  float* vs = sm + L::kV;
  float* ps = sm + L::kP;
  // (b, h) fastest, row tiles slow: the full tiles run in even waves and
  // the short last tiles (the 257th row's) run together at the end
  const int N = a.N, b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int row0 = blockIdx.y * kRows;
  const float* qb = q + b * a.sq[0] + h * a.sq[1];
  const float* kb = k + b * a.sk[0] + h * a.sk[1];
  const float* vb = v + b * a.sv[0] + h * a.sv[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = lane / 8, kg = lane % 8;
  float* pw = ps + (warp * 16 + rg) * L::kPLd;
  State<D> st;
  float* orow0 = a.o + b * a.so[0] + h * a.so[1];

  if (N - row0 <= 16) {  // block-uniform: one row unit, the keys split over the warps
    static_assert(kWarps * 16 * (L::kLd + D) <= L::kP - L::kK, "per-warp 16-key tiles fit K[2], V[2]");
    stage_rows<D, 16, L::kLd, kThreads>(qs, qb, a.sq[2], row0, N, threadIdx.x);
    pp::cp_async_commit();
    pp::cp_async_wait<0>();
    __syncthreads();
    float* kw = ks + warp * 16 * (L::kLd + D);  // this warp's K tile, then its V tile
    float* vw = kw + 16 * L::kLd;
    for (int t = warp; t * 16 < N; t += kWarps) {
      stage_rows<D, 16, L::kLd, 32>(kw, kb, a.sk[2], t * 16, N, lane);
      stage_rows<D, 16, D, 32>(vw, vb, a.sv[2], t * 16, N, lane);
      pp::cp_async_commit();
      pp::cp_async_wait<0>();
      __syncwarp();
      step<D>(st, qs + rg * L::kLd, kw, vw, pw, min(16, N - t * 16), kg, a.scale_log2);
    }
    __syncthreads();  // every warp is done with its tiles: the region holds the states
    float* cm = ks;                      // [warp][row] maxima
    float* cl = cm + kWarps * 16;        // [warp][row] sums
    float* co = cl + kWarps * 16;        // [warp][row][D]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + rg + 4 * i;
      const float li = row_group_sum(st.l[i]);
      if (kg == 0) {
        cm[r] = st.m[i];
        cl[r] = li;
      }
#pragma unroll
      for (int hh = 0; hh < kH; ++hh)
        *reinterpret_cast<float4*>(co + r * D + 32 * hh + 4 * kg) =
            make_float4(st.o[i][4 * hh], st.o[i][4 * hh + 1], st.o[i][4 * hh + 2], st.o[i][4 * hh + 3]);
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 4 * i;
      if (row0 + r >= N) continue;
      float mx = cm[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, cm[w * 16 + r]);
      float sum = 0.f, out[4 * kH];
#pragma unroll
      for (int e = 0; e < 4 * kH; ++e) out[e] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // a warp without a tile has m = -inf: weight 0
        const float sc = exp2f(cm[w * 16 + r] - mx);
        sum += cl[w * 16 + r] * sc;
#pragma unroll
        for (int hh = 0; hh < kH; ++hh) {
          const float4 x = *reinterpret_cast<const float4*>(co + (w * 16 + r) * D + 32 * hh + 4 * kg);
          out[4 * hh] += x.x * sc;
          out[4 * hh + 1] += x.y * sc;
          out[4 * hh + 2] += x.z * sc;
          out[4 * hh + 3] += x.w * sc;
        }
      }
      const float inv = 1.f / sum;
      float* orow = orow0 + (row0 + r) * a.so[2];
#pragma unroll
      for (int hh = 0; hh < kH; ++hh)
        *reinterpret_cast<float4*>(orow + 32 * hh + 4 * kg) =
            make_float4(out[4 * hh] * inv, out[4 * hh + 1] * inv, out[4 * hh + 2] * inv,
                        out[4 * hh + 3] * inv);
    }
    return;
  }

  stage_rows<D, kRows, L::kLd, kThreads>(qs, qb, a.sq[2], row0, N, threadIdx.x);
  stage_rows<D, kKeys, L::kLd, kThreads>(ks, kb, a.sk[2], 0, N, threadIdx.x);
  stage_rows<D, kKeys, D, kThreads>(vs, vb, a.sv[2], 0, N, threadIdx.x);
  pp::cp_async_commit();

  const bool active = row0 + warp * 16 < N;  // a warp whose rows all lie past N only stages
  const float* qw = qs + (warp * 16 + rg) * L::kLd;
  const int tiles = (N + kKeys - 1) / kKeys;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {  // the other buffer: every thread finished tile t - 1 (barrier below)
      const int nb = (t + 1) & 1;
      stage_rows<D, kKeys, L::kLd, kThreads>(ks + nb * kKeys * L::kLd, kb, a.sk[2], (t + 1) * kKeys,
                                             N, threadIdx.x);
      stage_rows<D, kKeys, D, kThreads>(vs + nb * kKeys * D, vb, a.sv[2], (t + 1) * kKeys, N,
                                        threadIdx.x);
    }
    pp::cp_async_commit();
    pp::cp_async_wait<1>();
    __syncthreads();
    if (active)
      step<D>(st, qw, ks + (t & 1) * kKeys * L::kLd, vs + (t & 1) * kKeys * D, pw,
              min(kKeys, N - t * kKeys), kg, a.scale_log2);
    __syncthreads();  // this buffer is refilled by tile t + 2's copies
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / row_group_sum(st.l[i]);
    const int row = row0 + warp * 16 + rg + 4 * i;
    if (row >= N) continue;
    float* orow = orow0 + row * a.so[2];
#pragma unroll
    for (int hh = 0; hh < kH; ++hh)
      *reinterpret_cast<float4*>(orow + 32 * hh + 4 * kg) =
          make_float4(st.o[i][4 * hh] * inv, st.o[i][4 * hh + 1] * inv, st.o[i][4 * hh + 2] * inv,
                      st.o[i][4 * hh + 3] * inv);
  }
}

// every stride a multiple of 4 floats and every start on 16 bytes: the
// 16-byte copies and float4 stores
inline bool on_grid(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % 4 || st[i] <= 0) return false;
  return true;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           const long long* st, float scale, cudaStream_t stream) {
  if (!on_grid(q, st) || !on_grid(k, st + 3) || !on_grid(v, st + 6) || !on_grid(o, st + 9))
    return cudaErrorInvalidValue;
  Args a{};
  a.o = static_cast<float*>(o);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i];
    a.sk[i] = st[3 + i];
    a.sv[i] = st[6 + i];
    a.so[i] = st[9 + i];
  }
  a.N = N;
  a.H = H;
  a.scale_log2 = scale * 1.4426950408889634f;
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(attention_ffma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (N + kRows - 1) / kRows);
  attention_ffma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ff

}  // namespace

// q, k, v: (B, H, N, D) with strides st[0..2], st[3..5], st[6..8] (b, h, n;
// elements, D contiguous); o: strides st[9..11].  bf16 with N <= 272 takes
// any such 16-byte-aligned strides (the Hopper kernel), and so does fp32
// (the FFMA kernel); bf16 with N > 272 takes contiguous (B, H, N, D)
// tensors only.
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
  if (!is_bf16) {
    if (D == 64) return ff::launch<64>(q, k, v, o, B, H, N, st, scale, s);
    if (D == 32) return ff::launch<32>(q, k, v, o, B, H, N, st, scale, s);
    return cudaErrorInvalidValue;
  }
  for (int t = 0; t < 4; ++t)  // contiguous (B, H, N, D)
    if (st[3 * t] != static_cast<long long>(H) * N * D || st[3 * t + 1] != static_cast<long long>(N) * D ||
        st[3 * t + 2] != D)
      return cudaErrorInvalidValue;
  const int bh = static_cast<int>(BH);
  if (D == 64) return launch_tc<64>(q, k, v, o, bh, N, scale, s);
  if (D == 32) return launch_tc<32>(q, k, v, o, bh, N, scale, s);
  return cudaErrorInvalidValue;
}

PP_EXPORT_ERROR_STRING
