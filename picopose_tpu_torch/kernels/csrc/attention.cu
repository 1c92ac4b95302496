// Fused softmax attention for short sequences: (BH, N, D) -> (BH, N, D).
//
// Replaces picopose_tpu/ops/pallas/flash_attention.py::flash_attention
// (_attn_kernel): S = Q K^T in fp32 from storage-dtype operands, the scale
// applied to the fp32 scores, keys >= N masked, fp32 softmax, P rounded to
// V's dtype, P V accumulated in fp32, output in Q's dtype.
//
// Bound: bytes.  At (16*16, 257, 64) bf16 the kernel must move 33.7 MB
// (~10 us at 3.35 TB/s) for 4.3 GFLOP (~4.4 us on the bf16 tensor cores).
//
// bf16 (the main path): one block of 4 warps per (batch*head, 64 query
// rows).  K, V of the head and the Q tile are copied to shared memory in
// 16-byte cp.async pieces, all in flight at once (rows padded by 16 bytes, keys padded to a multiple of 16
// with zero rows: the ragged edge is masked here, not padded to 384 as on
// the TPU).  Each warp owns 16 query rows and walks the keys in chunks of
// 64 with tensor-core (wmma / mma.sync) products into a small fp32 scratch.
// The softmax must see the whole row before P is rounded to bf16 (as the
// TPU kernel does), so the chunked Q K^T is recomputed in two passes --
// row maximum and sum, then P and P V -- instead of keeping a 16 x N fp32
// score block per warp: the products are cheap, shared memory is not.
// fp32: one warp per query row on the CUDA cores (keys spread over lanes,
// P shuffled to the lane owning each output column).

#include "common.cuh"

#include <cuda_pipeline.h>
#include <mma.h>

namespace {

constexpr int kMaxKeys = 512;
constexpr size_t kMaxSmem = 232448;  // what one Hopper block may opt in to

// ---- bf16: tensor cores --------------------------------------------------

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

template <int D>
size_t smem_bytes(int N) {
  return static_cast<size_t>(N) * (key_stride<D>() + D) * sizeof(float) +
         kWarps * D * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N,
                     float scale) {
  constexpr int KS = key_stride<D>();
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + N * KS;
  float* qs = vs + N * D;

  const size_t base = static_cast<size_t>(blockIdx.y) * N * D;
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    ks[(i / D) * KS + (i % D)] = k[base + i];
    vs[i] = v[base + i];
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
  const size_t smem = smem_bytes<D>(N);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  attention_f32_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pp_attention(const void* q, const void* k, const void* v, void* o,
                            int BH, int N, int D, float scale, int is_bf16,
                            void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 || N > kMaxKeys) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch_tc<64>(q, k, v, o, BH, N, scale, s);
    if (D == 32) return launch_tc<32>(q, k, v, o, BH, N, scale, s);
  } else {
    if (D == 64) return launch_f32<64>(q, k, v, o, BH, N, scale, s);
    if (D == 32) return launch_f32<32>(q, k, v, o, BH, N, scale, s);
  }
  return cudaErrorInvalidValue;
}

PP_EXPORT_ERROR_STRING
