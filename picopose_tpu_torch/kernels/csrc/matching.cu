// Template-matching scores: (B, S, C) queries x (N, S, C) bank -> (B, N).
//
// Replaces picopose_tpu/ops/pallas/matching.py::match_scores_pallas
// (_score_kernel), all three operand types.  Per (query b, view n): sim =
// q_b t_n^T (S x S, fp32 sums of storage-dtype products; for int8, exact
// s32 sums converted to fp32 and scaled by fp32(1 / 127^2), the TPU
// kernel's int8 branch :37-42), rows scaled by the query mask (masked
// rows are zeros, not -inf, and still take part in the column maxima);
// rowmax, colmax; t_valid[i] = sim[i,0] < rowmax[i], s_valid[i] =
// sim[0,i] < colmax[i] (argmax != 0 with first-index ties); score =
// sum_i (qm[i] > 0) t_valid[i] s_valid[i] rowmax[i] / S, or 0 where no
// index passes (the reference's aligned-index quirk).
//
// Bound: operations.  At B = 16, N = 162, S = 256, C = 1024 in bf16 the
// products are 348 GFLOP (~0.35 ms on the bf16 tensor cores) over 93 MB
// of input (~28 us); in int8 348 G operations (~0.18 ms at the int8 rate)
// over 47 MB.  The TPU kernel holds the whole 256 x 256 fp32 sim
// block in VMEM; that is 256 KB, more than a Hopper block's 227 KB of
// shared memory or its 256 KB of registers, so sim is computed in blocks
// of 128 query rows x 256 view rows and only per-(b, n) vectors are kept:
// row maxima, per-warp column maxima, sim[:,0], sim[0,:] and the mask.
//
// bf16: one persistent 384-thread block per SM walks the (b, n) pairs
// with n slow, so the ~130 pairs in flight together read ~9 views and
// every q_b, which stay in L2.  One producer warp issues TMA loads of a
// 128 x 64 slice of q_b and a 256 x 64 slice of t_n (128-byte swizzle,
// rows past S zero-filled by the 3-D tensor maps) into a 4-stage mbarrier
// ring (48 KB a stage).  Two consumer warpgroups each own 64 of the 128
// rows and compute their 64 x 256 block with SS wgmma m64n256k16 (128 fp32
// registers a thread, B read once per warpgroup per k16 step).  The
// epilogue runs on the registers: the mask scale, row maxima by quad
// shuffles, column maxima by a butterfly reduce-scatter over the warp's
// rows (56 shuffles a thread, no scratch tile), sim[:,0] and sim[0,:] taken
// on the way; columns past S are -inf in the row maxima and rows past S
// -inf in the column maxima, so a zero-filled pad never beats a negative
// sim.  S > 256 walks 256-column chunks with the row maxima kept in
// registers.  int8 is the same kernel: a 128-byte swizzled row holds 128
// int8 channels instead of 64 bf16 ones, so a stage is the same 48 KB,
// each wgmma m64n256k32 (s8 x s8 -> s32) consumes the same 32 bytes of K
// as an m64n256k16 bf16 step, and its s32 accumulators sit where the fp32
// ones do; they are converted and scaled in their own registers (fp32 bits
// in the s32 array: a second array spilled) before the same epilogue
// (zero-filled pads still give 0 products).  fp32: plain FMAs from device memory
// on the CUDA cores, with 16 x 16 tiles folded through a per-warp scratch
// tile.

#include "hopper.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr size_t kMaxSmem = 232448;
constexpr int kWarps = 8;  // of the fp32 kernel and of both consumers together

// per-(b, n) vectors in shared memory, in floats
struct Vectors {
  float *colmax_part, *rowmax, *col0, *row0, *mask, *red;
};

__device__ __forceinline__ Vectors carve(float* p, int S) {
  Vectors v;
  v.colmax_part = p;  // [kWarps][S]
  v.rowmax = v.colmax_part + kWarps * S;
  v.col0 = v.rowmax + S;  // sim[:, 0]
  v.row0 = v.col0 + S;    // sim[0, :]
  v.mask = v.row0 + S;
  v.red = v.mask + S;     // [2 * kWarps]
  return v;
}

size_t vector_floats(int S) { return static_cast<size_t>(kWarps + 4) * S + 2 * kWarps; }

// threads [t0, t0 + nthreads) reset the vectors for query b
__device__ __forceinline__ void reset(const Vectors& v, const float* qm, int b, int S, int t,
                                      int nthreads) {
  for (int i = t; i < kWarps * S; i += nthreads) v.colmax_part[i] = -CUDART_INF_F;
  for (int i = t; i < S; i += nthreads) v.mask[i] = qm[static_cast<size_t>(b) * S + i];
}

// threads t = 0 .. kWarps*32 - 1 of the caller's barrier `sync` fold the
// vectors into the score; thread 0 writes it
template <typename Sync>
__device__ __forceinline__ void write_score(const Vectors& v, float* out, int S, int t,
                                            Sync sync) {
  const int warp = t / 32, lane = t % 32;
  float count = 0.f, total = 0.f;
  for (int i = t; i < S; i += kWarps * 32) {
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
  sync();
  if (t == 0) {
    float c = 0.f, s = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      c += v.red[w];
      s += v.red[kWarps + w];
    }
    *out = c > 0.f ? s / static_cast<float>(S) : 0.f;
  }
}

// ---- bf16: wgmma over TMA-staged slices ----------------------------------

namespace tc {

constexpr int kRows = 128;  // query rows per block (two consumers x 64)
constexpr int kCols = 256;  // view rows per chunk (wgmma N)
constexpr int kRowBytes = 128;  // channels per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kABytes = kRows * kRowBytes;  // 16 KB
constexpr int kBBytes = kCols * kRowBytes;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kRing = kStages * kStageBytes;
constexpr int kBars = 2 * kStages;

size_t smem_bytes(int S) {
  return 1024 + kRing + kBars * 8 + vector_floats(S) * sizeof(float);
}

struct Args {
  const float* qm;
  float* out;
  int B, N, S, C;
};

// the TPU kernel's rescale of the int8 products: 1 / 127^2 rounded once to fp32
constexpr float kInt8Scale = static_cast<float>(1.0 / (127.0 * 127.0));

template <typename In>
constexpr bool kInt8 = std::is_same_v<In, int8_t>;
template <typename In>
constexpr int kK = kRowBytes / static_cast<int>(sizeof(In));  // channels per stage

// One step of the reduce-scatter: the lane whose `bit` is set keeps
// x[HALF..2 HALF), its partner x[0..HALF); each takes the maximum with the
// partner's copy of the half it keeps, into x[0..HALF).
template <int HALF, int BIT>
__device__ __forceinline__ void exchange(float (&x)[64], int lane) {
  const bool hi = lane & BIT;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = hi ? x[j] : x[j + HALF];
    const float keep = hi ? x[j + HALF] : x[j];
    x[j] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, BIT));
  }
}

// The block's sims as fp32: an fp32 accumulator, or the fp32 bits that the
// int8 branch stores in its s32 accumulator registers (no second array)
__device__ __forceinline__ float as_f(float x) { return x; }
__device__ __forceinline__ float as_f(int32_t x) { return __int_as_float(x); }
__device__ __forceinline__ void set_f(float& x, float f) { x = f; }
__device__ __forceinline__ void set_f(int32_t& x, float f) { x = __float_as_int(f); }

// Fold one consumer's 64 x 256 block (rows row0.., columns col0..) into the
// vectors.  rm: this thread's running row maxima (rows r and r + 8).
template <typename Acc>
__device__ __forceinline__ void fold(Acc (&acc)[128], const Vectors& v, int S, int row0,
                                     int col0, int part, float (&rm)[2]) {
  const int lane = threadIdx.x % 32, r = lane / 4, qd = lane % 4;
  const int rows[2] = {row0 + r, row0 + r + 8};
  const bool ok[2] = {rows[0] < S, rows[1] < S};
  const float m[2] = {ok[0] ? v.mask[rows[0]] : 0.f, ok[1] ? v.mask[rows[1]] : 0.f};
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int h = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + 2 * qd + (i & 1);
    const float a = as_f(acc[i]) * m[h];
    set_f(acc[i], a);
    rm[h] = fmaxf(rm[h], col < S ? a : -CUDART_INF_F);
  }
  if (col0 == 0 && qd == 0) {  // sim[:, 0]
    if (ok[0]) v.col0[rows[0]] = as_f(acc[0]);
    if (ok[1]) v.col0[rows[1]] = as_f(acc[2]);
  }
  if (row0 + r == 0) {  // sim[0, :]: lanes 0-3 of the first warp
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int col = col0 + 8 * (i >> 2) + 2 * qd + (i & 1);
      if (!((i >> 1) & 1) && col < S) v.row0[col] = as_f(acc[i]);
    }
  }
  // column maxima over the warp's 16 rows: both rows of this thread, then a
  // butterfly reduce-scatter over the 8 lanes of each quad position; lane
  // (r, qd) ends with columns 32 r + 8 m + 2 qd + e (m < 4, e < 2)
  float x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    const int i = 4 * (k >> 1) + (k & 1);
    x[k] = fmaxf(ok[0] ? as_f(acc[i]) : -CUDART_INF_F, ok[1] ? as_f(acc[i + 2]) : -CUDART_INF_F);
  }
  exchange<32, 16>(x, lane);
  exchange<16, 8>(x, lane);
  exchange<8, 4>(x, lane);
  float* cm = v.colmax_part + part * S;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + 32 * r + 8 * (j >> 1) + 2 * qd + (j & 1);
    if (col < S) cm[col] = fmaxf(cm[col], x[j]);
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 1)
match_scores_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap tmap, const Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing);
  uint64_t* empty = full + kStages;
  const Vectors v = carve(reinterpret_cast<float*>(smem + kRing + kBars * 8), args.S);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 8);  // every consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int S = args.S, units = args.B * args.N;
  const int row_blocks = (S + kRows - 1) / kRows, chunks = (S + kCols - 1) / kCols;
  const int ksteps = (args.C + kK<In> - 1) / kK<In>;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int g = 0;  // stages issued
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u % args.B, n = u / args.B;
      for (int rb = 0; rb < row_blocks; ++rb)
        for (int cb = 0; cb < chunks; ++cb)
          for (int k = 0; k < ksteps; ++k, ++g) {
            const int s = g % kStages;
            hop::mbar_wait(empty + s, ((g / kStages) & 1) ^ 1);
            hop::mbar_expect_tx(full + s, kStageBytes);
            unsigned char* st = smem + s * kStageBytes;
            hop::tma_load_3d(st, &qmap, full + s, k * kK<In>, rb * kRows, b);
            hop::tma_load_3d(st + kABytes, &tmap, full + s, k * kK<In>, cb * kCols, n);
          }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x - 128, warp = t / 32, lane = t % 32;
  const auto sync = [] { hop::named_sync(1, 256); };
  int g = 0;  // stages consumed
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b = u % args.B, n = u / args.B;
    sync();  // the previous pair's score is written
    reset(v, args.qm, b, S, t, 256);
    sync();
    for (int rb = 0; rb < row_blocks; ++rb) {
      const int row0 = rb * kRows + c * 64 + (warp % 4) * 16;
      float rm[2] = {-CUDART_INF_F, -CUDART_INF_F};
      for (int cb = 0; cb < chunks; ++cb) {
        std::conditional_t<kInt8<In>, int32_t, float> acc[128];
        for (int k = 0; k < ksteps; ++k, ++g) {
          const int s = g % kStages;
          hop::mbar_wait(full + s, (g / kStages) & 1);
          const uint32_t a = hop::smem_u32(smem + s * kStageBytes + c * (kABytes / 2));
          const uint32_t bt = hop::smem_u32(smem + s * kStageBytes + kABytes);
          hop::pin(acc);
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < kRowBytes / 32; ++kk)  // 32 bytes of K per product
            hop::mma_ss_n256(acc, hop::desc_sw128(a + kk * 32), hop::desc_sw128(bt + kk * 32),
                             k > 0 || kk > 0);
          hop::wg_commit();
          hop::wg_wait_one();  // the previous stage's products are done
          hop::pin(acc);
          if (k > 0) {
            __syncwarp();
            if (lane == 0) hop::mbar_arrive(empty + (g - 1) % kStages);
          }
        }
        hop::wg_wait_all();
        hop::pin(acc);
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(empty + (g - 1) % kStages);
        if constexpr (kInt8<In>) {  // exact s32 sums -> fp32, rescaled once
#pragma unroll
          for (int i = 0; i < 128; ++i) set_f(acc[i], __int2float_rn(acc[i]) * kInt8Scale);
        }
        fold(acc, v, S, row0, cb * kCols, warp, rm);
      }
      // row maxima: the quad holds the row's columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 1));
        rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 2));
        const int row = row0 + lane / 4 + 8 * h;
        if (lane % 4 == 0 && row < S) v.rowmax[row] = rm[h];
      }
    }
    sync();
    write_score(v, args.out + static_cast<size_t>(b) * args.N + n, S, t, sync);
  }
}

template <typename In>
int launch(const void* q, const void* qm, const void* t, void* out, int B, int N, int S, int C,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  if (smem > kMaxSmem || (C * sizeof(In)) % 16 != 0) return cudaErrorInvalidValue;
  CUtensorMap qmap, tmap;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * sizeof(In);
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t tdims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {row, row * S};
  const cuuint32_t qbox[3] = {kK<In>, kRows, 1}, tbox[3] = {kK<In>, kCols, 1};
  // int8 travels as uint8: the same bits, and TMA only copies them
  const CUtensorMapDataType dt =
      kInt8<In> ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hop::encode_sw128(&qmap, q, 3, qdims, strides, qbox, dt) ||
      !hop::encode_sw128(&tmap, t, 3, tdims, strides, tbox, dt))
    return cudaErrorInvalidPitchValue;
  cudaError_t e = cudaFuncSetAttribute(match_scores_hopper_kernel<In>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int sms = hop::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long units = static_cast<long long>(B) * N;
  const int grid = units < sms ? static_cast<int>(units) : sms;
  const Args a{static_cast<const float*>(qm), static_cast<float*>(out), B, N, S, C};
  match_scores_hopper_kernel<In><<<grid, kThreads, smem, stream>>>(qmap, tmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- fp32: CUDA cores ----------------------------------------------------

constexpr int kThreads = kWarps * 32;
constexpr int kPass = kWarps * 16;  // rows and columns of one pass
constexpr int kFrags = kPass / 16;  // 16-column tiles per warp and pass
constexpr int kScratchLd = 20;      // padded row stride of a warp's 16x16 tile

size_t f32_smem_bytes(int S) {
  return (static_cast<size_t>(kWarps) * 16 * kScratchLd + vector_floats(S)) * sizeof(float);
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

__global__ void __launch_bounds__(kThreads)
match_scores_f32_kernel(const float* __restrict__ q, const float* __restrict__ qm,
                        const float* __restrict__ t, float* __restrict__ out, int B,
                        int N, int S, int C) {
  const int b = blockIdx.x % B, n = blockIdx.x / B;
  const float* qb = q + static_cast<size_t>(b) * S * C;
  const float* tn = t + static_cast<size_t>(n) * S * C;

  extern __shared__ __align__(128) float smem[];
  const Vectors v = carve(smem + kWarps * 16 * kScratchLd, S);
  reset(v, qm, b, S, threadIdx.x, kThreads);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = smem + warp * 16 * kScratchLd;
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
  write_score(v, out + static_cast<size_t>(b) * N + n, S, threadIdx.x, [] { __syncthreads(); });
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 int8 (q and t alike)
extern "C" int pp_match_scores(const void* q, const void* qm, const void* t,
                               void* out, int B, int N, int S, int C, int dtype,
                               void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || C <= 0 || S % 16 != 0 || C % 16 != 0 ||
      dtype < 0 || dtype > 2 || static_cast<long long>(B) * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return tc::launch<bf16>(q, qm, t, out, B, N, S, C, s);
  if (dtype == 2) return tc::launch<int8_t>(q, qm, t, out, B, N, S, C, s);
  const size_t smem = f32_smem_bytes(S);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(match_scores_f32_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  match_scores_f32_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * N), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(qm), static_cast<const float*>(t),
      static_cast<float*>(out), B, N, S, C);
  return static_cast<int>(cudaGetLastError());
}

PP_EXPORT_ERROR_STRING
