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
// (zero-filled pads still give 0 products).
//
// fp32 (PICOPOSE_MATCH_FP32=1 and the fp32 models): full fp32 on the CUDA
// cores (no TF32), so bound by operations at the FFMA rate: 348 GFLOP at
// (16, 162, 256, 1024), ~5.19 ms at 67 TFLOP/s; 8.46 GFLOP at the
// accuracy loop's (4, 42, 256, 384), ~0.126 ms.  A register-tiled SGEMM:
// a 256-thread block computes one 128 x 128 tile of one pair's sim, each
// thread an 8 x 8 tile of fp32 sums in registers (16 FMAs per float4 read
// from shared memory), over 16-channel slices staged by 16-byte cp.async
// copies into a 3-stage ring (channels contiguous, rows padded to 80 B so
// a quarter-warp's reads hit 8 bank groups; 61 KB).  One block per SM,
// so that the tile and its operands get ~234 registers (held to two
// blocks, to 128 registers, the kernel ran slower at both shapes).
// The epilogue runs on the registers: the mask scale, the tile's row and
// column maxima (columns and rows past S left out), sim[:, 0] and sim[0,
// :], written to a scratch.  Tiles, not pairs, fill the card: (4, 42,
// 256, 384) is 672 tiles on 132 SMs, where one block per pair was 1.27
// waves; the tiles are numbered with the view slowest, so the views in
// flight and every query stay in L2 (the fp32 bank at (16, 162, 256,
// 1024) is 170 MB).  A second kernel folds each pair's partial maxima in
// a fixed order (a maximum does not depend on it) and takes the masked
// mean as write_score does, so two calls agree bitwise.

#include "hopper.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr size_t kMaxSmem = 232448;
constexpr int kWarps = 8;  // of both consumers together

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

// ---- fp32: register-tiled FFMA on the CUDA cores ------------------------

namespace ff {

constexpr int kTile = 128;    // query rows and view rows of a block's tile
constexpr int kK = 16;        // channels per stage
constexpr int kLd = kK + 4;   // row stride in floats: 80 B, so 8 consecutive rows hit 8 16-byte bank groups
constexpr int kStages = 3;    // cp.async ring
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 sims each
constexpr int kStageFloats = 2 * kTile * kLd;
constexpr int kSmem = kStages * kStageFloats * static_cast<int>(sizeof(float));  // 61,440 B
constexpr int kFoldWarps = 8;

// Per-(b, n) partial vectors in the scratch, P = B * N pairs, T = tiles
// along S: row maxima per column tile [P][T][S], column maxima per row
// tile [P][T][S], sim[:, 0] [P][S], sim[0, :] [P][S].
struct Partials {
  float *rowmax, *colmax, *col0, *row0;
  static constexpr long long floats(long long P, int T, int S) { return P * S * (2LL * T + 2); }
  __device__ Partials(float* s, long long P, int T, int S) {
    rowmax = s;
    colmax = rowmax + P * T * S;
    col0 = colmax + P * T * S;
    row0 = col0 + P * S;
  }
};

// one stage: rows r0.. of q_b and c0.. of t_n, channels k0..k0+15, four
// 16-byte copies a thread; rows past S are zero-filled
__device__ __forceinline__ void load_stage(float* st, const float* qb, const float* tn, int r0,
                                           int c0, int S, int C, int k0) {
#pragma unroll
  for (int it = 0; it < 2 * kTile * (kK / 4) / kThreads; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int which = c / (kTile * (kK / 4));  // 0: query rows, 1: view rows
    const int rr = (c / (kK / 4)) % kTile, part = c % (kK / 4);
    const int row = (which ? c0 : r0) + rr;
    const bool ok = row < S;
    const float* src = (which ? tn : qb) + static_cast<size_t>(ok ? row : 0) * C + k0 + part * 4;
    pp::cp_async16(st + which * kTile * kLd + rr * kLd + part * 4, src, ok);
  }
}

// One 128 x 128 tile of sim for (b, n): rows r0.., columns c0..  Thread
// (tx, ty) holds rows r0 + ty + 16 i and columns c0 + tx + 16 j (i, j < 8),
// so a quarter-warp's float4 reads of the view rows fall on 8 consecutive
// padded rows (no bank conflict) and its query-row reads are broadcasts.
__global__ void __launch_bounds__(kThreads, 1)
match_scores_ffma_kernel(const float* __restrict__ q, const float* __restrict__ qm,
                         const float* __restrict__ t, float* __restrict__ scratch, int B, int N,
                         int S, int C) {
  extern __shared__ __align__(16) float sm[];
  const int T = (S + kTile - 1) / kTile;
  long long u = blockIdx.x;  // column tile fastest, then row tile, query, view (slow: L2)
  const int cb = static_cast<int>(u % T);
  u /= T;
  const int rb = static_cast<int>(u % T);
  u /= T;
  const int b = static_cast<int>(u % B), n = static_cast<int>(u / B);
  const long long p = static_cast<long long>(b) * N + n;
  const float* qb = q + static_cast<size_t>(b) * S * C;
  const float* tn = t + static_cast<size_t>(n) * S * C;
  const int r0 = rb * kTile, c0 = cb * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = C / kK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(sm + s * kStageFloats, qb, tn, r0, c0, S, C, s * kK);
    pp::cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    pp::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every thread is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < steps) load_stage(sm + (next % kStages) * kStageFloats, qb, tn, r0, c0, S, C, next * kK);
    pp::cp_async_commit();
    const float* as = sm + (kt % kStages) * kStageFloats;
    const float* bs = as + kTile * kLd;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLd + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, w.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w.w, acc[i][j]);
        }
      }
    }
  }
  pp::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the column maxima

  // epilogue in registers: the mask scale, then this tile's share of the
  // row maxima (columns past S left out), column maxima (rows past S left
  // out), sim[:, 0] and sim[0, :]
  const Partials part(scratch, static_cast<long long>(B) * N, T, S);
  bool rok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty + 16 * i;
    rok[i] = row < S;
    const float m = rok[i] ? qm[static_cast<size_t>(b) * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= m;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float rm = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + tx + 16 * j < S) rm = fmaxf(rm, acc[i][j]);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
    const int row = r0 + ty + 16 * i;
    if (tx == 0 && rok[i]) {
      part.rowmax[(p * T + cb) * S + row] = rm;
      if (c0 == 0) part.col0[p * S + row] = acc[i][0];
    }
  }
  if (r0 == 0 && ty == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + tx + 16 * j < S) part.row0[p * S + c0 + tx + 16 * j] = acc[0][j];
  }
  float* red = sm;  // [8 warps][kTile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float cm = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (rok[i]) cm = fmaxf(cm, acc[i][j]);
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));  // the warp's other ty
    if (lane < 16) red[warp * kTile + tx + 16 * j] = cm;
  }
  __syncthreads();
  if (threadIdx.x < kTile && c0 + static_cast<int>(threadIdx.x) < S) {
    float cm = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) cm = fmaxf(cm, red[w * kTile + threadIdx.x]);
    part.colmax[(p * T + rb) * S + c0 + threadIdx.x] = cm;
  }
}

// One warp per (b, n): the partial maxima folded in a fixed order (a
// maximum does not depend on it), validity, and the masked mean with the
// lanes' sums combined in a fixed butterfly, so two calls agree bitwise.
__global__ void __launch_bounds__(kFoldWarps * 32)
match_fold_ffma_kernel(const float* __restrict__ qm, float* __restrict__ scratch,
                       float* __restrict__ out, int B, int N, int S) {
  const long long P = static_cast<long long>(B) * N;
  const long long p = static_cast<long long>(blockIdx.x) * kFoldWarps + threadIdx.x / 32;
  if (p >= P) return;
  const int lane = threadIdx.x % 32, T = (S + kTile - 1) / kTile;
  const Partials part(scratch, P, T, S);
  const float* m = qm + (p / N) * S;
  float count = 0.f, total = 0.f;
  for (int i = lane; i < S; i += 32) {
    float rm = -CUDART_INF_F, cm = -CUDART_INF_F;
    for (int k = 0; k < T; ++k) {
      rm = fmaxf(rm, part.rowmax[(p * T + k) * S + i]);
      cm = fmaxf(cm, part.colmax[(p * T + k) * S + i]);
    }
    if (m[i] > 0.f && part.col0[p * S + i] < rm && part.row0[p * S + i] < cm) {
      count += 1.f;
      total += rm;
    }
  }
  count = pp::warp_sum(count);
  total = pp::warp_sum(total);
  if (lane == 0) out[p] = count > 0.f ? total / static_cast<float>(S) : 0.f;
}

int launch(const float* q, const float* qm, const float* t, float* out, float* scratch, int B,
           int N, int S, int C, cudaStream_t stream) {
  const long long T = (S + kTile - 1) / kTile, P = static_cast<long long>(B) * N;
  if (scratch == nullptr || P * T * T > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(match_scores_ffma_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  match_scores_ffma_kernel<<<static_cast<unsigned>(P * T * T), kThreads, kSmem, stream>>>(
      q, qm, t, scratch, B, N, S, C);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return first;
  match_fold_ffma_kernel<<<static_cast<unsigned>((P + kFoldWarps - 1) / kFoldWarps), kFoldWarps * 32,
                           0, stream>>>(qm, scratch, out, B, N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ff

}  // namespace

// Floats of the fp32 branch's scratch (ff::Partials), which the caller
// allocates and passes to pp_match_scores.
extern "C" long long pp_match_scratch_floats(int B, int N, int S) {
  return ff::Partials::floats(static_cast<long long>(B) * N, (S + ff::kTile - 1) / ff::kTile, S);
}

// dtype: 0 fp32, 1 bf16, 2 int8 (q and t alike).  scratch: fp32 only,
// pp_match_scratch_floats(B, N, S) floats.
extern "C" int pp_match_scores(const void* q, const void* qm, const void* t, void* out,
                               void* scratch, int B, int N, int S, int C, int dtype,
                               void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || C <= 0 || S % 16 != 0 || C % 16 != 0 ||
      dtype < 0 || dtype > 2 || static_cast<long long>(B) * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return tc::launch<bf16>(q, qm, t, out, B, N, S, C, s);
  if (dtype == 2) return tc::launch<int8_t>(q, qm, t, out, B, N, S, C, s);
  return ff::launch(static_cast<const float*>(q), static_cast<const float*>(qm),
                    static_cast<const float*>(t), static_cast<float*>(out),
                    static_cast<float*>(scratch), B, N, S, C, s);
}

PP_EXPORT_ERROR_STRING
