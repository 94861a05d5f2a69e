// Fused conv + batch-norm (training statistics) + optional ReLU, forward and
// backward, for Hopper (sm_90a).  Five kernels, one for each Pallas kernel of
// paddle_tpu/ops/pallas/conv_bn.py:
//
//   conv_stats   replaces _conv_stats_kernel (launched by _conv_fwd): a k x k
//                stride-1 conv over NHWC x and OIHW w, z = conv(x, w) rounded
//                to x's dtype, plus the per-channel sum and sum of squares of
//                the ROUNDED z (the values batch_norm would read back).
//   mm_stats     replaces _mm_stats_kernel (launched by _mm_fwd): the same for
//                a 1 x 1 conv at any stride, a [R, C] x [C, O] product.
//   apply        replaces _apply_kernel (launched by _pallas_fwd):
//                y = (z - mean) * rstd * scale + shift, then ReLU, in x's dtype.
//   bwd_reduce   replaces _bwd_reduce_kernel (launched by _pallas_bwd): the
//                ReLU mask rebuilt from the statistics, and per-block partials
//                of dgamma = sum g * xhat and dbeta = sum g.
//   bwd_dz       replaces _bwd_dz_kernel (launched by _pallas_bwd):
//                dz = rstd * scale * (g - dbeta / R - xhat * dgamma / R).
//
// conv_stats and mm_stats each run one of two kernels: the tensor-core one
// (conv_stats_tc below: bf16 with C and O multiples of 8) or the SIMT one.
// dX and dW of the conv stay on the library convolution, as the TPU path
// keeps them on XLA.
//
// Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s f32 outside them).
// conv_stats / mm_stats: 2 * M * O * K operations for M = N * Ho * Wo,
// K = kh * kw * C, against x, w and z moved once: at ResNet-50's shapes
// both terms are close (a stage-0 3 x 3 at batch 128 moves 103 MB and does
// 29.6 GFLOP in bf16), the 1 x 1 convs are bound by bytes.  apply,
// bwd_reduce and bwd_dz do a few flops an element: bytes (z and g read, y
// or dz written once).
//
// Design.  The TPU kernels carry the statistics across a sequential grid in
// an output block that stays resident; blocks on the card run in parallel
// and in no order, so every kernel here writes per-block partials and the
// caller sums them in a fixed order (torch's sum over the partial rows):
// no atomics, the results are deterministic.
//
// conv_stats and mm_stats are one implicit GEMM, M = N * Ho * Wo rows,
// N = O columns, K = kh * kw * C.  A block computes a 64-row x 64-channel
// tile of z with 256 threads, 4 x 4 outputs a thread in f32 registers.  It
// walks the taps (ki, kj) and, within a tap, the input channels in chunks
// of 16: each chunk stages a 64 x 16 slice of x (the rows' input pixels at
// that tap, zero where the tap falls into the padding, so no padded copy of
// x is made) and a 16 x 64 slice of the weights (laid out [kh, kw, C, O] by
// the caller) in shared memory as f32, then runs 16 rank-1 updates.  The
// 1 x 1 entry point reads x at the stride directly (the TPU path sliced a
// strided copy first).  Epilogue: each accumulator is rounded to x's dtype
// and stored; the rounded values' sum and sum of squares over the tile's
// rows go through shared memory in a fixed order into one row of partials
// [2, T, O] per 64-row tile.  The grid is (M tiles, O tiles), so the deep
// stages' few rows still give hundreds of blocks.  Any C, O, H, W, float32
// or bfloat16, with scalar loads where a 4-wide load does not fit.  This is
// SIMT f32 arithmetic: rows 10 and 11 in float32 (tensor cores would round
// them to TF32) and in bf16 where C or O is not a multiple of 8 run it.
//
// conv_stats_tc (rows 10 and 11 in bf16, the training path's dtype): the
// same implicit GEMM on the tensor cores (hopper_mma.cuh).  A block of WG
// warpgroups computes a BM = 64 * WG row x BN (64 or 128) column tile, each
// warpgroup 64 rows with wgmma.m64nBNk16 (bf16 operands from shared
// memory, f32 accumulators in registers).  A k-block is one tap x 64 input
// channels: the A tile (BM rows of the im2col matrix) is gathered straight
// from NHWC x by 16-byte cp.async copies, zero-filled where the tap falls
// into the padding or the row lies past M; the B tile comes from the
// weights laid out [kh, kw, O, C] (K-major) by the caller.  Both land in
// the 128B-swizzled layout the wgmma descriptor names.  A ring of STAGES
// k-blocks: with 4, 2 k-blocks load while one multiplies and the one
// before may still be in flight (wgmma.wait_group 1); with 2, one loads
// while one multiplies.  Epilogue: each accumulator is rounded to bf16
// and staged in shared memory (stored as coalesced 16-byte rows); the
// rounded values' column sums and sums of squares go by warp shuffles
// over the warp's 16 rows, then in a fixed order over the warps through
// shared memory, into one partial row per BM-row tile: still no atomics,
// still deterministic.  Blocks are numbered with the column tiles
// fastest, so the blocks that share an A tile run together and read it
// from device memory once.  Row 10 (k x k, stride 1) runs it with a
// 4-stage ring; at ResNet-50's shapes it moves each x element through L2
// once a tap (9 times a 3 x 3): the next step is to keep the input rows'
// halo in shared memory across the taps.  Row 11 (1 x 1, any stride, no
// padding: kh = kw = 1, the A rows read x at the stride) is bound by
// bytes (at ResNet-50's stage 0, z is 205 of the 257 MB moved) and has
// only C / 64 k-blocks (one at C = 64), so a deep ring overlaps nothing
// there: it takes the smallest ring and tile that let several blocks
// share an SM, one block's z store overlapping another's loads and
// products.  The caller picks the tile and the ring (conv_bn.py
// conv_tc_tile, mm_tc_tile).

// apply, bwd_reduce and bwd_dz sweep z [R, O] (and g): a thread owns 4
// adjacent channels (1 when O % 4 != 0), holds their four statistic rows
// (and the dgamma/dbeta totals) in registers, and walks rows; blocks are
// (rows / RB, O / (4 * threads)), the layout chosen by the caller.
// bwd_reduce keeps its partial sums in registers, adds a block's threads
// in a fixed order through shared memory and writes one partial row per
// row block [2, NB, O].
//
// The ReLU decision.  apply keeps y where (z - m) * rstd * scale + shift
// > 0; bwd_reduce and bwd_dz rebuild that mask from the same statistics.
// All three evaluate it with bn_affine below, one rounding an operation
// (__fsub_rn, __fmul_rn, __fadd_rn: nothing is contracted into an FMA), so
// the backward's mask is the forward's decision bit for bit, and equals the
// plain PyTorch version's, which rounds each operation the same way.
//
// C interface (ctypes): each *_launch returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.  The
// kernels run on the caller's stream, allocate nothing and do not
// synchronise.  dtype: 0 = float32, 1 = bfloat16 (x, w, z, y, g, dz);
// statistics and partials are float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kBM = 64;       // rows (output pixels) of a conv tile
constexpr int kBN = 64;       // output channels of a conv tile
constexpr int kBK = 16;       // input channels staged a step
constexpr int kConvThreads = 256;
constexpr int kSweepThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// VEC adjacent elements (VEC = 4: one 16- or 8-byte access; VEC = 1: one).
template <int VEC, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    load4(p, v);
  } else {
    v[0] = to_f(p[0]);
  }
}
template <int VEC, typename T>
__device__ __forceinline__ void storev(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    store4(p, v);
  } else {
    p[0] = from_f<T>(v[0]);
  }
}

// xhat = (z - m) * rstd, one rounding each (no FMA)
__device__ __forceinline__ float bn_xhat(float z, float m, float rstd) {
  return __fmul_rn(__fsub_rn(z, m), rstd);
}
// (z - m) * rstd * scale + shift: the normalised output before the ReLU, and
// the ReLU's predicate (> 0) in every kernel
__device__ __forceinline__ float bn_affine(float xhat, float scale,
                                           float shift) {
  return __fadd_rn(__fmul_rn(xhat, scale), shift);
}

// ---------------------------------------------------------------------------
// conv_stats / mm_stats: implicit GEMM + statistics of the rounded output
// ---------------------------------------------------------------------------

// KXK false: the 1 x 1 entry point (kh = kw = 1, no padding, any stride).
template <typename T, bool KXK>
__global__ void __launch_bounds__(kConvThreads)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w2d,
                  T* __restrict__ z, float* __restrict__ part, int n, int h,
                  int w, int c, int o, int kh, int kw, int sh, int sw, int ph,
                  int pw, int ho, int wo) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float red_s[kConvThreads / 16][kBN];
  __shared__ float red_ss[kConvThreads / 16][kBN];

  const int tid = threadIdx.x;
  const int64_t m_total = (int64_t)n * ho * wo;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;

  // this thread's A-load row: output pixel m0 + a_row, channels a_k.. +3
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int64_t am = m0 + a_row;
  const bool am_ok = am < m_total;
  int an = 0, aoh = 0, aow = 0;
  if (am_ok) {
    an = (int)(am / ((int64_t)ho * wo));
    const int rem = (int)(am - (int64_t)an * ho * wo);
    aoh = rem / wo;
    aow = rem - aoh * wo;
  }
  const int ih0 = aoh * sh - ph;
  const int iw0 = aow * sw - pw;
  const T* xbase = x + (int64_t)an * h * w * c;

  // this thread's B-load row: input channel b_k of the chunk, outputs b_n..+3
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;
  const bool c_vec = (c & 3) == 0;
  const bool o_vec = (o & 3) == 0;

  // compute tile: rows ty*4.., columns tx*4..
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int taps = KXK ? kh * kw : 1;
  for (int tap = 0; tap < taps; ++tap) {
    const int ki = KXK ? tap / kw : 0;
    const int kj = KXK ? tap - ki * kw : 0;
    const int ih = ih0 + ki;
    const int iw = iw0 + kj;
    const bool a_ok = am_ok && (!KXK || (ih >= 0 && ih < h && iw >= 0 && iw < w));
    const T* src = a_ok ? xbase + ((int64_t)ih * w + iw) * c : nullptr;
    const T* wtap = w2d + (int64_t)tap * c * o;
    for (int c0 = 0; c0 < c; c0 += kBK) {
      // stage x: 64 rows x 16 channels, zero outside the image or past C
      float av[4];
      const int ca = c0 + a_k;
      if (a_ok && c_vec && ca + 3 < c) {
        load4(src + ca, av);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          av[j] = (a_ok && ca + j < c) ? to_f(src[ca + j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) As[a_k + j][a_row] = av[j];
      // stage w: 16 channels x 64 outputs, zero past C or O
      float bv[4];
      const int cb = c0 + b_k;
      const int ob = o0 + b_n;
      const T* wrow = wtap + (int64_t)cb * o;
      if (cb < c && o_vec && ob + 3 < o) {
        load4(wrow + ob, bv);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = (cb < c && ob + j < o) ? to_f(wrow[ob + j]) : 0.f;
      }
      *reinterpret_cast<float4*>(&Bs[b_k][b_n]) =
          make_float4(bv[0], bv[1], bv[2], bv[3]);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float ar[4] = {a.x, a.y, a.z, a.w};
        const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: round, store, statistics of the rounded values
  float ps[4] = {0.f, 0.f, 0.f, 0.f};
  float pss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
    T* zrow = z + m * o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = o0 + tx * 4 + j;
      if (col >= o) continue;
      const T r = from_f<T>(acc[i][j]);
      zrow[col] = r;
      const float rf = to_f(r);
      ps[j] += rf;
      pss[j] = fmaf(rf, rf, pss[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty][tx * 4 + j] = ps[j];
    red_ss[ty][tx * 4 + j] = pss[j];
  }
  __syncthreads();
  if (tid < kBN) {
    const int col = o0 + tid;
    if (col < o) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int r = 0; r < kConvThreads / 16; ++r) {
        s += red_s[r][tid];
        ss += red_ss[r][tid];
      }
      const int64_t tiles = gridDim.x;
      part[(int64_t)blockIdx.x * o + col] = s;
      part[(tiles + blockIdx.x) * o + col] = ss;
    }
  }
}

// ---------------------------------------------------------------------------
// conv_stats on the tensor cores (bf16): the same implicit GEMM and epilogue
// on wgmma, fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;      // input channels of one tap a k-block

// k-blocks a ring of STAGES keeps loading ahead, and wgmma groups it
// leaves in flight: the ring holds k-blocks kb - INFLIGHT .. kb + AHEAD
template <int STAGES>
struct TcRing {
  static constexpr int INFLIGHT = STAGES >= 3 ? 1 : 0;
  static constexpr int AHEAD = STAGES - 1 - INFLIGHT;
  static_assert(STAGES >= 2, "a ring of at least 2 stages");
};

template <int WG, int BN, int STAGES>
constexpr int tc_smem_bytes() {
  // the ring, or (after it) the z staging tile and the statistics
  // partials, plus 1024 for the alignment the swizzle needs
  constexpr int ring = STAGES * (64 * WG + BN) * 128;
  constexpr int epi = 64 * WG * (BN + 8) * 2 + 2 * 4 * WG * BN * 4;
  return (ring > epi ? ring : epi) + 1024;
}

// WG warpgroups of 128 threads; each owns 64 rows of the BM = 64 * WG row
// tile and all BN columns.  wk is [kh * kw, O, C] (K-major for B).  Block
// b computes row tile b / nt and column tile b % nt (nt = ceil(O / BN)).
// KXK false: the 1 x 1 entry point (kh = kw = 1, no padding: every A row's
// pixel lies in x), whose blocks are short: registers for two at least on
// an SM.
template <int WG, int BN, int STAGES, bool KXK>
__global__ void __launch_bounds__(WG * 128, KXK ? 1 : 2)
conv_stats_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wk,
                     __nv_bfloat16* __restrict__ z, float* __restrict__ part,
                     int n, int h, int w, int c, int o, int kh, int kw,
                     int sh, int sw, int ph, int pw, int ho, int wo) {
  constexpr int BM = 64 * WG;
  constexpr int NT = 128 * WG;
  constexpr int A_BYTES = BM * 128;
  constexpr int STAGE = A_BYTES + BN * 128;
  constexpr int A_PER = BM * 8 / NT;   // 16-byte chunks a thread, A
  constexpr int B_PER = BN * 8 / NT;   // and B
  constexpr int ROW_STEP = NT / 8;
  constexpr int AHEAD = TcRing<STAGES>::AHEAD;
  constexpr int INFLIGHT = TcRing<STAGES>::INFLIGHT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;
  uint8_t* sptr = smem_raw + pad;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;        // 0 .. 4 * WG - 1: rows 16 * warp ..
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntn = (o + BN - 1) / BN;
  const int mt = blockIdx.x / ntn;
  const int mtiles = gridDim.x / ntn;
  const int64_t m_total = (int64_t)n * ho * wo;
  const int64_t m0 = (int64_t)mt * BM;
  const int o0 = (blockIdx.x - mt * ntn) * BN;
  const int chunk = tid & 7;

  // this thread's A rows: top-left input pixel of the window (may lie in
  // the padding) and its offset in x
  int64_t aoff[A_PER];
  int aih[A_PER], aiw[A_PER];
  bool aok[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int64_t m = m0 + (tid >> 3) + ROW_STEP * i;
    aok[i] = m < m_total;
    const int64_t mm = aok[i] ? m : 0;
    const int nn = (int)(mm / ((int64_t)ho * wo));
    const int rem = (int)(mm - (int64_t)nn * ho * wo);
    const int oh = rem / wo;
    aih[i] = oh * sh - ph;
    aiw[i] = (rem - oh * wo) * sw - pw;
    aoff[i] = (((int64_t)nn * h + aih[i]) * w + aiw[i]) * c;
  }

  const int cblocks = (c + kTcBK - 1) / kTcBK;
  const int nkb = kh * kw * cblocks;

  // load() fills the ring with the k-blocks in order: tap (ki, kj), then
  // the channel block cb within it (counters, no divisions)
  int l_ki = 0, l_kj = 0, l_cb = 0;
  auto load = [&](int stage) {
    const int cc = l_cb * kTcBK + chunk * 8;
    const int64_t xoff = ((int64_t)l_ki * w + l_kj) * c + cc;
    const uint32_t sa = sbase + stage * STAGE;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = (tid >> 3) + ROW_STEP * i;
      const bool ok = aok[i] && cc < c &&
                      (!KXK || ((unsigned)(aih[i] + l_ki) < (unsigned)h &&
                                (unsigned)(aiw[i] + l_kj) < (unsigned)w));
      cp_async16(sa + swz128(r, chunk), ok ? x + (aoff[i] + xoff) : x, ok);
    }
    const uint32_t sb = sa + A_BYTES;
    const int64_t woff = ((int64_t)(l_ki * kw + l_kj) * o + o0) * c + cc;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int r = (tid >> 3) + ROW_STEP * i;
      const bool ok = o0 + r < o && cc < c;
      cp_async16(sb + swz128(r, chunk), ok ? wk + (woff + (int64_t)r * c) : wk,
                 ok);
    }
    if (++l_cb == cblocks) {
      l_cb = 0;
      if (++l_kj == kw) {
        l_kj = 0;
        ++l_ki;
      }
    }
  };

  float acc[BN / 2];
  zero(acc);

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nkb) load(s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<AHEAD - 1>();   // k-block kb has landed
    fence_async_smem();
    __syncthreads();   // ... for every thread; and every warpgroup is done
                       // with k-block kb - 1 - INFLIGHT, whose stage is
                       // refilled here
    const int nxt = kb + AHEAD;
    if (nxt < nkb) load(nxt % STAGES);
    cp_async_commit();
    const uint32_t sa = sbase + (kb % STAGES) * STAGE;
    const uint32_t a0 = sa + wg * 64 * 128;
    const uint32_t b0 = sa + A_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_ss<BN, 0>(acc, desc_sw128(a0 + 32 * kk), desc_sw128(b0 + 32 * kk));
    wg_commit();
    wg_wait<INFLIGHT>();   // at most k-block kb's products still run
    fence_regs(acc);
  }
  wg_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the epilogue reuses it

  // epilogue: round to bf16; stage z in shared memory; the rounded values'
  // column sums and sums of squares (rows past M are zero: they add 0)
  constexpr int ZP = BN + 8;   // padded row pitch of the z tile (elements)
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(sptr);
  float* red = reinterpret_cast<float*>(sptr + BM * ZP * 2);  // [2][NT/32][BN]
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    const int col = 8 * i + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(zs + r0 * ZP + col) = lo;
    *reinterpret_cast<__nv_bfloat162*>(zs + (r0 + 8) * ZP + col) = hi;
    const float2 fl = __bfloat1622float2(lo), fh = __bfloat1622float2(hi);
    float s0 = fl.x + fh.x, s1 = fl.y + fh.y;
    float q0 = fmaf(fh.x, fh.x, fl.x * fl.x);
    float q1 = fmaf(fh.y, fh.y, fl.y * fl.y);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {   // over g: the warp's 16 rows
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (g == 0) {
      red[warp * BN + col] = s0;
      red[warp * BN + col + 1] = s1;
      red[(NT / 32 + warp) * BN + col] = q0;
      red[(NT / 32 + warp) * BN + col + 1] = q1;
    }
  }
  __syncthreads();
  if (tid < BN && o0 + tid < o) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) {   // fixed order
      s += red[wi * BN + tid];
      ss += red[(NT / 32 + wi) * BN + tid];
    }
    part[(int64_t)mt * o + o0 + tid] = s;
    part[((int64_t)mtiles + mt) * o + o0 + tid] = ss;
  }
  // z: 16-byte rows, coalesced
  constexpr int CH = BN / 8;
  for (int idx = tid; idx < BM * CH; idx += NT) {
    const int r = idx / CH, ch = idx - r * CH;
    const int64_t m = m0 + r;
    if (m < m_total && o0 + ch * 8 < o)
      *reinterpret_cast<uint4*>(z + m * o + o0 + ch * 8) =
          *reinterpret_cast<const uint4*>(zs + r * ZP + ch * 8);
  }
}

template <int WG, int BN, int STAGES, bool KXK>
int launch_conv_tc(const void* x, const void* wk, void* z, void* part, int n,
                   int h, int w, int c, int o, int kh, int kw, int sh, int sw,
                   int ph, int pw, int ho, int wo, cudaStream_t s) {
  constexpr int kSmem = tc_smem_bytes<WG, BN, STAGES>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_stats_tc_kernel<WG, BN, STAGES, KXK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);   // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t m = (int64_t)n * ho * wo;
  const int64_t blocks =
      (m + 64 * WG - 1) / (64 * WG) * ((o + BN - 1) / BN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  conv_stats_tc_kernel<WG, BN, STAGES, KXK><<<(unsigned)blocks, WG * 128,
                                              kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wk), static_cast<__nv_bfloat16*>(z),
      static_cast<float*>(part), n, h, w, c, o, kh, kw, sh, sw, ph, pw, ho,
      wo);
  return static_cast<int>(cudaGetLastError());
}

// the tile (bm, bn) and ring depth the caller chose: bm 64 or 128, bn 64
// or 128, stages 4 (and 2 for the 1 x 1 entry point)
template <bool KXK>
int launch_tc_tile(int bm, int bn, int stages, const void* x, const void* wk,
                   void* z, void* part, int n, int h, int w, int c, int o,
                   int kh, int kw, int sh, int sw, int ph, int pw, int ho,
                   int wo, cudaStream_t s) {
#define PADDLE_CONV_TC(BM_, BN_, ST_)                                      \
  if (bm == BM_ && bn == BN_ && stages == ST_)                             \
    return launch_conv_tc<BM_ / 64, BN_, ST_, KXK>(                        \
        x, wk, z, part, n, h, w, c, o, kh, kw, sh, sw, ph, pw, ho, wo, s);
  PADDLE_CONV_TC(128, 64, 4)
  PADDLE_CONV_TC(128, 128, 4)
  PADDLE_CONV_TC(64, 64, 4)
  PADDLE_CONV_TC(64, 128, 4)
  if constexpr (!KXK) {
    PADDLE_CONV_TC(128, 64, 2)
    PADDLE_CONV_TC(128, 128, 2)
    PADDLE_CONV_TC(64, 64, 2)
    PADDLE_CONV_TC(64, 128, 2)
  }
#undef PADDLE_CONV_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// the [R, O] sweeps: apply, bwd_reduce, bwd_dz
// ---------------------------------------------------------------------------

// one past the last row of this block's rb-row slice
__device__ __forceinline__ int64_t row_end(int rows, int rb) {
  const int64_t e = (int64_t)(blockIdx.x + 1) * rb;
  return e < rows ? e : (int64_t)rows;
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kSweepThreads)
apply_kernel(const T* __restrict__ z, const float* __restrict__ stat,
             T* __restrict__ y, int rows, int o, int rb) {
  const int cgi = blockIdx.y * blockDim.x + threadIdx.x;
  if (cgi * VEC >= o) return;
  const int col = cgi * VEC;
  float m[VEC], rs[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = stat[col + j];
    rs[j] = stat[o + col + j];
    sc[j] = stat[2 * o + col + j];
    sh[j] = stat[3 * o + col + j];
  }
  const int64_t r_end = row_end(rows, rb);
  for (int64_t r = (int64_t)blockIdx.x * rb + threadIdx.y; r < r_end;
       r += blockDim.y) {
    float v[VEC];
    loadv<VEC>(z + r * o + col, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float a = bn_affine(bn_xhat(v[j], m[j], rs[j]), sc[j], sh[j]);
      if (RELU) a = a > 0.f ? a : 0.f;
      v[j] = a;
    }
    storev<VEC>(y + r * o + col, v);
  }
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kSweepThreads)
bwd_reduce_kernel(const T* __restrict__ z, const T* __restrict__ g,
                  const float* __restrict__ stat, float* __restrict__ part,
                  int rows, int o, int rb) {
  __shared__ float red_g[kSweepThreads * VEC];
  __shared__ float red_b[kSweepThreads * VEC];
  const int cgi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = cgi * VEC < o;
  const int col = cgi * VEC;
  float dg[VEC], db[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) dg[j] = db[j] = 0.f;
  if (active) {
    float m[VEC], rs[VEC], sc[VEC], sh[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = stat[col + j];
      rs[j] = stat[o + col + j];
      sc[j] = stat[2 * o + col + j];
      sh[j] = stat[3 * o + col + j];
    }
    const int64_t r_end = row_end(rows, rb);
    for (int64_t r = (int64_t)blockIdx.x * rb + threadIdx.y; r < r_end;
         r += blockDim.y) {
      float zv[VEC], gv[VEC];
      loadv<VEC>(z + r * o + col, zv);
      loadv<VEC>(g + r * o + col, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = bn_xhat(zv[j], m[j], rs[j]);
        float gg = gv[j];
        if (RELU && !(bn_affine(xh, sc[j], sh[j]) > 0.f)) gg = 0.f;
        dg[j] = fmaf(gg, xh, dg[j]);
        db[j] += gg;
      }
    }
  }
  // fixed-order sum of the block's rows of threads
  const int slot = (threadIdx.y * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red_g[slot + j] = dg[j];
    red_b[slot + j] = db[j];
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    for (int yy = 1; yy < (int)blockDim.y; ++yy) {
      const int s2 = (yy * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dg[j] += red_g[s2 + j];
        db[j] += red_b[s2 + j];
      }
    }
    const int64_t nb = gridDim.x;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      part[(int64_t)blockIdx.x * o + col + j] = dg[j];
      part[(nb + blockIdx.x) * o + col + j] = db[j];
    }
  }
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kSweepThreads)
bwd_dz_kernel(const T* __restrict__ z, const T* __restrict__ g,
              const float* __restrict__ stat, const float* __restrict__ tot,
              T* __restrict__ dz, int rows, int o, int rb, float rcount) {
  const int cgi = blockIdx.y * blockDim.x + threadIdx.x;
  if (cgi * VEC >= o) return;
  const int col = cgi * VEC;
  float m[VEC], rs[VEC], sc[VEC], sh[VEC], gain[VEC], tb[VEC], tg[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = stat[col + j];
    rs[j] = stat[o + col + j];
    sc[j] = stat[2 * o + col + j];
    sh[j] = stat[3 * o + col + j];
    gain[j] = __fmul_rn(rs[j], sc[j]);             // rstd * scale
    tb[j] = __fmul_rn(tot[o + col + j], rcount);   // dbeta / R
    tg[j] = tot[col + j];                          // dgamma
  }
  const int64_t r_end = row_end(rows, rb);
  for (int64_t r = (int64_t)blockIdx.x * rb + threadIdx.y; r < r_end;
       r += blockDim.y) {
    float zv[VEC], gv[VEC];
    loadv<VEC>(z + r * o + col, zv);
    loadv<VEC>(g + r * o + col, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = bn_xhat(zv[j], m[j], rs[j]);
      float gg = gv[j];
      if (RELU && !(bn_affine(xh, sc[j], sh[j]) > 0.f)) gg = 0.f;
      // gain * ((g - dbeta / R) - (xhat * dgamma) / R)
      const float inner = __fsub_rn(__fsub_rn(gg, tb[j]),
                                    __fmul_rn(__fmul_rn(xh, tg[j]), rcount));
      zv[j] = __fmul_rn(gain[j], inner);
    }
    storev<VEC>(dz + r * o + col, zv);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, bool KXK>
int launch_conv(const void* x, const void* w2d, void* z, void* part, int n,
                int h, int w, int c, int o, int kh, int kw, int sh, int sw,
                int ph, int pw, int ho, int wo, cudaStream_t s) {
  const int64_t m = (int64_t)n * ho * wo;
  const int64_t tiles = (m + kBM - 1) / kBM;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)tiles, (unsigned)((o + kBN - 1) / kBN));
  conv_stats_kernel<T, KXK><<<grid, kConvThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2d),
      static_cast<T*>(z), static_cast<float*>(part), n, h, w, c, o, kh, kw,
      sh, sw, ph, pw, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

// The layout (VEC channels a thread, blockDim (tx, ty), rb rows a block) is
// the caller's choice (ops/kernels/conv_bn.py sweep_layout); it is checked
// here against what the kernels assume: a block of at most kSweepThreads
// threads, VEC 4 only for O % 4 == 0.
template <typename T, int VEC>
int launch_sweep(int which, const void* z, const void* g, const void* stat,
                 const void* tot, void* out, int rows, int o, int relu,
                 int rb, int tx, int ty, float rcount, cudaStream_t s) {
  const int cg = o / VEC;
  const int nb = (rows + rb - 1) / rb;
  dim3 grid(nb, (cg + tx - 1) / tx), block(tx, ty);
  const T* zt = static_cast<const T*>(z);
  const T* gt = static_cast<const T*>(g);
  const float* st = static_cast<const float*>(stat);
  if (which == 0) {
    if (relu)
      apply_kernel<T, VEC, true><<<grid, block, 0, s>>>(
          zt, st, static_cast<T*>(out), rows, o, rb);
    else
      apply_kernel<T, VEC, false><<<grid, block, 0, s>>>(
          zt, st, static_cast<T*>(out), rows, o, rb);
  } else if (which == 1) {
    if (relu)
      bwd_reduce_kernel<T, VEC, true><<<grid, block, 0, s>>>(
          zt, gt, st, static_cast<float*>(out), rows, o, rb);
    else
      bwd_reduce_kernel<T, VEC, false><<<grid, block, 0, s>>>(
          zt, gt, st, static_cast<float*>(out), rows, o, rb);
  } else {
    const float* tt = static_cast<const float*>(tot);
    if (relu)
      bwd_dz_kernel<T, VEC, true><<<grid, block, 0, s>>>(
          zt, gt, st, tt, static_cast<T*>(out), rows, o, rb, rcount);
    else
      bwd_dz_kernel<T, VEC, false><<<grid, block, 0, s>>>(
          zt, gt, st, tt, static_cast<T*>(out), rows, o, rb, rcount);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweep_vec(int which, const void* z, const void* g, const void* stat,
              const void* tot, void* out, int rows, int o, int relu, int rb,
              int vec, int tx, int ty, float rcount, cudaStream_t s) {
  if (vec == 4)
    return launch_sweep<T, 4>(which, z, g, stat, tot, out, rows, o, relu, rb,
                              tx, ty, rcount, s);
  return launch_sweep<T, 1>(which, z, g, stat, tot, out, rows, o, relu, rb,
                            tx, ty, rcount, s);
}

int sweep(int which, const void* z, const void* g, const void* stat,
          const void* tot, void* out, int rows, int o, int relu, int rb,
          int vec, int tx, int ty, float rcount, int dtype, void* stream) {
  if (rows <= 0 || o <= 0 || rb <= 0 || tx <= 0 || ty <= 0 ||
      tx * ty > kSweepThreads || !(vec == 1 || (vec == 4 && o % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sweep_vec<float>(which, z, g, stat, tot, out, rows, o, relu, rb,
                            vec, tx, ty, rcount, s);
  if (dtype == 1)
    return sweep_vec<__nv_bfloat16>(which, z, g, stat, tot, out, rows, o,
                                    relu, rb, vec, tx, ty, rcount, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// z [N*Ho*Wo, O] in x's dtype; part [2, T, O] f32 with T = ceil(N*Ho*Wo /
// 64): row t of part[0] / part[1] holds the sum / sum of squares of the
// rounded z over tile t.  w2d is [kh, kw, C, O] in x's dtype.  Stride 1;
// ph / pw are the top / left pads, Ho / Wo carry the bottom / right ones.
extern "C" int conv_bn_conv_stats_launch(const void* x, const void* w2d,
                                         void* z, void* part, int n, int h,
                                         int w, int c, int o, int kh, int kw,
                                         int ph, int pw, int ho, int wo,
                                         int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 ||
      ho <= 0 || wo <= 0 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_conv<float, true>(x, w2d, z, part, n, h, w, c, o, kh, kw, 1,
                                    1, ph, pw, ho, wo, s);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16, true>(x, w2d, z, part, n, h, w, c, o,
                                            kh, kw, 1, 1, ph, pw, ho, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 k x k conv on the tensor cores: as conv_bn_conv_stats_launch,
// but wk is [kh * kw, O, C] bf16 and the tile is bm rows (64 or 128) x bn
// output channels (64 or 128), on a 4-stage ring: part is [2, T, O] with
// T = ceil(N*Ho*Wo / bm).  C and O must be multiples of 8 (16-byte rows of
// x, w and z).
extern "C" int conv_bn_conv_stats_tc_launch(const void* x, const void* wk,
                                            void* z, void* part, int n,
                                            int h, int w, int c, int o,
                                            int kh, int kw, int ph, int pw,
                                            int ho, int wo, int bm, int bn,
                                            void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 ||
      ho <= 0 || wo <= 0 || ph < 0 || pw < 0 || c % 8 || o % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc_tile<true>(bm, bn, 4, x, wk, z, part, n, h, w, c, o, kh,
                              kw, 1, 1, ph, pw, ho, wo,
                              static_cast<cudaStream_t>(stream));
}

// The 1 x 1 conv at stride (sh, sw), no padding: z [N*Ho*Wo, O] with
// Ho = ceil(H / sh), Wo = ceil(W / sw); w2d is [C, O].  part as above.
extern "C" int conv_bn_mm_stats_launch(const void* x, const void* w2d,
                                       void* z, void* part, int n, int h,
                                       int w, int c, int o, int sh, int sw,
                                       int ho, int wo, int dtype,
                                       void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || o <= 0 || sh <= 0 || sw <= 0 ||
      ho != (h + sh - 1) / sh || wo != (w + sw - 1) / sw)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_conv<float, false>(x, w2d, z, part, n, h, w, c, o, 1, 1, sh,
                                     sw, 0, 0, ho, wo, s);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16, false>(x, w2d, z, part, n, h, w, c, o,
                                             1, 1, sh, sw, 0, 0, ho, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 1 x 1 conv on the tensor cores: as conv_bn_mm_stats_launch, but
// wk is [O, C] bf16 (K-major), the tile bm x bn as for the k x k conv and
// the ring `stages` k-blocks deep (2 or 4): part is [2, T, O] with T =
// ceil(N*Ho*Wo / bm).  C and O must be multiples of 8.
extern "C" int conv_bn_mm_stats_tc_launch(const void* x, const void* wk,
                                          void* z, void* part, int n, int h,
                                          int w, int c, int o, int sh, int sw,
                                          int ho, int wo, int bm, int bn,
                                          int stages, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || o <= 0 || sh <= 0 || sw <= 0 ||
      ho != (h + sh - 1) / sh || wo != (w + sw - 1) / sw || c % 8 || o % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc_tile<false>(bm, bn, stages, x, wk, z, part, n, h, w, c, o,
                               1, 1, sh, sw, 0, 0, ho, wo,
                               static_cast<cudaStream_t>(stream));
}

// The sweeps take the caller's layout: rb rows a block, vec channels a
// thread, blocks of tx x ty threads (see launch_sweep).
// stat [4, O] f32 rows (mean, rstd, scale, shift); y [R, O] in z's dtype.
extern "C" int conv_bn_apply_launch(const void* z, const void* stat, void* y,
                                    int rows, int o, int relu, int rb,
                                    int vec, int tx, int ty, int dtype,
                                    void* stream) {
  return sweep(0, z, nullptr, stat, nullptr, y, rows, o, relu, rb, vec, tx,
               ty, 0.f, dtype, stream);
}

// part [2, NB, O] f32 with NB = ceil(R / rb): per row block, dgamma and
// dbeta partials.
extern "C" int conv_bn_bwd_reduce_launch(const void* z, const void* g,
                                         const void* stat, void* part,
                                         int rows, int o, int relu, int rb,
                                         int vec, int tx, int ty, int dtype,
                                         void* stream) {
  return sweep(1, z, g, stat, nullptr, part, rows, o, relu, rb, vec, tx, ty,
               0.f, dtype, stream);
}

// tot [2, O] f32 rows (dgamma, dbeta); dz [R, O] in z's dtype; rcount = 1/R.
extern "C" int conv_bn_bwd_dz_launch(const void* z, const void* g,
                                     const void* stat, const void* tot,
                                     void* dz, int rows, int o, int relu,
                                     int rb, int vec, int tx, int ty,
                                     float rcount, int dtype, void* stream) {
  return sweep(2, z, g, stat, tot, dz, rows, o, relu, rb, vec, tx, ty,
               rcount, dtype, stream);
}
