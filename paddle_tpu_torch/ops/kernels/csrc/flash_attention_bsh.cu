// Flash attention over head-interleaved [B, S, H] tensors for Hopper
// (sm_90a): the forward, with dropout, and the backward.
//
// Forward.  Replaces the TPU kernel paddle_tpu/ops/pallas/
// flash_attention.py _make_fwd_bsh_kernel (launched by _flash_fwd_bsh).
// For batch b, head h (H = nh * D, head h owns columns [h*D, (h+1)*D) of
// every row) and query row i:
//
//     s[j]   = q[b,i,h] . k[b,j,h] * sm_scale + bias[b,j]   (-1e30 above
//              the diagonal when causal)
//     o[b,i,h] = sum_j softmax(s)[j] c[j] v[b,j,h]
//     lse[b,h,i] = m + log(max(l, 1e-30))
//
// with the online softmax of the TPU kernel: m starts at -1e30, each key
// tile updates m_new = max(m, max s), l = l*exp(m - m_new) + sum exp(s -
// m_new), acc = acc*exp(m - m_new) + (p c) v, and the output is acc /
// max(l, 1e-30).  sm_scale is folded into q when it is a power of two
// (prescale, as _prescale_ok decides), otherwise it multiplies the
// scores.  The optional bias is one f32 value per key ([B, 1, Skv]: the
// BERT padding mask).
//
// Dropout acts on the numerator only (l sums the undropped p, as in the
// TPU kernel): c = keep / keep_div (the helpers, shared with the [B, nh,
// S, D] kernels, are in flash_common.cuh).  The keep bit of (b, h, i, j) comes
// from one of two sources:
//   * an explicit uint8 mask [B, nh, Sq, Skv] (the TPU kernel's has_mask
//     path), keep_div = 1 - p;
//   * a counter-based Philox4x32-10 keyed by the 64-bit seed, at counter
//     (j, i / 4, b * nh + h, offset): word i % 4 of the result, low byte
//     below thresh = clamp(round((1 - p) * 256), 1, 256) keeps
//     (_dropout_quantized_thresh), keep_div = thresh / 256.  The bit is
//     a function of (seed, offset, b, h, i, j) alone, not of the tiling,
//     so the backward kernels regenerate it; the forward can also write
//     the bits it drew (a debug output, for the checks on the card).
//
// Backward.  Replaces _make_bwd_bsh_kernel (launched by _flash_bwd_bsh).
// With the forward's lse and delta = rowsum(dO * O) (computed by the
// wrapper, as _flash_bwd_bsh does outside its kernel):
//
//     p  = exp(s - lse),  dp = dO . v,  ds = p (dp c - delta) sm_scale
//     dv = sum_i (p c) dO,  dk = sum_i ds q,  dq = sum_j ds k
//
// with the prescale rule: when sm_scale is a power of two q is scaled on
// load, ds leaves sm_scale out (dk then carries it through q) and dq is
// scaled once at the end.  The TPU kernel accumulates dq in an output
// block resident across a sequential key grid; here key blocks run in
// parallel, so the backward is two kernels, each deterministic: one
// block per (key tile, head, batch) sums dk and dv over the query tiles,
// and one block per (query tile, head, batch) sums dq over the key tiles.
// Both recompute s and dp.  Causal tiles above the diagonal are skipped
// in all three kernels (_hi_blocks / _lo_blocks).
//
// Bound.  Forward 4*B*nh*Sq*Skv*D flops, backward 10*B*nh*Sq*Skv*D (half
// of each when causal), against the dtype's rate (989 TFLOP/s bf16, 67
// TFLOP/s f32), and the bytes of the inputs and outputs against 3.35
// TB/s; at BERT-base's shapes (S = 512, D = 64) the flops bound the f32
// forward and the backward, the bytes the bf16 forward.  The split
// backward does 7 products to the bound's 5 (S and dP in both kernels).
//
// The f32 forward on the SIMT cores (FFMA only: tensor cores would round
// f32 to TF32).  Bound: its 4 B nh Sq Skv D flops at 67 TFLOP/s (at the
// infer path's 8 x 512, 12 heads of 64: 6.44 GFLOP, 0.096 ms).  What
// keeps a SIMT kernel from that rate is feeding the FMA units: the SM's
// shared memory delivers 32 floats a clock to 128 FMA lanes, so an inner
// product that loads one float a thread for each two FMAs caps near half
// the rate; copies that run between barriers leave the units idle; and a
// grid that ends on a partial wave idles SMs at the end.  Design: one
// block of 256 threads owns BQ query rows of one head of one batch row (at
// D = 64, 128 rows: 384 blocks of one a SM at the infer shape, 2.9 waves)
// and streams BK = 128 keys a tile.  Each thread holds an 8 x 8 register
// tile of the scores (rows ty + 16 i, keys tx + 16 j) and one of the
// output (the same rows, columns 4 (tx % 8) + 32 g + e, summed over key
// half tx / 8 of every tile and added across the two halves' lanes at the
// end), and reads its operands from shared memory as float4s along the
// reduction (d for S, keys for P V): 16 float4 loads feed 256 FMAs, 4 FMAs
// a float, in padded rows that keep the loads free of bank conflicts.  K
// (with the key bias) and V arrive by 16-byte cp.async straight from the
// [B, S, H] rows (a head's D columns are contiguous), K of the next tile
// under this tile's P V and V of this tile under its S product, so a tile
// takes two barriers and every copy overlaps FMAs.  The online softmax
// reduces a row over the 16 lanes that hold it (xor shuffles).  Rows past
// Sq and keys past Skv of a ragged last tile are zero-filled and masked.
// Dropout draws each Philox counter once a lane pair (the two rows of one
// counter sit in lanes l and l ^ 16, which swap words).
//
// The f32 backward on the SIMT cores: one block of 256 threads owns one
// tile of T rows (T = 64, 32 at D = 256) of one head of one batch row, so
// B*nh*S/T blocks fill the 132 SMs, and streams the other operand in
// T-row tiles through shared memory, reading each head's D-column slice
// straight from the [B, S, H] rows: no head split or merge transposes.
// Thread (ty, tx) of a 16 x 16 grid holds rows ty*T/16 .. and columns tx
// + 16*j of every T x T score tile in registers; row sums reduce over the
// 16 lanes of a half-warp with xor shuffles.  Tile rows in shared memory
// are padded by one float, so 16 lanes reading 16 different rows hit 16
// banks.
//
// The bf16 forward on the tensor cores: row 6's forward body
// (flash_tc.cuh fwd_tc_tile, one warpgroup a 64-query tile, a 2-stage
// cp.async ring of K, V and the key bias, S = Q K^T on wgmma with the
// Philox draws under it, the online softmax in registers, p c rounded to
// bf16 as the A operand of O += (p c) V, as _make_fwd_bsh_kernel rounds
// p_num to v's dtype) at [B, S, H] rows, so p c is rounded relative to
// the running max of the 64-key tiles seen so far.
//
// The bf16 backward on the tensor cores (hopper_mma.cuh; the fragment
// helpers, shared with the [B, nh, S, D] kernels, in flash_tc.cuh): the
// same two kernels, deterministic, no atomics, with causal tile skipping, the
// per-key bias, the mask and the Philox bits of the forward.  One
// warpgroup owns a 64-row tile; every product is wgmma with bf16 operands
// and f32 accumulators in registers.  The dk/dv kernel (one block per key
// tile, head and batch, and per 128-column half of a D = 256 head) runs
// S^T = K Q^T and dP^T = V dO^T (A: the K and V tiles, B: the Q and dO
// tiles, both K-major in shared memory), forms p c and ds = p (dp c -
// delta) sm_scale in registers and rounds them to bf16, as the TPU kernel
// rounds p_num and ds: those rounded accumulators are the A operands, from
// registers, of dV += (p c)^T dO and dK += ds^T Q (B: the same dO and Q
// tiles read MN-major), with no round trip through shared memory.  Query
// tiles (BQ = 64 rows, 32 at D >= 128, for registers) stream through a
// 2-stage cp.async ring, the next tile's copies overlapping this tile's
// products.  The dq kernel mirrors it over key tiles: S = Q K^T, dP = dO
// V^T, dQ += ds K.  sm_scale multiplies the scores and ds; with a power of
// two that is bit for bit the prescale rule's result, so the kernels
// need no second path.  The Philox bits: a counter (key, query / 4)
// yields the words of 4 consecutive queries, which the accumulator layout
// spreads over lanes; the lanes holding one counter's queries draw one
// counter each and exchange the words by shuffles (drop_keys_by_queries,
// drop_queries_by_keys), so every word drawn is used.  f32 stays on the
// SIMT kernels above: tensor cores would round it to TF32.
//
// C interface (ctypes): flash_attention_bsh_launch (f32) and
// flash_attention_bsh_fwd_tc_launch (bf16), flash_attention_bsh_bwd_launch
// (f32) and flash_attention_bsh_bwd_tc_launch (bf16) return
// cudaGetLastError() after the launch (the first failing one).  The
// kernels run on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16

// ---------------------------------------------------------------------------
// forward, f32 (SIMT)
// ---------------------------------------------------------------------------

// Tiles of the f32 forward by head dim: BQ query rows and BK keys a block.
// Thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 i (i < BQ / 16)
// of the BQ x BK scores, keys tx + 16 j (j < BK / 16), and the same rows of
// the BQ x D output, columns 4 (tx % 8) + 32 g + e (g < D / 32, e < 4),
// summed over key half tx / 8 of every tile: at D = 64 an 8 x 8 tile of S
// and one of O.
template <int D> struct SimtTile;
template <> struct SimtTile<64> { static constexpr int BQ = 128, BK = 128; };
template <> struct SimtTile<128> { static constexpr int BQ = 64, BK = 128; };
template <> struct SimtTile<256> { static constexpr int BQ = 32, BK = 64; };

// Shared memory of the f32 forward, offsets in floats.  Q and K rows are
// padded to D + 4 floats, so consecutive rows start in consecutive 16-byte
// bank groups and the float4 loads along d of a warp (2 rows of Q, 16 of
// K) take the fewest wavefronts; a P row holds key half 0 at 0 and half 1
// at BK / 2 + 4 in BK + 8 floats, so the 2 rows x 2 halves a warp reads at
// once fall in 4 different bank groups.
template <int D>
struct SimtSmem {
  static constexpr int BQ = SimtTile<D>::BQ, BK = SimtTile<D>::BK;
  static constexpr int DP = D + 4;
  static constexpr int PP = BK + 8;
  static constexpr int HOFF = BK / 2 + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * DP;
  static constexpr int V = K + BK * DP;
  static constexpr int P = V + BK * D;
  static constexpr int BIAS = P + BQ * PP;
  static constexpr int BYTES = (BIAS + BK) * 4;
};

// cp.async rows k0 .. k0 + BK of one head's D columns ([B, S, H] rows hs
// floats apart) into shared memory at dst, rows `stride` floats apart;
// rows at or past skv are zero-filled
template <int D, int BK>
__device__ __forceinline__ void fwd_tile_async(uint32_t dst,
                                               const float* src, int64_t hs,
                                               int k0, int skv, int stride) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < BK * C4; idx += kThreads) {
    const int r = idx / C4, c = idx % C4;
    const bool ok = k0 + r < skv;
    cp_async16(dst + (r * stride + 4 * c) * 4,
               src + (int64_t)(ok ? k0 + r : 0) * hs + 4 * c, ok);
  }
}
template <int BK>
__device__ __forceinline__ void fwd_bias_async(uint32_t dst,
                                               const float* src, int k0,
                                               int skv) {
  for (int idx = threadIdx.x; idx < BK / 4; idx += kThreads) {
    const bool ok = k0 + 4 * idx < skv;
    cp_async16(dst + 16 * idx, src + (ok ? k0 + 4 * idx : 0), ok);
  }
}

// The dropout multipliers c of a thread's CN scores of one row (keys col0
// + 16 j): keep / keep_div, or 0.  A Philox counter (key, row / 4) gives
// the words of 4 rows; this row and row ^ 1 (lanes l and l ^ 16) share
// it, so each of the two lanes draws every other key's counter and they
// swap the word the other needs.  Writes the bits it drew to bits_out,
// under causal only in the 64 x 64 tiles on or below the diagonal (the
// tiles every forward of the port visits, whatever its own tiling).
template <int CN>
__device__ __forceinline__ void fwd_keep(const Dropout& dr, int bh, int sq,
                                         int skv, int causal, int row,
                                         int col0, float (&c)[CN]) {
  const int64_t at0 = ((int64_t)bh * sq + row) * skv;
  const bool in_row = row < sq;
  if (dr.mode == kMaskDrop) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = col0 + 16 * j;
      c[j] = in_row && col < skv && dr.mask[at0 + col] ? dr.inv_keep : 0.f;
    }
    return;
  }
  const bool odd = row & 1;
#pragma unroll
  for (int jj = 0; jj < CN / 2; ++jj) {
    const uint4 r = philox(make_uint4(col0 + 16 * (2 * jj + (odd ? 1 : 0)),
                                      row >> 2, bh, dr.offset),
                           dr.key0, dr.key1);
    const uint32_t own = word_of(r, row);
    const uint32_t other =
        __shfl_xor_sync(0xffffffffu, word_of(r, row ^ 1), 16);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * jj + e;
      const bool keep = ((e == (odd ? 1 : 0) ? own : other) & 0xFFu) <
                        dr.thresh;
      c[j] = keep ? dr.inv_keep : 0.f;
      const int col = col0 + 16 * j;
      if (dr.bits_out && in_row && col < skv &&
          !(causal && (col >> 6) > (row >> 6)))
        dr.bits_out[at0 + col] = keep ? 1 : 0;
    }
  }
}

// DROP: dropout compiled in (the no-dropout instantiation, the infer
// path's, carries none of its registers or branches)
template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bsh_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int nh,
                     float sm_scale, int prescale, int causal, Dropout dr) {
  using L = SimtSmem<D>;
  constexpr int BQ = L::BQ, BK = L::BK, DP = L::DP, PP = L::PP;
  constexpr int RM = BQ / 16;  // rows a thread, of S and of O
  constexpr int CN = BK / 16;  // keys a thread, of S
  constexpr int DG = D / 32;   // float4 column groups a thread, of O
  constexpr int HALF = BK / 2;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::Q;     // [BQ][DP], scaled
  float* ks = smem + L::K;     // [BK][DP]
  float* vs = smem + L::V;     // [BK][D]
  float* ps = smem + L::P;     // [BQ][PP]
  float* bs = smem + L::BIAS;  // [BK]

  // the query tiles in reverse: under causal the longest rows start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const int64_t hs = (int64_t)nh * D;  // between rows of [B, S, H]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int half = tx >> 3;  // the key half this thread sums into O
  const int cx = tx & 7;

  const float* __restrict__ qb = q + (int64_t)b * sq * hs + h * D;
  const float* __restrict__ kb = k + (int64_t)b * skv * hs + h * D;
  const float* __restrict__ vb = v + (int64_t)b * skv * hs + h * D;
  const float* __restrict__ biasb = bias ? bias + (int64_t)b * skv : nullptr;
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs), bs_u = smem_u32(bs);

  int nk = (skv + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  fwd_tile_async<D, BK>(ks_u, kb, hs, 0, skv, DP);
  if (biasb) fwd_bias_async<BK>(bs_u, biasb, 0, skv);
  cp_async_commit();

  // q * sm_scale is exact when sm_scale is a power of two
  const float qmul = prescale ? sm_scale : 1.f;
  const float smul = prescale ? 1.f : sm_scale;
  for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq)
      t = *reinterpret_cast<const float4*>(qb + (int64_t)(q0 + r) * hs +
                                           4 * c);
    t.x *= qmul; t.y *= qmul; t.z *= qmul; t.w *= qmul;
    *reinterpret_cast<float4*>(qs + r * DP + 4 * c) = t;
  }

  float m[RM], l[RM], acc[RM][DG][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    cp_async_wait<0>();
    __syncthreads();  // K and bias of tile t are in; V and P are free
    fwd_tile_async<D, BK>(vs_u, vb, hs, k0, skv, D);  // under S and softmax
    cp_async_commit();

    // S = Q K^T: per 4 columns of d, RM + CN float4 loads for 4 RM CN FMAs
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // the online softmax of each row over the 16 lanes that hold it
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * smul;
        if (biasb) x += bs[tx + 16 * j];
        if (causal && col > row) x = kNegInf;
        if (col >= skv) x = -INFINITY;  // a ragged last tile
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float cm[CN];
      if (DROP) fwd_keep<CN>(dr, bh, sq, skv, causal, row, k0 + tx, cm);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = DROP ? p * cm[j] : p;  // dropout: the numerator only
        rsum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < DG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < CN; ++j)
        ps[(ty + 16 * i) * PP + tx + 16 * j + (j < CN / 2 ? 0 : 4)] = s[i][j];
    }

    cp_async_wait<0>();
    __syncthreads();  // V of tile t is in, P is written; K and bias are free
    if (t + 1 < nk) {  // under P V
      fwd_tile_async<D, BK>(ks_u, kb, hs, k0 + BK, skv, DP);
      if (biasb) fwd_bias_async<BK>(bs_u, biasb, k0 + BK, skv);
      cp_async_commit();
    }

    // O += P V over this thread's key half: per 4 keys, RM + 4 DG float4
    // loads for 4 RM 4 DG FMAs
    const float* __restrict__ pp = ps + ty * PP + half * L::HOFF;
    const float* __restrict__ vp = vs + half * HALF * D + 4 * cx;
#pragma unroll 1
    for (int kk = 0; kk < HALF; kk += 4) {
      float pv[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(pp + 16 * i * PP + kk);
        pv[i][0] = t4.x; pv[i][1] = t4.y; pv[i][2] = t4.z; pv[i][3] = t4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[DG];
#pragma unroll
        for (int g = 0; g < DG; ++g)
          vv[g] = *reinterpret_cast<const float4*>(vp + (kk + e) * D + 32 * g);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int g = 0; g < DG; ++g) {
            acc[i][g][0] = fmaf(pv[i][e], vv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pv[i][e], vv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pv[i][e], vv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pv[i][e], vv[g].w, acc[i][g][3]);
          }
      }
    }
  }

  // the two key halves' sums (lanes tx and tx ^ 8); each half stores half
  // of the rows
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][g][e] += __shfl_xor_sync(0xffffffffu, acc[i][g][e], 8);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    if (row < sq && (i < RM / 2) == (half == 0)) {
      float* __restrict__ orow =
          o + ((int64_t)b * sq + row) * hs + h * D + 4 * cx;
#pragma unroll
      for (int g = 0; g < DG; ++g)
        *reinterpret_cast<float4*>(orow + 32 * g) =
            make_float4(acc[i][g][0] / l_safe, acc[i][g][1] / l_safe,
                        acc[i][g][2] / l_safe, acc[i][g][3] / l_safe);
    }
    if (tx == 0 && row < sq) lse[(int64_t)bh * sq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, Skv] or null
  const float* lse;    // [B, nh, Sq]
  const float* delta;  // [B, nh, Sq]
  const void* dout;    // [B, Sq, H]
  void* dq;
  void* dk;
  void* dv;
  int sq, skv, nh;
  float sm_scale;
  int prescale, causal;
  // the wgmma kernels' check outputs, bf16 [B, nh, Sq, Skv] or null: the
  // rounded p c and ds of the dk/dv kernel and the ds of the dq kernel
  void* p_out;
  void* ds_out;
  void* dsq_out;
};

// Load a T x D tile of rows r0.. of one head into shared memory (row
// stride D + 1), times mul.
template <typename T, int TT, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t hstride, float mul) {
  for (int idx = threadIdx.x; idx < TT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = to_float(src[r * hstride + c]) * mul;
  }
}

// The thread's R x R scores of a T x T tile: s = a_r . b_c over D, a and
// b tiles in shared memory (rows ty*R + i, columns tx + 16*j).
template <int TT, int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         float (&s)[TT / 16][TT / 16]) {
  constexpr int R = TT / 16;
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty * R + i) * DP + d];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// p (times c) and ds of the thread's scores of the tile (q0, k0), from
// s = q . k (q prescaled or not) and dp = dO . v; written to shared
// memory (row stride T + 1).  ps may be null (the dq kernel).
template <int TT>
__device__ __forceinline__ void tile_probs(const BwdArgs& a, const Dropout& dr,
                                           int b, int h, int q0, int k0,
                                           const float (&s)[TT / 16][TT / 16],
                                           const float (&dp)[TT / 16][TT / 16],
                                           const float* lse_s,
                                           const float* delta_s, float* ps,
                                           float* dss) {
  constexpr int R = TT / 16;
  constexpr int TP = TT + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = b * a.nh + h;
  const float smul = a.prescale ? 1.f : a.sm_scale;
  const float* __restrict__ biasb =
      a.bias ? a.bias + (int64_t)b * a.skv : nullptr;
  float cm[R][R];
  dropout_scale<R, R>(dr, bh, a.sq, a.skv, q0 + ty * R, k0 + tx, cm, false);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rl = ty * R + i;
    const int row = q0 + rl;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int cl = tx + 16 * j;
      const int col = k0 + cl;
      float x = s[i][j] * smul;
      if (biasb) x += biasb[col];
      if (a.causal && col > row) x = kNegInf;
      const float p = expf(x - lse_s[rl]);
      if (ps) ps[rl * TP + cl] = p * cm[i][j];
      dss[rl * TP + cl] = p * (dp[i][j] * cm[i][j] - delta_s[rl]) * smul;
    }
  }
}

template <int TT, int D>
constexpr int dkv_smem_floats() {
  return 4 * TT * (D + 1) + 2 * TT * (TT + 1) + 2 * TT;
}

// dk, dv of one (key tile, head, batch): sum over the query tiles.
template <typename T, int TT, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(BwdArgs a, Dropout dr) {
  constexpr int R = TT / 16;
  constexpr int DP = D + 1;
  constexpr int TP = TT + 1;
  constexpr int ND = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [TT][DP]
  float* vs = ks + TT * DP;      // [TT][DP]
  float* qs = vs + TT * DP;      // [TT][DP]
  float* dos = qs + TT * DP;     // [TT][DP]
  float* ps = dos + TT * DP;     // [TT][TP]
  float* dss = ps + TT * TP;     // [TT][TP]
  float* lse_s = dss + TT * TP;  // [TT]
  float* delta_s = lse_s + TT;   // [TT]

  const int k0 = blockIdx.x * TT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t hstride = (int64_t)a.nh * D;
  const int64_t stat0 = ((int64_t)b * a.nh + h) * a.sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* __restrict__ qb =
      static_cast<const T*>(a.q) + (int64_t)b * a.sq * hstride + h * D;
  const T* __restrict__ dob =
      static_cast<const T*>(a.dout) + (int64_t)b * a.sq * hstride + h * D;
  const int64_t kofs = ((int64_t)b * a.skv + k0) * hstride + h * D;
  const float qmul = a.prescale ? a.sm_scale : 1.f;

  load_tile<T, TT, D>(ks, static_cast<const T*>(a.k) + kofs, hstride, 1.f);
  load_tile<T, TT, D>(vs, static_cast<const T*>(a.v) + kofs, hstride, 1.f);

  float dk[R][ND], dv[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dk[i][jd] = dv[i][jd] = 0.f;

  const int nq = a.sq / TT;
  const int lo = a.causal ? k0 / TT : 0;
  for (int t = lo; t < nq; ++t) {
    const int q0 = t * TT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TT, D>(qs, qb + (int64_t)q0 * hstride, hstride, qmul);
    load_tile<T, TT, D>(dos, dob + (int64_t)q0 * hstride, hstride, 1.f);
    for (int r = threadIdx.x; r < TT; r += kThreads) {
      lse_s[r] = a.lse[stat0 + q0 + r];
      delta_s[r] = a.delta[stat0 + q0 + r];
    }
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<TT, D>(qs, ks, s);
    tile_dot<TT, D>(dos, vs, dp);
    tile_probs<TT>(a, dr, b, h, q0, k0, s, dp, lse_s, delta_s, ps, dss);
    __syncthreads();
    // dv[c] += sum_r p[r][c] dO[r];  dk[c] += sum_r ds[r][c] q[r]
#pragma unroll 4
    for (int r = 0; r < TT; ++r) {
      float pv[R], dsv[R], dov[ND], qv[ND];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = ps[r * TP + ty * R + i];
        dsv[i] = dss[r * TP + ty * R + i];
      }
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        dov[jd] = dos[r * DP + tx + 16 * jd];
        qv[jd] = qs[r * DP + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          dv[i][jd] = fmaf(pv[i], dov[jd], dv[i][jd]);
          dk[i][jd] = fmaf(dsv[i], qv[jd], dk[i][jd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t at = kofs + (int64_t)(ty * R + i) * hstride;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      store(static_cast<T*>(a.dk) + at + tx + 16 * jd, dk[i][jd]);
      store(static_cast<T*>(a.dv) + at + tx + 16 * jd, dv[i][jd]);
    }
  }
}

template <int TT, int D>
constexpr int dq_smem_floats() {
  return 4 * TT * (D + 1) + TT * (TT + 1) + 2 * TT;
}

// dq of one (query tile, head, batch): sum over the key tiles.
template <typename T, int TT, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(BwdArgs a, Dropout dr) {
  constexpr int R = TT / 16;
  constexpr int DP = D + 1;
  constexpr int TP = TT + 1;
  constexpr int ND = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [TT][DP]
  float* dos = qs + TT * DP;     // [TT][DP]
  float* ks = dos + TT * DP;     // [TT][DP]
  float* vs = ks + TT * DP;      // [TT][DP]
  float* dss = vs + TT * DP;     // [TT][TP]
  float* lse_s = dss + TT * TP;  // [TT]
  float* delta_s = lse_s + TT;   // [TT]

  const int q0 = blockIdx.x * TT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t hstride = (int64_t)a.nh * D;
  const int64_t stat0 = ((int64_t)b * a.nh + h) * a.sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t qofs = ((int64_t)b * a.sq + q0) * hstride + h * D;
  const T* __restrict__ kb =
      static_cast<const T*>(a.k) + (int64_t)b * a.skv * hstride + h * D;
  const T* __restrict__ vb =
      static_cast<const T*>(a.v) + (int64_t)b * a.skv * hstride + h * D;

  load_tile<T, TT, D>(qs, static_cast<const T*>(a.q) + qofs, hstride,
                      a.prescale ? a.sm_scale : 1.f);
  load_tile<T, TT, D>(dos, static_cast<const T*>(a.dout) + qofs, hstride,
                      1.f);
  for (int r = threadIdx.x; r < TT; r += kThreads) {
    lse_s[r] = a.lse[stat0 + q0 + r];
    delta_s[r] = a.delta[stat0 + q0 + r];
  }

  float dq[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dq[i][jd] = 0.f;

  int nk = a.skv / TT;
  if (a.causal) nk = min(nk, (q0 + TT + TT - 1) / TT);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * TT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TT, D>(ks, kb + (int64_t)k0 * hstride, hstride, 1.f);
    load_tile<T, TT, D>(vs, vb + (int64_t)k0 * hstride, hstride, 1.f);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<TT, D>(qs, ks, s);
    tile_dot<TT, D>(dos, vs, dp);
    tile_probs<TT>(a, dr, b, h, q0, k0, s, dp, lse_s, delta_s, nullptr, dss);
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]
#pragma unroll 4
    for (int c = 0; c < TT; ++c) {
      float dsv[R], kv[ND];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty * R + i) * TP + c];
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) kv[jd] = ks[c * DP + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < ND; ++jd)
          dq[i][jd] = fmaf(dsv[i], kv[jd], dq[i][jd]);
    }
  }

  // prescale: ds left sm_scale out; apply it once here
  const float dqmul = a.prescale ? a.sm_scale : 1.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t at = qofs + (int64_t)(ty * R + i) * hstride;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store(static_cast<T*>(a.dq) + at + tx + 16 * jd, dq[i][jd] * dqmul);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D, bool DROP>
int launch_fwd_drop(const void* q, const void* k, const void* v,
                    const void* bias, void* o, void* lse, int batch, int sq,
                    int skv, int nh, float sm_scale, int prescale, int causal,
                    const Dropout& dr, cudaStream_t stream) {
  using L = SimtSmem<D>;
  static const cudaError_t attr =
      allow_smem(flash_fwd_bsh_kernel<D, DROP>, L::BYTES);  // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (sq % 64 != 0 || skv % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sq + L::BQ - 1) / L::BQ, nh, batch);
  flash_fwd_bsh_kernel<D, DROP><<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), sq, skv, nh,
      sm_scale, prescale, causal, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* o, void* lse, int batch, int sq, int skv, int nh,
               float sm_scale, int prescale, int causal, const Dropout& dr,
               cudaStream_t stream) {
  if (dr.mode == kNoDrop)
    return launch_fwd_drop<D, false>(q, k, v, bias, o, lse, batch, sq, skv,
                                     nh, sm_scale, prescale, causal, dr,
                                     stream);
  return launch_fwd_drop<D, true>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                                  sm_scale, prescale, causal, dr, stream);
}

int launch_fwd_d(int head_dim, const void* q, const void* k, const void* v,
                 const void* bias, void* o, void* lse, int batch, int sq,
                 int skv, int nh, float sm_scale, int prescale, int causal,
                 const Dropout& dr, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                            sm_scale, prescale, causal, dr, stream);
    case 128:
      return launch_fwd<128>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                             sm_scale, prescale, causal, dr, stream);
    case 256:
      return launch_fwd<256>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                             sm_scale, prescale, causal, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int TT, int D>
int launch_bwd(const BwdArgs& a, const Dropout& dr, int batch,
               cudaStream_t stream) {
  constexpr int kDkv = dkv_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  constexpr int kDq = dq_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  static const cudaError_t attr_dkv =
      allow_smem(flash_bwd_dkv_kernel<T, TT, D>, kDkv);
  static const cudaError_t attr_dq =
      allow_smem(flash_bwd_dq_kernel<T, TT, D>, kDq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (a.sq % TT != 0 || a.skv % TT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_kernel<T, TT, D>
      <<<dim3(a.skv / TT, a.nh, batch), kThreads, kDkv, stream>>>(a, dr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<T, TT, D>
      <<<dim3(a.sq / TT, a.nh, batch), kThreads, kDq, stream>>>(a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_d(int head_dim, const BwdArgs& a, const Dropout& dr, int batch,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_bwd<T, 64, 64>(a, dr, batch, stream);
    case 128:
      return launch_bwd<T, 64, 128>(a, dr, batch, stream);
    case 256:
      return launch_bwd<T, 32, 256>(a, dr, batch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (bf16)
// ---------------------------------------------------------------------------

struct FwdArgs {
  const __nv_bfloat16* q;  // [B, Sq, H]
  const __nv_bfloat16* k;  // [B, Skv, H]
  const __nv_bfloat16* v;
  const float* bias;       // [B, Skv] or null
  __nv_bfloat16* o;        // [B, Sq, H]
  float* lse;              // [B, nh, Sq]
  __nv_bfloat16* p_out;    // check outputs (null on the training path):
  float* m_out;            // [B, nh, Sq, Skv] and [B, nh, Sq, Skv / 64]
  int sq, skv, nh, causal;
  float sm_scale;
};

// Row 4: o and lse of one (64-query tile, head, batch, DO-column slice
// of the head), the forward body of flash_tc.cuh (fwd_tc_tile) at [B, S,
// H] rows: each row's D values of head h are contiguous, so the tiles
// land as 16-byte copies with no head split or merge.  Causal (Sq ==
// Skv) is top-left, its key tiles past the diagonal skipped.  sm_scale
// multiplies the scores: with a power of two that is bit for bit the
// prescale rule's q * sm_scale.
template <int D, int DO, int BMODE>
__global__ void __launch_bounds__(128)
flash_fwd_bsh_tc_kernel(FwdArgs a, Dropout dr) {
  const int q0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y, dsplit = blockIdx.z;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int64_t hs = (int64_t)a.nh * D;
  const int64_t qofs = ((int64_t)b * a.sq + q0) * hs + h * D;
  const int64_t kofs = (int64_t)b * a.skv * hs + h * D;
  FwdTile f;
  f.q = a.q + qofs;
  f.k = a.k + kofs;
  f.v = a.v + kofs + dsplit * DO;
  f.o = a.o + qofs + dsplit * DO;
  f.rs = hs;
  f.bias = BMODE == kKeyBias ? a.bias + (int64_t)b * a.skv : nullptr;
  f.lse = a.lse + (int64_t)bh * a.sq + q0;
  f.p_out = a.p_out;
  f.m_out = a.m_out;
  f.bh = bh;
  f.sq = a.sq;
  f.skv = a.skv;
  f.q0 = q0;
  f.nk = a.causal ? min(a.skv, q0 + kTcRows) / kTcRows : a.skv / kTcRows;
  f.causal = a.causal;
  f.q_off = f.k_off = 0;
  f.sm_scale = a.sm_scale;
  f.checks = dsplit == 0;
  fwd_tc_tile<D, DO, BMODE, float>(f, dr);
}

template <int D, int DO, int BMODE>
int launch_fwd_tc(const FwdArgs& a, const Dropout& dr, int batch,
                  cudaStream_t stream) {
  constexpr int kSmem = fwd_tc_smem_bytes<D, DO, BMODE, float>();
  static const cudaError_t attr =
      allow_smem(flash_fwd_bsh_tc_kernel<D, DO, BMODE>, kSmem);  // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.sq % kTcRows != 0 || a.skv % kTcRows != 0 ||
      (int64_t)batch * a.nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_bsh_tc_kernel<D, DO, BMODE>
      <<<dim3(a.sq / kTcRows, batch * a.nh, D / DO), 128, kSmem, stream>>>(
          a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DO>
int launch_fwd_tc_bias(const FwdArgs& a, const Dropout& dr, int batch,
                       cudaStream_t stream) {
  if (a.bias) return launch_fwd_tc<D, DO, kKeyBias>(a, dr, batch, stream);
  return launch_fwd_tc<D, DO, kNoBias>(a, dr, batch, stream);
}

// D 256 in two 128-column slices (grid z), each recomputing S: 64 O
// accumulators a thread at most (row 6's split)
int launch_fwd_tc_d(int head_dim, const FwdArgs& a, const Dropout& dr,
                    int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_fwd_tc_bias<64, 64>(a, dr, batch, stream);
    case 128:
      return launch_fwd_tc_bias<128, 128>(a, dr, batch, stream);
    case 256:
      return launch_fwd_tc_bias<256, 128>(a, dr, batch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// backward on the tensor cores (bf16)
// ---------------------------------------------------------------------------

template <int D, int BQ>
constexpr int dkv_tc_smem_bytes() {
  return 2 * kTcRows * D * 2 + 2 * 2 * BQ * D * 2 + 2 * 2 * BQ * 4 + 1024;
}

// dk, dv of one (64-key tile, head, DO-column slice of the head, batch):
// one warpgroup; the query tiles (BQ rows of q and dO, their lse and
// delta) stream through a 2-stage cp.async ring.  Per query tile:
//   S^T  = K . Q^T and dP^T = V . dO^T   (A: K, V; B: Q, dO; K-major)
//   p c, ds in registers, rounded to bf16: the A operands of
//   dV  += (p c)^T . dO and dK += ds^T . Q  (B: dO, Q; MN-major)
template <int D, int BQ, int DO>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_tc_kernel(BwdArgs a, Dropout dr) {
  constexpr int NSPLIT = D / DO;
  constexpr int KV_BYTES = kTcRows * D * 2;
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int NB = BQ / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t ks = raw + pad, vs = ks + KV_BYTES;
  const uint32_t qs0 = vs + KV_BYTES;  // stage st: Q at qs0 + st * 2 * Q_BYTES,
                                       // dO Q_BYTES after it
  float* stat_s = reinterpret_cast<float*>(smem_raw + pad + 2 * KV_BYTES +
                                           4 * Q_BYTES);  // [2][lse, delta][BQ]

  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y / NSPLIT, dsplit = blockIdx.y % NSPLIT;
  const int b = blockIdx.z;
  const int bh = b * a.nh + h;
  const int64_t hs = (int64_t)a.nh * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            (int64_t)b * a.sq * hs + h * D;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) +
                             (int64_t)b * a.sq * hs + h * D;
  const int64_t kofs = ((int64_t)b * a.skv + k0) * hs + h * D;
  const float* lseb = a.lse + (int64_t)bh * a.sq;
  const float* deltab = a.delta + (int64_t)bh * a.sq;
  const int nq = a.sq / BQ;
  const int lo = a.causal ? k0 / BQ : 0;

  auto load_q = [&](int qt, int st) {
    const uint32_t qd = qs0 + st * 2 * Q_BYTES;
    tile_async<BQ, D>(qd, qb + (int64_t)qt * BQ * hs, hs);
    tile_async<BQ, D>(qd + Q_BYTES, dob + (int64_t)qt * BQ * hs, hs);
    const uint32_t sd = smem_u32(stat_s + st * 2 * BQ);
    if (tid < BQ / 4)
      cp_async16(sd + tid * 16, lseb + qt * BQ + tid * 4, true);
    else if (tid < BQ / 2)
      cp_async16(sd + BQ * 4 + (tid - BQ / 4) * 16,
                 deltab + qt * BQ + (tid - BQ / 4) * 4, true);
  };

  tile_async<kTcRows, D>(ks, static_cast<const __nv_bfloat16*>(a.k) + kofs,
                         hs);
  tile_async<kTcRows, D>(vs, static_cast<const __nv_bfloat16*>(a.v) + kofs,
                         hs);
  if (lo < nq) load_q(lo, 0);
  cp_async_commit();

  const int kr0 = 16 * warp + g;  // this thread's key rows kr0, kr0 + 8
  const float* biasb = a.bias ? a.bias + (int64_t)b * a.skv + k0 : nullptr;
  const float bias0 = biasb ? biasb[kr0] : 0.f;
  const float bias1 = biasb ? biasb[kr0 + 8] : 0.f;
  const float scale = a.sm_scale;

  float dk[DO / 64][32], dv[DO / 64][32];
#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) {
    zero(dk[cb]);
    zero(dv[cb]);
  }

  for (int qt = lo; qt < nq; ++qt) {
    const int st = (qt - lo) & 1;
    cp_async_wait<0>();  // this tile (and, first, K and V) has landed
    fence_async_smem();
    __syncthreads();     // for every thread; the other stage is free
    if (qt + 1 < nq) load_q(qt + 1, st ^ 1);
    cp_async_commit();

    const uint32_t qd = qs0 + st * 2 * Q_BYTES, dod = qd + Q_BYTES;
    const float* lse_s = stat_s + st * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    float sacc[BQ / 2], dpacc[BQ / 2];
    zero(sacc);
    zero(dpacc);
    fence_regs(sacc);
    fence_regs(dpacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk >> 2) * (kTcRows * 128) + (kk & 3) * 32;
      const uint32_t qo = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      wgmma_ss<BQ, 0>(sacc, desc_sw128(ks + ko), desc_sw128(qd + qo));
      wgmma_ss<BQ, 0>(dpacc, desc_sw128(vs + ko), desc_sw128(dod + qo));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);

    const int q0 = qt * BQ;
    float cm[BQ / 2];
    drop_keys_by_queries<NB>(dr, bh, a.sq, a.skv, k0 + kr0, q0, cm);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int kr = kr0 + ((e & 2) ? 8 : 0);
        const int qc = 8 * i + 2 * t + (e & 1);
        float x = sacc[idx] * scale + ((e & 2) ? bias1 : bias0);
        if (a.causal && k0 + kr > q0 + qc) x = kNegInf;
        const float p = expf(x - lse_s[qc]);
        sacc[idx] = p * cm[idx];                                   // p c
        dpacc[idx] = p * (dpacc[idx] * cm[idx] - delta_s[qc]) * scale;  // ds
        if (a.p_out) {
          const int64_t at = ((int64_t)bh * a.sq + q0 + qc) * a.skv + k0 + kr;
          static_cast<__nv_bfloat16*>(a.p_out)[at] =
              __float2bfloat16_rn(sacc[idx]);
          static_cast<__nv_bfloat16*>(a.ds_out)[at] =
              __float2bfloat16_rn(dpacc[idx]);
        }
      }

#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) {
      fence_regs(dk[cb]);
      fence_regs(dv[cb]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_frag(sacc, kk, pa);
      a_frag(dpacc, kk, da);
#pragma unroll
      for (int cb = 0; cb < DO / 64; ++cb) {
        const uint32_t off =
            (dsplit * (DO / 64) + cb) * (BQ * 128) + kk * 16 * 128;
        wgmma_rs_n64<1>(dv[cb], pa, desc_sw128(dod + off));
        wgmma_rs_n64<1>(dk[cb], da, desc_sw128(qd + off));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) {
      fence_regs(dk[cb]);
      fence_regs(dv[cb]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) {
    const int64_t at = kofs + dsplit * DO + cb * 64;
    store_frag(static_cast<__nv_bfloat16*>(a.dk) + at, hs, dk[cb]);
    store_frag(static_cast<__nv_bfloat16*>(a.dv) + at, hs, dv[cb]);
  }
}

template <int D>
constexpr int dq_tc_smem_bytes() {
  return 2 * kTcRows * D * 2 + 2 * 2 * kTcRows * D * 2 + 2 * kTcRows * 4 +
         1024;
}

// dq of one (64-query tile, head, DO-column slice, batch): one warpgroup;
// the key tiles (64 rows of k and v, their bias) stream through a 2-stage
// cp.async ring.  Per key tile: S = Q . K^T, dP = dO . V^T (K-major), ds
// in registers rounded to bf16, dQ += ds . K (B: K, MN-major).
template <int D, int DO>
__global__ void __launch_bounds__(128)
flash_bwd_dq_tc_kernel(BwdArgs a, Dropout dr) {
  constexpr int NSPLIT = D / DO;
  constexpr int T_BYTES = kTcRows * D * 2;
  constexpr int NB = kTcRows / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t qs = raw + pad, dos = qs + T_BYTES;
  const uint32_t kv0 = dos + T_BYTES;  // stage st: K at kv0 + st * 2 * T_BYTES,
                                       // V T_BYTES after it
  float* bias_s = reinterpret_cast<float*>(smem_raw + pad + 6 * T_BYTES);

  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y / NSPLIT, dsplit = blockIdx.y % NSPLIT;
  const int b = blockIdx.z;
  const int bh = b * a.nh + h;
  const int64_t hs = (int64_t)a.nh * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t qofs = ((int64_t)b * a.sq + q0) * hs + h * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            (int64_t)b * a.skv * hs + h * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            (int64_t)b * a.skv * hs + h * D;
  const float* biasb = a.bias ? a.bias + (int64_t)b * a.skv : nullptr;
  int nk = a.skv / kTcRows;
  if (a.causal) nk = min(nk, (q0 + 2 * kTcRows - 1) / kTcRows);

  auto load_kv = [&](int kt, int st) {
    const uint32_t kd = kv0 + st * 2 * T_BYTES;
    tile_async<kTcRows, D>(kd, kb + (int64_t)kt * kTcRows * hs, hs);
    tile_async<kTcRows, D>(kd + T_BYTES, vb + (int64_t)kt * kTcRows * hs, hs);
    if (biasb && tid < kTcRows / 4)
      cp_async16(smem_u32(bias_s + st * kTcRows) + tid * 16,
                 biasb + kt * kTcRows + tid * 4, true);
  };

  tile_async<kTcRows, D>(qs, static_cast<const __nv_bfloat16*>(a.q) + qofs,
                         hs);
  tile_async<kTcRows, D>(dos,
                         static_cast<const __nv_bfloat16*>(a.dout) + qofs, hs);
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  const int qr0 = 16 * warp + g;  // this thread's query rows qr0, qr0 + 8
  const int64_t stat0 = (int64_t)bh * a.sq + q0;
  const float lse0 = a.lse[stat0 + qr0], lse1 = a.lse[stat0 + qr0 + 8];
  const float dl0 = a.delta[stat0 + qr0], dl1 = a.delta[stat0 + qr0 + 8];
  const float scale = a.sm_scale;

  float dq[DO / 64][32];
#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) zero(dq[cb]);

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (kt + 1 < nk) load_kv(kt + 1, st ^ 1);
    cp_async_commit();

    const uint32_t kd = kv0 + st * 2 * T_BYTES, vd = kd + T_BYTES;
    const float* bias_t = bias_s + st * kTcRows;
    float sacc[32], dpacc[32];
    zero(sacc);
    zero(dpacc);
    fence_regs(sacc);
    fence_regs(dpacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kTcRows * 128) + (kk & 3) * 32;
      wgmma_ss<64, 0>(sacc, desc_sw128(qs + off), desc_sw128(kd + off));
      wgmma_ss<64, 0>(dpacc, desc_sw128(dos + off), desc_sw128(vd + off));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);

    const int k0 = kt * kTcRows;
    float cm[32];
    drop_queries_by_keys<NB>(dr, bh, a.sq, a.skv, q0 + qr0, k0, cm);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int qr = qr0 + ((e & 2) ? 8 : 0);
        const int kc = 8 * i + 2 * t + (e & 1);
        float x = sacc[idx] * scale + (biasb ? bias_t[kc] : 0.f);
        if (a.causal && k0 + kc > q0 + qr) x = kNegInf;
        const float p = expf(x - ((e & 2) ? lse1 : lse0));
        dpacc[idx] =
            p * (dpacc[idx] * cm[idx] - ((e & 2) ? dl1 : dl0)) * scale;
        if (a.dsq_out)
          static_cast<__nv_bfloat16*>(
              a.dsq_out)[((int64_t)bh * a.sq + q0 + qr) * a.skv + k0 + kc] =
              __float2bfloat16_rn(dpacc[idx]);
      }

#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) fence_regs(dq[cb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t da[4];
      a_frag(dpacc, kk, da);
#pragma unroll
      for (int cb = 0; cb < DO / 64; ++cb) {
        const uint32_t off =
            (dsplit * (DO / 64) + cb) * (kTcRows * 128) + kk * 16 * 128;
        wgmma_rs_n64<1>(dq[cb], da, desc_sw128(kd + off));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) fence_regs(dq[cb]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb)
    store_frag(static_cast<__nv_bfloat16*>(a.dq) + qofs + dsplit * DO +
                   cb * 64,
               hs, dq[cb]);
}

template <int D, int BQ, int DO>
int launch_bwd_tc(const BwdArgs& a, const Dropout& dr, int batch,
                  cudaStream_t stream) {
  constexpr int kDkv = dkv_tc_smem_bytes<D, BQ>();
  constexpr int kDq = dq_tc_smem_bytes<D>();
  static const cudaError_t attr_dkv =
      allow_smem(flash_bwd_dkv_tc_kernel<D, BQ, DO>, kDkv);
  static const cudaError_t attr_dq =
      allow_smem(flash_bwd_dq_tc_kernel<D, DO>, kDq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (a.sq % kTcRows != 0 || a.skv % kTcRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_tc_kernel<D, BQ, DO>
      <<<dim3(a.skv / kTcRows, a.nh * (D / DO), batch), 128, kDkv,
         stream>>>(a, dr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_tc_kernel<D, DO>
      <<<dim3(a.sq / kTcRows, a.nh * (D / DO), batch), 128, kDq, stream>>>(
          a, dr);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_tc_d(int head_dim, const BwdArgs& a, const Dropout& dr,
                    int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_bwd_tc<64, 64, 64>(a, dr, batch, stream);
    case 128:
      return launch_bwd_tc<128, 32, 128>(a, dr, batch, stream);
    case 256:
      return launch_bwd_tc<256, 32, 128>(a, dr, batch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The f32 forward on the SIMT kernel (dtype must be 0 = float32; bf16
// takes flash_attention_bsh_fwd_tc_launch).  bias may be null.
// drop_mode: 0 none, 1 the uint8 keep mask, 2 Philox from (seed, offset)
// with threshold thresh; keep_div divides the kept numerator; bits_out
// (uint8 [B, nh, Sq, Skv], or null) receives the Philox bits drawn.
// Returns 0 on success, the CUDA error code of a refused launch, or
// cudaErrorInvalidValue for an unsupported dtype, head_dim, length or
// dropout.
extern "C" int flash_attention_bsh_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int batch, int sq, int skv, int nh, int head_dim,
    float sm_scale, int prescale, int causal, int dtype, int drop_mode,
    const void* mask, void* bits_out, unsigned long long seed, int offset,
    int thresh, float keep_div, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || (causal && sq != skv)
      || !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(drop_mode, mask, bits_out, seed, offset,
                                  thresh, keep_div);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_d(head_dim, q, k, v, bias, o, lse, batch, sq, skv, nh,
                      sm_scale, prescale, causal, dr,
                      static_cast<cudaStream_t>(stream));
}

// The bf16 forward on the tensor cores: the arguments of
// flash_attention_bsh_launch (dtype must be 1; prescale is implied, see
// flash_fwd_bsh_tc_kernel), then two check outputs that are null on the
// training path: p_out (bf16 [B, nh, Sq, Skv], zeros where a causal tile
// is skipped) the rounded p c its P . V products take, relative to the
// running max m_out (f32 [B, nh, Sq, Skv / 64]: the max after each key
// tile, left as given where a tile is skipped).
extern "C" int flash_attention_bsh_fwd_tc_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int batch, int sq, int skv, int nh, int head_dim,
    float sm_scale, int prescale, int causal, int dtype, int drop_mode,
    const void* mask, void* bits_out, unsigned long long seed, int offset,
    int thresh, float keep_div, void* p_out, void* m_out, void* stream) {
  (void)prescale;
  if (batch <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || (causal && sq != skv)
      || dtype != 1 || !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(drop_mode, mask, bits_out, seed, offset,
                                  thresh, keep_div);
  const FwdArgs a = {static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     static_cast<const float*>(bias),
                     static_cast<__nv_bfloat16*>(o),
                     static_cast<float*>(lse),
                     static_cast<__nv_bfloat16*>(p_out),
                     static_cast<float*>(m_out), sq, skv, nh, causal,
                     sm_scale};
  return launch_fwd_tc_d(head_dim, a, dr, batch,
                         static_cast<cudaStream_t>(stream));
}

// The f32 backward on the SIMT kernels (dtype must be 0; bf16 takes
// flash_attention_bsh_bwd_tc_launch): dq, dk, dv from q, k, v, dout, the
// per-key bias (f32, may be null), lse and delta (f32 [B, nh, Sq]); the
// dropout as in the forward (bits are never written here).  Launches the
// dk/dv kernel, then the dq kernel.
extern "C" int flash_attention_bsh_bwd_launch(
    const void* q, const void* k, const void* v, const void* bias,
    const void* lse, const void* delta, const void* dout, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int nh, int head_dim,
    float sm_scale, int prescale, int causal, int dtype, int drop_mode,
    const void* mask, unsigned long long seed, int offset, int thresh,
    float keep_div, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || (causal && sq != skv)
      || !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {q, k, v, static_cast<const float*>(bias),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dout, dq, dk, dv, sq,
                     skv, nh, sm_scale, prescale, causal};
  const Dropout dr = make_dropout(drop_mode, mask, nullptr, seed, offset,
                                  thresh, keep_div);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_d<float>(head_dim, a, dr, batch,
                             static_cast<cudaStream_t>(stream));
}

// The bf16 backward on the tensor cores: the arguments of
// flash_attention_bsh_bwd_launch (dtype must be 1), then three check
// outputs that are null on the training path: p_out and ds_out receive
// the dk/dv kernel's rounded p c and ds, dsq_out the dq kernel's ds (bf16
// [B, nh, Sq, Skv]).  Launches the dk/dv kernel, then the dq kernel.
extern "C" int flash_attention_bsh_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* bias,
    const void* lse, const void* delta, const void* dout, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int nh, int head_dim,
    float sm_scale, int prescale, int causal, int dtype, int drop_mode,
    const void* mask, unsigned long long seed, int offset, int thresh,
    float keep_div, void* p_out, void* ds_out, void* dsq_out, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || (causal && sq != skv)
      || dtype != 1 || !dropout_ok(drop_mode, mask, thresh, keep_div) ||
      (p_out == nullptr) != (ds_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {q, k, v, static_cast<const float*>(bias),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dout, dq, dk, dv, sq,
                     skv, nh, sm_scale, prescale, causal, p_out, ds_out,
                     dsq_out};
  const Dropout dr = make_dropout(drop_mode, mask, nullptr, seed, offset,
                                  thresh, keep_div);
  return launch_bwd_tc_d(head_dim, a, dr, batch,
                         static_cast<cudaStream_t>(stream));
}
