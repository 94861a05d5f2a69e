// Flash attention over [B, nh, S, D] tensors for Hopper (sm_90a): the
// forward and the two backward schemes of the JAX package's BHSD path,
// which serves what the [B, S, H] kernels do not take: a full [.., S, S]
// bias, a per-key bias shared over the batch, an lse output with its
// cotangent, and causal masking at runtime offsets.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   row 6  _make_fwd_kernel        (launched by _flash_fwd, :392)
//   row 7  _make_bwd_fused_kernel  (_bwd_fused, :790)   key or no bias
//   row 8  _make_bwd_dq_kernel     (_flash_bwd, :902)   full bias
//   row 9  _make_bwd_dkv_kernel    (_flash_bwd, :943)   full bias
//
// What they compute, for bh = b * nh + h, query row i and key column j
// (q, k, v rows of S values of D; Sq = Skv = S):
//
//     s[i,j] = q_i . k_j * sm_scale + bias(bh, i, j)
//              (NEG_INF where causal and q_off + i < k_off + j)
//     p      = softmax_j(s),  o_i = sum_j p[i,j] c[i,j] v_j
//     lse_i  = m_i + log(max(l_i, 1e-30))
//
// with the TPU kernel's online softmax (m from NEG_INF, l the undropped
// row sum, acc / max(l, 1e-30)) and no q prescale: the scores are
// multiplied by sm_scale.  A masked score contributes p = 0, also in a
// row that sees no key at all: there l = 0, o = 0 and lse = NEG_INF +
// log(1e-30), which is NEG_INF in f32 (the TPU kernel gives that when
// its whole q block sees no key, and the mean of v over the visited keys
// when only some rows of the block do).  The backward likewise takes
// p = 0 at masked scores, never exp(NEG_INF - lse) (which would be 1 in
// such a row).  Dropout multiplies the numerator by c (flash_common.cuh:
// the explicit mask, or Philox keyed by (seed, offset, bh, i, j), the
// same bits as the [B, S, H] kernels draw).
//
// Bias.  bias(bh, i, j) reads row r = (bh / row_div) % row_mod of
//   * key mode: f32 [rows, S], bias[r, j]  ([B|1, 1, 1, S]: div nh,
//     mod B|1), not broadcast to [B * nh, S] first;
//   * full mode: f32 or bf16 [rows, S, S], bias[r, i, j]  ([B|1, nh|1,
//     S, S]: div nh when the bias has one head row else 1, mod
//     rows = bb * bn, the JAX package's _bias_row_map), added in f32.
// No broadcast copy is ever made.
//
// Backward (delta = rowsum(o * dO) - g_lse, formed by the wrapper):
//
//     p = exp(s - lse),  dp = dO . v,  ds0 = p (dp c - delta)
//     dv_j = sum_i p c dO_i,  dk_j = sm_scale sum_i ds0 q_i,
//     dq_i = sm_scale sum_j ds0 k_j,  dbias = ds0 (summed back to the
//     bias's shape by the wrapper)
//
//   * row 8 (dq): one block per (64-row q tile, bh) sums dq over the k
//     tiles it sees (_hi_blocks);
//   * row 9 (dk, dv): one block per (k tile, bh) sums over the q tiles
//     that see it (_lo_blocks) and writes ds0 as dbias [BH, S, S] f32 when
//     asked, zeros in the q tiles it skips;
//   * row 7 (single pass): one block per (k tile, bh) computes dk, dv
//     and the key-mode dbias column sums [BH, S], and dq's share of its k
//     tile.  The TPU kernel keeps dq resident across a sequential k
//     sweep; here the k tiles of one bh run in parallel, so a resident
//     sum would race, and atomics would add in a run-dependent order.
//     Instead each block writes its share as an f32 partial [nk, BH, S,
//     D] and a second small kernel, launched with it, sums the nk
//     partials of each element in k-tile order (the tiles that see that
//     row only) and casts.  Cost: nk * BH * S * D * 4 bytes written and
//     read again, nk = S / 64 (at B 64, nh 8, S 256, D 64: 134 MB each
//     way, ~0.08 ms at 3.35 TB/s), against a second pass that would
//     recompute s and dp (two of the five products).  Summing the
//     shares within a thread-block cluster of the nk key-tile blocks
//     instead (distributed shared memory, no scratch) measured slower
//     on the bf16 kernel: the shares of every query row (68 KB a block at
//     S 256) left one block an SM where the partials run two, and each
//     cluster waits for its busiest block under causal (PERF.md, row 7).
//
// Bound.  Forward 4 * BH * S * S * D flops (about half when causal), row
// 7 10x, row 8 6x, row 9 8x, against the dtype's peak, and the bytes of
// each kernel's inputs and outputs against 3.35 TB/s.  At the encoder's
// full-bias shapes the [B, nh, S, S] bias (67 MB in bf16) outweighs q, k,
// v and o, and rows 6, 8 and 9 each stream it once: the bytes bound.
// The SIMT kernels run f32 FMA, so they sit far above it.
//
// Design (SIMT: rows 6-9 in f32).  As
// the [B, S, H] kernels: one block of 256 threads owns one tile of T rows
// (T = 64, 32 at D = 256) of one bh and streams the other operand's
// tiles through shared memory; all arithmetic is f32 (bf16 widens on
// load).  Thread (ty, tx) of a 16 x 16 grid holds rows ty * T/16 .. and
// columns tx + 16 j of each score tile and of each accumulator; row max
// and sum reduce over 16 lanes with xor shuffles; tile rows in shared
// memory are padded by one float.  Causal tiles that no row sees are
// skipped in all four kernels.
//
// Row 6 on the tensor cores (bf16, every bias mode: the route of
// nmt_train's encoder, mha_key_train and flash_block_with_lse; the body,
// fwd_tc_tile, in flash_tc.cuh, shared with row 4's [B, S, H] kernel): one
// warpgroup owns a 64-query tile; Q lands once in a swizzled tile, and
// the key tiles (K, V and the bias tile) stream through a 2-stage
// cp.async ring.  S = Q K^T on wgmma, the online softmax in registers
// (each query row's max and sum over the quad of lanes holding it; exp by
// the ex2 unit, __expf), p c rounded to bf16 as the A operand of O += (p
// c) V from registers, as _make_fwd_kernel rounds p_num to v's dtype: so
// p c is rounded relative to the running max of the key tiles seen so
// far, 64 keys a tile.  The bytes bound (the [B, nh, S, S] bias) is what
// this kernel is after; the Philox draws of a dropout run are its largest
// cost of arithmetic, so they run while the tile's S product is in
// flight.
//
// Rows 8 and 9 on the tensor cores (bf16 with a full bias, the route of
// nmt_train's encoder): row 5's design (flash_attention_bsh.cu; helpers
// in hopper_mma.cuh and flash_tc.cuh) with the full bias tile.  One
// warpgroup owns a 64-row tile, every product is wgmma with bf16
// operands and f32 accumulators, and the other operand's tiles stream
// through a 2-stage cp.async ring, the next tile's copies overlapping
// this tile's products.  Row 9 (per 64-key tile, and per 128-column half
// of a D = 256 head): per query tile of BQ rows (64; 32 at D 128 and 256,
// for registers) S^T = K Q^T and dP^T = V dO^T, then p c and ds = ds0
// sm_scale in registers, rounded to bf16 as _make_bwd_dkv_kernel rounds
// them, as the A operands of dV += (p c)^T dO and dK += ds^T Q.  Its ring
// stage carries Q, dO, lse, delta and the bias tile [BQ queries x 64
// keys], read transposed (the accumulator rows are keys); dbias, when
// asked, is ds0 in f32 staged through shared memory as [query][key] rows
// and stored 16 bytes a thread.  Row 8 (per 64-query tile): S = Q K^T,
// dP = dO V^T, dQ += ds K, the ring carrying K, V and the [64 x 64] bias
// tile.  Both recompute S and dP (the bound counts them once each in
// its kernel) and draw the forward's Philox bits from the fragment
// layout (drop_keys_by_queries, drop_queries_by_keys); causal tiles that
// no row sees are skipped (_lo_blocks / _hi_blocks).  Each reads the
// [B, nh, S, S] bias once: one pass for both is later work.
//
// Row 7 on the tensor cores (bf16, no bias or a key bias: the route of
// mha_key_train and flash_block_with_lse): row 9's kernel with the key
// bias as two values a thread, its dbias summed along the accumulator
// rows (the keys) in registers, and dq.  The rounded ds^T of each query
// tile is stored once to a swizzled bf16 tile, the A operand (read
// transposed, MN-major) of dQ_tile = ds K against the resident K tile;
// dQ_tile is this key tile's share, summed over the key tiles through
// the f32 partials and the summing kernel (see row 7 above).  BQ is 64 at every D, and D splits into 64-column
// slices (grid z) that each recompute S and dP: five products at D 64.
//
// C interface (ctypes): flash_bhsd_fwd_launch, flash_bhsd_bwd_launch (f32)
// and flash_bhsd_bwd_tc_launch (bf16) return cudaGetLastError() after the
// launch (the first failing one).  The kernels run on the caller's stream,
// allocate nothing and do not synchronise.  Check outputs (null on the
// training path) let a test hold each bf16 rounding on its own: the
// rounded p c (and ds) a kernel feeds its products, and row 6's running
// max.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBQ = 64;        // forward: query rows per block
constexpr int kThreads = 256;  // 16 x 16

// backward parts
constexpr int kFused = 0;  // row 7
constexpr int kDq = 1;     // row 8
constexpr int kDkv = 2;    // row 9

struct Args {
  const void* q;        // [BH, S, D]
  const void* k;
  const void* v;
  const void* bias;     // key: f32 [rows, S]; full: [rows, S, S]; or null
  int bias_mode, bias_bf16, row_div, row_mod;
  void* o;              // forward: [BH, S, D]
  float* lse;           // forward out / backward in: [BH, S]
  const float* delta;   // backward: [BH, S]
  const void* dout;     // backward: [BH, S, D]
  void* dq;
  void* dk;
  void* dv;
  float* dq_part;       // row 7: [nk, BH, S, D]
  float* dbias;         // row 7: [BH, S]; row 9: [BH, S, S]; or null
  void* p_out;          // check outputs, bf16 [BH, S, S] or null: the p c
  void* ds_out;         // and ds rows 6, 7 and 9 feed their products (row
  void* dsq_out;        // 6: p c only), row 8's ds
  float* m_out;         // row 6's running max at each key tile [BH, S, S/64]
  int bh_count, s;
  float sm_scale;
  int causal, q_off, k_off;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// k tiles of bk a causal q tile of qt rows at q0 sees (_hi_blocks)
__device__ __forceinline__ int hi_blocks(const Args& a, int q0, int qt,
                                         int bk) {
  const int nk = a.s / bk;
  if (!a.causal) return nk;
  const int last = a.q_off + q0 + qt - a.k_off;  // visible local keys
  return min(max(-floor_div(-last, bk), 0), nk);
}

// first q tile of qt rows that sees the k tile at k0 (_lo_blocks)
__device__ __forceinline__ int lo_blocks(const Args& a, int k0, int qt) {
  if (!a.causal) return 0;
  return min(max(floor_div(a.k_off + k0 - a.q_off, qt), 0), a.s / qt);
}

__device__ __forceinline__ bool masked(const Args& a, int row, int col) {
  return a.causal && a.q_off + row < a.k_off + col;
}

// bias(bh, row, col) for the block's bias row r
__device__ __forceinline__ float bias_at(const Args& a, int64_t r, int row,
                                         int col) {
  if (a.bias_mode == kKeyBias)
    return static_cast<const float*>(a.bias)[r * a.s + col];
  if (a.bias_mode == kFullBias) {
    const int64_t at = (r * a.s + row) * a.s + col;
    return a.bias_bf16
               ? __bfloat162float(
                     static_cast<const __nv_bfloat16*>(a.bias)[at])
               : static_cast<const float*>(a.bias)[at];
  }
  return 0.f;
}

// Load a TT x D tile (rows contiguous) into shared memory, row stride D+1.
template <typename T, int TT, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src) {
  for (int idx = threadIdx.x; idx < TT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = to_float(src[idx]);
  }
}

// The thread's R x R dot products of a TT x TT tile: a_r . b_c over D
// (rows ty*R + i, columns tx + 16*j), a and b in shared memory.
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

// ---------------------------------------------------------------------------
// row 6: forward
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr int fwd_smem_floats() {
  return kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1);
}

template <typename T, int D, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bhsd_fwd_kernel(Args a, Dropout dr) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int NJ = BK / 16;  // score columns per thread
  constexpr int ND = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][DP]
  float* ks = qs + kBQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [kBQ][BKP]

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t base = (int64_t)bh * a.s * D;
  const T* __restrict__ kb = static_cast<const T*>(a.k) + base;
  const T* __restrict__ vb = static_cast<const T*>(a.v) + base;
  const int64_t brow = a.bias_mode ? (bh / a.row_div) % a.row_mod : 0;

  load_tile<T, kBQ, D>(qs, static_cast<const T*>(a.q) + base +
                               (int64_t)q0 * D);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }

  const int hi = hi_blocks(a, q0, kBQ, BK);
  for (int t = 0; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int64_t g = (int64_t)k0 * D + idx;
      ks[r * DP + c] = to_float(kb[g]);
      vs[r * D + c] = to_float(vb[g]);
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float cm[4][NJ];
    if (DROP)
      dropout_scale<4, NJ>(dr, bh, a.s, a.s, q0 + ty * 4, k0 + tx, cm, true);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = masked(a, row, col)
                            ? kNegInf
                            : s[i][j] * a.sm_scale + bias_at(a, brow, row, col);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = masked(a, row, col) ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = DROP ? p * cm[i][j] : p;  // dropout: the numerator only
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ps[(ty * 4 + i) * BKP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * BKP + c];
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) vv[jd] = vs[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < ND; ++jd)
          acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* __restrict__ orow = static_cast<T*>(a.o) + base + (int64_t)row * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store(orow + tx + 16 * jd, acc[i][jd] / l_safe);
    if (tx == 0) a.lse[(int64_t)bh * a.s + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// p c (to ps, when given) and ds0 = p (dp c - delta) (to dss) of the
// thread's scores of the tile (q0, k0), from s = q . k and dp = dO . v;
// shared-memory row stride TT + 1; db[j] adds the thread's ds0 of column
// tx + 16 j.
template <int TT>
__device__ __forceinline__ void tile_probs(const Args& a, const Dropout& dr,
                                           int bh, int64_t brow, int q0,
                                           int k0,
                                           const float (&s)[TT / 16][TT / 16],
                                           const float (&dp)[TT / 16][TT / 16],
                                           const float* lse_s,
                                           const float* delta_s, float* ps,
                                           float* dss, float (&db)[TT / 16]) {
  constexpr int R = TT / 16;
  constexpr int TP = TT + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float cm[R][R];
  dropout_scale<R, R>(dr, bh, a.s, a.s, q0 + ty * R, k0 + tx, cm, false);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rl = ty * R + i;
    const int row = q0 + rl;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int cl = tx + 16 * j;
      const int col = k0 + cl;
      const float p =
          masked(a, row, col)
              ? 0.f
              : expf(s[i][j] * a.sm_scale + bias_at(a, brow, row, col) -
                     lse_s[rl]);
      const float pc = p * cm[i][j];
      const float ds0 = p * (dp[i][j] * cm[i][j] - delta_s[rl]);
      if (ps) ps[rl * TP + cl] = pc;
      dss[rl * TP + cl] = ds0;
      db[j] += ds0;
    }
  }
}

template <int TT>
__device__ __forceinline__ void load_stats(const Args& a, int bh, int q0,
                                           float* lse_s, float* delta_s) {
  const int64_t at = (int64_t)bh * a.s + q0;
  for (int r = threadIdx.x; r < TT; r += kThreads) {
    lse_s[r] = a.lse[at + r];
    delta_s[r] = a.delta[at + r];
  }
}

template <int TT, int D>
constexpr int kv_smem_floats() {
  return 4 * TT * (D + 1) + 2 * TT * (TT + 1) + 2 * TT;
}

// Rows 7 and 9: one block per (k tile, bh) sums dk and dv over the q
// tiles that see it.  FUSED (row 7) adds dq's partial of this k tile and
// the key-mode dbias column sums; otherwise (row 9) the full-bias ds0 is
// written as dbias when asked.  Row 7's key dbias: each thread its
// columns' share in registers, added over the threads in a fixed order at
// the end.  float32 only (bf16 takes the tensor cores).
template <typename T, int TT, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bhsd_bwd_kv_kernel(Args a, Dropout dr) {
  const float ds_scale = a.sm_scale;  // left out of ds for dk and dq
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

  const int kt = blockIdx.x;
  const int k0 = kt * TT;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t base = (int64_t)bh * a.s * D;
  const T* __restrict__ qb = static_cast<const T*>(a.q) + base;
  const T* __restrict__ dob = static_cast<const T*>(a.dout) + base;
  const int64_t brow = a.bias_mode ? (bh / a.row_div) % a.row_mod : 0;

  load_tile<T, TT, D>(ks, static_cast<const T*>(a.k) + base +
                              (int64_t)k0 * D);
  load_tile<T, TT, D>(vs, static_cast<const T*>(a.v) + base +
                              (int64_t)k0 * D);

  float dk[R][ND], dv[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dk[i][jd] = dv[i][jd] = 0.f;
  float db[R];  // FUSED: this thread's share of columns tx + 16 j's dbias
#pragma unroll
  for (int j = 0; j < R; ++j) db[j] = 0.f;

  const int nq = a.s / TT;
  const int lo = lo_blocks(a, k0, TT);
  if (!FUSED && a.dbias) {
    // the q tiles that never see this k tile get a zero dbias
    for (int idx = threadIdx.x; idx < lo * TT * TT; idx += kThreads) {
      const int r = idx / TT, c = idx % TT;
      a.dbias[((int64_t)bh * a.s + r) * a.s + k0 + c] = 0.f;
    }
  }
  for (int t = lo; t < nq; ++t) {
    const int q0 = t * TT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TT, D>(qs, qb + (int64_t)q0 * D);
    load_tile<T, TT, D>(dos, dob + (int64_t)q0 * D);
    load_stats<TT>(a, bh, q0, lse_s, delta_s);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<TT, D>(qs, ks, s);
    tile_dot<TT, D>(dos, vs, dp);
    tile_probs<TT>(a, dr, bh, brow, q0, k0, s, dp, lse_s, delta_s, ps,
                          dss, db);
    __syncthreads();
    // dv[c] += sum_r p[r][c] dO[r];  dk[c] += sum_r ds0[r][c] q[r]
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
    if (FUSED) {
      // dq's share of this k tile: dq[r] = sm_scale sum_c ds0[r][c] k[c]
      float dq[R][ND];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) dq[i][jd] = 0.f;
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
      float* part = a.dq_part + ((int64_t)kt * a.bh_count + bh) * a.s * D;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float* prow = part + (int64_t)(q0 + ty * R + i) * D;
#pragma unroll
        for (int jd = 0; jd < ND; ++jd)
          prow[tx + 16 * jd] = dq[i][jd] * ds_scale;
      }
    } else if (a.dbias) {
      for (int idx = threadIdx.x; idx < TT * TT; idx += kThreads) {
        const int r = idx / TT, c = idx % TT;
        a.dbias[((int64_t)bh * a.s + q0 + r) * a.s + k0 + c] =
            dss[r * TP + c];
      }
    }
  }

  const int64_t kofs = base + (int64_t)k0 * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t at = kofs + (int64_t)(ty * R + i) * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      store(static_cast<T*>(a.dk) + at + tx + 16 * jd,
            dk[i][jd] * ds_scale);
      store(static_cast<T*>(a.dv) + at + tx + 16 * jd, dv[i][jd]);
    }
  }
  if (FUSED && a.dbias) {
    // the column sums over the 16 thread rows, in order (ps is free now)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) ps[ty * TT + tx + 16 * j] = db[j];
    __syncthreads();
    if (threadIdx.x < TT) {
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += ps[r * TT + threadIdx.x];
      a.dbias[(int64_t)bh * a.s + k0 + threadIdx.x] = sum;
    }
  }
}

// Row 7's second kernel: dq = the sum, in k-tile order, of the partials
// of the k tiles that see each row, cast to the dtype.
template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
flash_bhsd_dq_sum_kernel(Args a, int d) {
  const int64_t total = (int64_t)a.bh_count * a.s * d;
  for (int64_t idx = blockIdx.x * (int64_t)kThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kThreads) {
    const int row = static_cast<int>((idx / d) % a.s);
    const int hi = hi_blocks(a, row - row % TT, TT, TT);
    float sum = 0.f;
    for (int kt = 0; kt < hi; ++kt) sum += a.dq_part[kt * total + idx];
    store(static_cast<T*>(a.dq) + idx, sum);
  }
}

// launch flash_bhsd_dq_sum_kernel over a.dq: at most 16 blocks an SM
template <typename T, int TT>
int launch_dq_sum(const Args& a, int d, cudaStream_t stream) {
  const int64_t total = (int64_t)a.bh_count * a.s * d;
  const int64_t need = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 132 * 16 ? need : 132 * 16);
  flash_bhsd_dq_sum_kernel<T, TT><<<blocks, kThreads, 0, stream>>>(a, d);
  return static_cast<int>(cudaGetLastError());
}

template <int TT, int D>
constexpr int dq_smem_floats() {
  return 4 * TT * (D + 1) + TT * (TT + 1) + 2 * TT;
}

// Row 8: dq of one (q tile, bh), summed over the k tiles it sees.
template <typename T, int TT, int D>
__global__ void __launch_bounds__(kThreads)
flash_bhsd_bwd_dq_kernel(Args a, Dropout dr) {
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
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t base = (int64_t)bh * a.s * D;
  const int64_t qofs = base + (int64_t)q0 * D;
  const T* __restrict__ kb = static_cast<const T*>(a.k) + base;
  const T* __restrict__ vb = static_cast<const T*>(a.v) + base;
  const int64_t brow = a.bias_mode ? (bh / a.row_div) % a.row_mod : 0;

  load_tile<T, TT, D>(qs, static_cast<const T*>(a.q) + qofs);
  load_tile<T, TT, D>(dos, static_cast<const T*>(a.dout) + qofs);
  load_stats<TT>(a, bh, q0, lse_s, delta_s);

  float dq[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dq[i][jd] = 0.f;

  const int hi = hi_blocks(a, q0, TT, TT);
  for (int t = 0; t < hi; ++t) {
    const int k0 = t * TT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TT, D>(ks, kb + (int64_t)k0 * D);
    load_tile<T, TT, D>(vs, vb + (int64_t)k0 * D);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<TT, D>(qs, ks, s);
    tile_dot<TT, D>(dos, vs, dp);
    float db_unused[R] = {};
    tile_probs<TT>(a, dr, bh, brow, q0, k0, s, dp, lse_s, delta_s,
                          nullptr, dss, db_unused);
    __syncthreads();
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

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t at = qofs + (int64_t)(ty * R + i) * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store(static_cast<T*>(a.dq) + at + tx + 16 * jd,
            dq[i][jd] * a.sm_scale);
  }
}

// ---------------------------------------------------------------------------
// rows 8 and 9 on the tensor cores (bf16 with a full bias)
// ---------------------------------------------------------------------------

constexpr int kDbPitch = 68;  // the dk/dv kernel's staged ds0 rows (f32)

template <int D, int BQ, typename BT>
constexpr int dkv_tc_smem_bytes() {
  return 2 * kTcRows * D * 2 + 2 * 2 * BQ * D * 2 + 2 * 2 * BQ * 4 +
         2 * bias_tile_bytes<BT>(BQ) + BQ * kDbPitch * 4 + 1024;
}

// Row 9: dk, dv of one (64-key tile, bh, DO-column slice of the head):
// one warpgroup; the query tiles (BQ rows of q and dO, their lse and
// delta, and the bias tile [BQ queries x 64 keys]) stream through a
// 2-stage cp.async ring.  Per query tile:
//   S^T  = K . Q^T and dP^T = V . dO^T   (A: K, V; B: Q, dO; K-major)
//   p c, ds in registers, rounded to bf16: the A operands of
//   dV  += (p c)^T . dO and dK += ds^T . Q  (B: dO, Q; MN-major)
// The accumulator rows are keys, so the bias is read transposed from the
// stage.  dbias (when asked, by the slice dsplit 0 only): ds0 staged as
// [query][key] f32 rows, then stored row by row, 16 bytes a thread.
template <int D, int BQ, int DO, typename BT>
__global__ void __launch_bounds__(128)
flash_bhsd_bwd_dkv_tc_kernel(Args a, Dropout dr) {
  constexpr int KV_BYTES = kTcRows * D * 2;
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int NB = BQ / 8;
  constexpr int BP = bias_pitch<BT>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* base_p = smem_raw + pad;
  const uint32_t ks = raw + pad, vs = ks + KV_BYTES;
  const uint32_t qs0 = vs + KV_BYTES;  // stage st: Q at qs0 + st * 2 * Q_BYTES,
                                       // dO Q_BYTES after it
  float* stat_s = reinterpret_cast<float*>(base_p + 2 * KV_BYTES +
                                           4 * Q_BYTES);  // [2][lse, delta][BQ]
  uint8_t* bias_p = reinterpret_cast<uint8_t*>(stat_s + 4 * BQ);  // [2] tiles
  float* db_s = reinterpret_cast<float*>(bias_p + 2 * bias_tile_bytes<BT>(BQ));

  const int k0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y, dsplit = blockIdx.z;
  const int s = a.s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)bh * s * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + base;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + base;
  const int64_t kofs = base + (int64_t)k0 * D;
  const float* lseb = a.lse + (int64_t)bh * s;
  const float* deltab = a.delta + (int64_t)bh * s;
  const int64_t brow = (bh / a.row_div) % a.row_mod;
  const BT* biasb = static_cast<const BT*>(a.bias) + brow * s * s + k0;
  float* dbb = a.dbias && dsplit == 0
                   ? a.dbias + (int64_t)bh * s * s + k0 : nullptr;
  const int nq = s / BQ;
  const int lo = lo_blocks(a, k0, BQ);

  auto load_q = [&](int qt, int st) {
    const uint32_t qd = qs0 + st * 2 * Q_BYTES;
    tile_async<BQ, D>(qd, qb + (int64_t)qt * BQ * D, D);
    tile_async<BQ, D>(qd + Q_BYTES, dob + (int64_t)qt * BQ * D, D);
    const uint32_t sd = smem_u32(stat_s + st * 2 * BQ);
    if (tid < BQ / 4)
      cp_async16(sd + tid * 16, lseb + qt * BQ + tid * 4, true);
    else if (tid < BQ / 2)
      cp_async16(sd + BQ * 4 + (tid - BQ / 4) * 16,
                 deltab + qt * BQ + (tid - BQ / 4) * 4, true);
    bias_async<BQ, BT>(smem_u32(bias_p + st * bias_tile_bytes<BT>(BQ)),
                       biasb + (int64_t)qt * BQ * s, s);
  };

  tile_async<kTcRows, D>(ks, static_cast<const __nv_bfloat16*>(a.k) + kofs,
                         D);
  tile_async<kTcRows, D>(vs, static_cast<const __nv_bfloat16*>(a.v) + kofs,
                         D);
  if (lo < nq) load_q(lo, 0);
  cp_async_commit();

  if (dbb) {
    // the q tiles that never see this key tile get a zero dbias
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = tid; idx < lo * BQ * 16; idx += 128)
      *reinterpret_cast<float4*>(dbb + (int64_t)(idx >> 4) * s +
                                 (idx & 15) * 4) = z;
  }

  const int kr0 = 16 * warp + g;  // this thread's key rows kr0, kr0 + 8
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
    const BT* bias_t =
        reinterpret_cast<const BT*>(bias_p + st * bias_tile_bytes<BT>(BQ));
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
    drop_keys_by_queries<NB>(dr, bh, s, s, k0 + kr0, q0, cm);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int kr = kr0 + ((e & 2) ? 8 : 0);
        const int qc = 8 * i + 2 * t + (e & 1);
        const float x = sacc[idx] * scale + to_float(bias_t[qc * BP + kr]);
        // p = 0 at a masked score, also in a row that sees no key
        const float p = masked(a, q0 + qc, k0 + kr) ? 0.f
                                                    : expf(x - lse_s[qc]);
        const float ds0 = p * (dpacc[idx] * cm[idx] - delta_s[qc]);
        sacc[idx] = p * cm[idx];    // p c
        dpacc[idx] = ds0 * scale;   // ds
        if (dbb) db_s[qc * kDbPitch + kr] = ds0;
        if (a.p_out) {
          const int64_t at = ((int64_t)bh * s + q0 + qc) * s + k0 + kr;
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

    if (dbb) {
      __syncthreads();  // every thread's ds0 is staged
      for (int idx = tid; idx < BQ * 16; idx += 128) {
        const int r = idx >> 4, c4 = (idx & 15) * 4;
        *reinterpret_cast<float4*>(dbb + (int64_t)(q0 + r) * s + c4) =
            *reinterpret_cast<const float4*>(db_s + r * kDbPitch + c4);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) {
    const int64_t at = kofs + dsplit * DO + cb * 64;
    store_frag(static_cast<__nv_bfloat16*>(a.dk) + at, D, dk[cb]);
    store_frag(static_cast<__nv_bfloat16*>(a.dv) + at, D, dv[cb]);
  }
}

template <int D, typename BT>
constexpr int dq_tc_smem_bytes() {
  return 2 * kTcRows * D * 2 + 2 * 2 * kTcRows * D * 2 +
         2 * bias_tile_bytes<BT>(kTcRows) + 1024;
}

// Row 8: dq of one (64-query tile, bh, DO-column slice): one warpgroup;
// the key tiles (64 rows of k and v, and the bias tile [64 queries x 64
// keys]) stream through a 2-stage cp.async ring.  Per key tile: S = Q .
// K^T, dP = dO . V^T (K-major), ds in registers rounded to bf16, dQ += ds
// . K (B: K, MN-major).
template <int D, int DO, typename BT>
__global__ void __launch_bounds__(128)
flash_bhsd_bwd_dq_tc_kernel(Args a, Dropout dr) {
  constexpr int T_BYTES = kTcRows * D * 2;
  constexpr int NB = kTcRows / 8;
  constexpr int BP = bias_pitch<BT>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t qs = raw + pad, dos = qs + T_BYTES;
  const uint32_t kv0 = dos + T_BYTES;  // stage st: K at kv0 + st * 2 * T_BYTES,
                                       // V T_BYTES after it
  uint8_t* bias_p = smem_raw + pad + 6 * T_BYTES;  // [2] bias tiles

  const int q0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y, dsplit = blockIdx.z;
  const int s = a.s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)bh * s * D;
  const int64_t qofs = base + (int64_t)q0 * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + base;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + base;
  const int64_t brow = (bh / a.row_div) % a.row_mod;
  const BT* biasb =
      static_cast<const BT*>(a.bias) + (brow * s + q0) * (int64_t)s;
  const int nk = hi_blocks(a, q0, kTcRows, kTcRows);

  auto load_kv = [&](int kt, int st) {
    const uint32_t kd = kv0 + st * 2 * T_BYTES;
    tile_async<kTcRows, D>(kd, kb + (int64_t)kt * kTcRows * D, D);
    tile_async<kTcRows, D>(kd + T_BYTES, vb + (int64_t)kt * kTcRows * D, D);
    bias_async<kTcRows, BT>(
        smem_u32(bias_p + st * bias_tile_bytes<BT>(kTcRows)),
        biasb + kt * kTcRows, s);
  };

  tile_async<kTcRows, D>(qs, static_cast<const __nv_bfloat16*>(a.q) + qofs,
                         D);
  tile_async<kTcRows, D>(dos,
                         static_cast<const __nv_bfloat16*>(a.dout) + qofs, D);
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  const int qr0 = 16 * warp + g;  // this thread's query rows qr0, qr0 + 8
  const int64_t stat0 = (int64_t)bh * s + q0;
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
    const BT* bias_t = reinterpret_cast<const BT*>(
        bias_p + st * bias_tile_bytes<BT>(kTcRows));
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
    drop_queries_by_keys<NB>(dr, bh, s, s, q0 + qr0, k0, cm);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int qr = qr0 + ((e & 2) ? 8 : 0);
        const int kc = 8 * i + 2 * t + (e & 1);
        const float x = sacc[idx] * scale + to_float(bias_t[qr * BP + kc]);
        const float p = masked(a, q0 + qr, k0 + kc)
                            ? 0.f
                            : expf(x - ((e & 2) ? lse1 : lse0));
        dpacc[idx] =
            p * (dpacc[idx] * cm[idx] - ((e & 2) ? dl1 : dl0)) * scale;
        if (a.dsq_out)
          static_cast<__nv_bfloat16*>(
              a.dsq_out)[((int64_t)bh * s + q0 + qr) * s + k0 + kc] =
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
               D, dq[cb]);
}

// ---------------------------------------------------------------------------
// row 7 on the tensor cores (bf16, no bias or a key bias)
// ---------------------------------------------------------------------------

// the fused kernel's shared memory: K, V, a 2-stage ring of Q and dO,
// the ds^T tile, lse and delta
template <int D>
constexpr int fused_tc_smem_bytes() {
  return 6 * kTcRows * D * 2 + kTcRows * kTcRows * 2 + 4 * kTcRows * 4 +
         1024;
}

// Row 7: dk, dv, the key dbias and dq's share of one (64-key tile, bh,
// 64-column slice of the head): one warpgroup; K and V land once, the
// query tiles (64 rows of q and dO, their lse and delta) stream through a
// 2-stage cp.async ring.  Per query tile:
//   S^T  = K . Q^T and dP^T = V . dO^T   (A: K, V; B: Q, dO; K-major)
//   p c and ds = ds0 sm_scale in registers, rounded to bf16 as
//   _make_bwd_fused_kernel rounds them: the A operands of
//   dV  += (p c)^T . dO and dK += ds^T . Q  (B: dO, Q; MN-major)
//   the rounded ds^T stored once to a swizzled bf16 tile, the A operand
//   (read transposed) of dQ_tile = ds . K (B: K, MN-major)
// The accumulator rows are keys: the key bias is two values a thread,
// loaded once, and the key dbias (the unrounded ds0) adds along each row
// in the thread's registers, its quad summed by shuffles at the end, in a
// fixed order.  dQ_tile is this key tile's share of the query tile's dq,
// written as the f32 partial [nk, BH, S, D] that flash_bhsd_dq_sum_kernel
// sums in key-tile order.
template <int D>
__global__ void __launch_bounds__(128)
flash_bhsd_bwd_fused_tc_kernel(Args a, Dropout dr) {
  constexpr int T_BYTES = kTcRows * D * 2;   // a K, V, Q or dO tile
  constexpr int NB = kTcRows / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* base_p = smem_raw + pad;
  const uint32_t ks = raw + pad, vs = ks + T_BYTES;
  const uint32_t qs0 = vs + T_BYTES;  // stage st: Q at qs0 + st * 2 * T_BYTES,
                                      // dO T_BYTES after it
  const uint32_t dst = qs0 + 4 * T_BYTES;   // ds^T [64 keys x 64 queries]
  float* stat_s = reinterpret_cast<float*>(
      base_p + 6 * T_BYTES + kTcRows * kTcRows * 2);  // [2][lse, delta][64]

  const int kt = blockIdx.x, k0 = kt * kTcRows;
  const int bh = blockIdx.y, dsplit = blockIdx.z;
  const int s = a.s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)bh * s * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + base;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + base;
  const int64_t kofs = base + (int64_t)k0 * D;
  const float* lseb = a.lse + (int64_t)bh * s;
  const float* deltab = a.delta + (int64_t)bh * s;
  const int nq = s / kTcRows;
  const int lo = lo_blocks(a, k0, kTcRows);

  auto load_q = [&](int qt, int st) {
    const uint32_t qd = qs0 + st * 2 * T_BYTES;
    tile_async<kTcRows, D>(qd, qb + (int64_t)qt * kTcRows * D, D);
    tile_async<kTcRows, D>(qd + T_BYTES, dob + (int64_t)qt * kTcRows * D, D);
    const uint32_t sd = smem_u32(stat_s + st * 2 * kTcRows);
    if (tid < kTcRows / 4)
      cp_async16(sd + tid * 16, lseb + qt * kTcRows + tid * 4, true);
    else if (tid < kTcRows / 2)
      cp_async16(sd + kTcRows * 4 + (tid - kTcRows / 4) * 16,
                 deltab + qt * kTcRows + (tid - kTcRows / 4) * 4, true);
  };

  tile_async<kTcRows, D>(ks, static_cast<const __nv_bfloat16*>(a.k) + kofs,
                         D);
  tile_async<kTcRows, D>(vs, static_cast<const __nv_bfloat16*>(a.v) + kofs,
                         D);
  if (lo < nq) load_q(lo, 0);
  cp_async_commit();

  const int kr0 = 16 * warp + g;  // this thread's key rows kr0, kr0 + 8
  const float* biasb =
      a.bias_mode == kKeyBias
          ? static_cast<const float*>(a.bias) +
                ((bh / a.row_div) % a.row_mod) * (int64_t)s + k0
          : nullptr;
  const float bias0 = biasb ? biasb[kr0] : 0.f;
  const float bias1 = biasb ? biasb[kr0 + 8] : 0.f;
  const float scale = a.sm_scale;
  const bool checks = a.p_out && dsplit == 0;

  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  float db0 = 0.f, db1 = 0.f;  // the key dbias of rows kr0, kr0 + 8

  for (int qt = lo; qt < nq; ++qt) {
    const int st = (qt - lo) & 1;
    cp_async_wait<0>();  // this tile (and, first, K and V) has landed
    fence_async_smem();
    __syncthreads();     // for every thread; the other stage and ds^T free
    if (qt + 1 < nq) load_q(qt + 1, st ^ 1);
    cp_async_commit();

    const uint32_t qd = qs0 + st * 2 * T_BYTES, dod = qd + T_BYTES;
    const float* lse_s = stat_s + st * 2 * kTcRows;
    const float* delta_s = lse_s + kTcRows;
    float sacc[32], dpacc[32];
    zero(sacc);
    zero(dpacc);
    fence_regs(sacc);
    fence_regs(dpacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kTcRows * 128) + (kk & 3) * 32;
      wgmma_ss<64, 0>(sacc, desc_sw128(ks + off), desc_sw128(qd + off));
      wgmma_ss<64, 0>(dpacc, desc_sw128(vs + off), desc_sw128(dod + off));
    }
    wg_commit();
    // the dropout multipliers while the products run
    const int q0 = qt * kTcRows;
    float cm[32];
    drop_keys_by_queries<NB>(dr, bh, s, s, k0 + kr0, q0, cm);
    wg_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);

#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int kr = kr0 + ((e & 2) ? 8 : 0);
        const int qc = 8 * i + 2 * t + (e & 1);
        const float x = sacc[idx] * scale + ((e & 2) ? bias1 : bias0);
        // p = 0 at a masked score, also in a row that sees no key
        const float p = masked(a, q0 + qc, k0 + kr) ? 0.f
                                                    : __expf(x - lse_s[qc]);
        const float ds0 = p * (dpacc[idx] * cm[idx] - delta_s[qc]);
        sacc[idx] = p * cm[idx];    // p c
        dpacc[idx] = ds0 * scale;   // ds
        if (e & 2)
          db1 += ds0;
        else
          db0 += ds0;
        if (checks) {
          const int64_t at = ((int64_t)bh * s + q0 + qc) * s + k0 + kr;
          static_cast<__nv_bfloat16*>(a.p_out)[at] =
              __float2bfloat16_rn(sacc[idx]);
          static_cast<__nv_bfloat16*>(a.ds_out)[at] =
              __float2bfloat16_rn(dpacc[idx]);
        }
      }
    // the rounded ds^T, rows keys and columns queries: dQ's A, MN-major
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + swz128(kr0, i) +
                                                      4 * t),
                   "r"(pack_bf16(dpacc[4 * i], dpacc[4 * i + 1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst +
                                                      swz128(kr0 + 8, i) +
                                                      4 * t),
                   "r"(pack_bf16(dpacc[4 * i + 2], dpacc[4 * i + 3])));
    }

    fence_async_smem();
    __syncthreads();     // every thread's ds^T is in the tile

    // dV += (p c)^T dO, dK += ds^T Q, dQ_tile = ds K: one group
    float dq[32];
    zero(dq);
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_frag(sacc, kk, pa);
      a_frag(dpacc, kk, da);
      const uint32_t off = dsplit * (kTcRows * 128) + kk * 16 * 128;
      wgmma_rs_n64<1>(dv, pa, desc_sw128(dod + off));
      wgmma_rs_n64<1>(dk, da, desc_sw128(qd + off));
      wgmma_ss_n64_mn(dq, desc_sw128(dst + kk * 16 * 128),
                      desc_sw128(ks + off));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(dq);

    // this key tile's share of dq: query rows 16 warp + g (+ 8), columns
    // 8 i + 2 t (+ 1) of the slice
    float* dqp = a.dq_part +
                 (((int64_t)kt * a.bh_count + bh) * s + q0 + kr0) * D +
                 dsplit * 64;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      *reinterpret_cast<float2*>(dqp + 8 * i + 2 * t) =
          make_float2(dq[4 * i], dq[4 * i + 1]);
      *reinterpret_cast<float2*>(dqp + 8 * D + 8 * i + 2 * t) =
          make_float2(dq[4 * i + 2], dq[4 * i + 3]);
    }
  }
  cp_async_wait<0>();

  store_frag(static_cast<__nv_bfloat16*>(a.dk) + kofs + dsplit * 64, D, dk);
  store_frag(static_cast<__nv_bfloat16*>(a.dv) + kofs + dsplit * 64, D, dv);
  if (a.dbias && dsplit == 0) {
    db0 = quad_sum(db0);
    db1 = quad_sum(db1);
    if (t == 0) {
      a.dbias[(int64_t)bh * s + k0 + kr0] = db0;
      a.dbias[(int64_t)bh * s + k0 + kr0 + 8] = db1;
    }
  }
}

// ---------------------------------------------------------------------------
// row 6 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

// Row 6: o and lse of one (64-query tile, bh, DO-column slice of the
// head), the forward body of flash_tc.cuh (fwd_tc_tile) at [B, nh, S, D]
// rows; the slice dsplit 0 writes lse and the check outputs.
template <int D, int DO, int BMODE, typename BT>
__global__ void __launch_bounds__(128)
flash_bhsd_fwd_tc_kernel(Args a, Dropout dr) {
  const int q0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y, dsplit = blockIdx.z;
  const int s = a.s;
  const int64_t base = (int64_t)bh * s * D;
  const int64_t brow = BMODE ? (bh / a.row_div) % a.row_mod : 0;
  FwdTile f;
  f.q = static_cast<const __nv_bfloat16*>(a.q) + base + (int64_t)q0 * D;
  f.k = static_cast<const __nv_bfloat16*>(a.k) + base;
  f.v = static_cast<const __nv_bfloat16*>(a.v) + base + dsplit * DO;
  f.o = static_cast<__nv_bfloat16*>(a.o) + base + (int64_t)q0 * D +
        dsplit * DO;
  f.rs = D;
  f.bias = static_cast<const BT*>(a.bias) +
           (BMODE == kFullBias ? (brow * s + q0) * (int64_t)s : brow * s);
  f.lse = a.lse + (int64_t)bh * s + q0;
  f.p_out = static_cast<__nv_bfloat16*>(a.p_out);
  f.m_out = a.m_out;
  f.bh = bh;
  f.sq = f.skv = s;
  f.q0 = q0;
  f.nk = hi_blocks(a, q0, kTcRows, kTcRows);
  f.causal = a.causal;
  f.q_off = a.q_off;
  f.k_off = a.k_off;
  f.sm_scale = a.sm_scale;
  f.checks = dsplit == 0;
  fwd_tc_tile<D, DO, BMODE, BT>(f, dr);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int D, int BK, bool DROP>
int launch_fwd(const Args& a, const Dropout& dr, cudaStream_t stream) {
  constexpr int kSmem =
      fwd_smem_floats<D, BK>() * static_cast<int>(sizeof(float));
  static const cudaError_t attr =
      allow_smem(flash_bhsd_fwd_kernel<T, D, BK, DROP>, kSmem);  // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.s % kBQ != 0 || a.s % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bhsd_fwd_kernel<T, D, BK, DROP>
      <<<dim3(a.s / kBQ, a.bh_count), kThreads, kSmem, stream>>>(a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int BK>
int launch_fwd_drop(const Args& a, const Dropout& dr, cudaStream_t stream) {
  if (dr.mode == kNoDrop) return launch_fwd<T, D, BK, false>(a, dr, stream);
  return launch_fwd<T, D, BK, true>(a, dr, stream);
}

template <typename T>
int launch_fwd_d(int head_dim, const Args& a, const Dropout& dr,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_fwd_drop<T, 64, 64>(a, dr, stream);
    case 128:
      return launch_fwd_drop<T, 128, 64>(a, dr, stream);
    case 256:
      return launch_fwd_drop<T, 256, 32>(a, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, int DO, int BMODE, typename BT>
int launch_fwd_tc(const Args& a, const Dropout& dr, cudaStream_t stream) {
  constexpr int kSmem = fwd_tc_smem_bytes<D, DO, BMODE, BT>();
  static const cudaError_t attr =
      allow_smem(flash_bhsd_fwd_tc_kernel<D, DO, BMODE, BT>, kSmem);  // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.s % kTcRows != 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_bhsd_fwd_tc_kernel<D, DO, BMODE, BT>
      <<<dim3(a.s / kTcRows, a.bh_count, D / DO), 128, kSmem, stream>>>(a,
                                                                       dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DO>
int launch_fwd_tc_bias(const Args& a, const Dropout& dr, cudaStream_t st) {
  if (a.bias_mode == kNoBias)
    return launch_fwd_tc<D, DO, kNoBias, float>(a, dr, st);
  if (a.bias_mode == kKeyBias)
    return launch_fwd_tc<D, DO, kKeyBias, float>(a, dr, st);
  if (a.bias_bf16)
    return launch_fwd_tc<D, DO, kFullBias, __nv_bfloat16>(a, dr, st);
  return launch_fwd_tc<D, DO, kFullBias, float>(a, dr, st);
}

// D 256 in two 128-column slices (grid z), each recomputing S: 64 O
// accumulators a thread at most
int launch_fwd_tc_d(int head_dim, const Args& a, const Dropout& dr,
                    cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_fwd_tc_bias<64, 64>(a, dr, stream);
    case 128:
      return launch_fwd_tc_bias<128, 128>(a, dr, stream);
    case 256:
      return launch_fwd_tc_bias<256, 128>(a, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows 7-9 on the SIMT cores (float32)
template <int TT, int D>
int launch_bwd(int part, const Args& a, const Dropout& dr,
               cudaStream_t stream) {
  constexpr int kKv = kv_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  constexpr int kQ = dq_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  static const cudaError_t attr_fused =
      allow_smem(flash_bhsd_bwd_kv_kernel<float, TT, D, true>, kKv);
  static const cudaError_t attr_dkv =
      allow_smem(flash_bhsd_bwd_kv_kernel<float, TT, D, false>, kKv);
  static const cudaError_t attr_dq =
      allow_smem(flash_bhsd_bwd_dq_kernel<float, TT, D>, kQ);
  if (a.s % TT != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.s / TT, a.bh_count);
  if (part == kFused) {
    if (attr_fused != cudaSuccess) return static_cast<int>(attr_fused);
    if (a.bias_mode == kFullBias || !a.dq_part)
      return static_cast<int>(cudaErrorInvalidValue);
    flash_bhsd_bwd_kv_kernel<float, TT, D, true>
        <<<grid, kThreads, kKv, stream>>>(a, dr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_dq_sum<float, TT>(a, D, stream);
  }
  if (part == kDq) {
    if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
    flash_bhsd_bwd_dq_kernel<float, TT, D>
        <<<grid, kThreads, kQ, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == kDkv) {
    if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
    flash_bhsd_bwd_kv_kernel<float, TT, D, false>
        <<<grid, kThreads, kKv, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bwd_d(int head_dim, int part, const Args& a, const Dropout& dr,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_bwd<64, 64>(part, a, dr, stream);
    case 128:
      return launch_bwd<64, 128>(part, a, dr, stream);
    case 256:
      return launch_bwd<32, 256>(part, a, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, int BQ, int DO, typename BT>
int launch_bwd_tc(int part, const Args& a, const Dropout& dr,
                  cudaStream_t stream) {
  constexpr int kDkvBytes = dkv_tc_smem_bytes<D, BQ, BT>();
  constexpr int kDqBytes = dq_tc_smem_bytes<D, BT>();
  static const cudaError_t attr_dkv =
      allow_smem(flash_bhsd_bwd_dkv_tc_kernel<D, BQ, DO, BT>, kDkvBytes);
  static const cudaError_t attr_dq =
      allow_smem(flash_bhsd_bwd_dq_tc_kernel<D, DO, BT>, kDqBytes);
  if (a.s % kTcRows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.s / kTcRows, a.bh_count, D / DO);
  if (part == kDq) {
    if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
    flash_bhsd_bwd_dq_tc_kernel<D, DO, BT>
        <<<grid, 128, kDqBytes, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == kDkv) {
    if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
    flash_bhsd_bwd_dkv_tc_kernel<D, BQ, DO, BT>
        <<<grid, 128, kDkvBytes, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the tiles of row 5's tensor-core pair: 32-row streamed tiles at D 128
// and 256, D 256 in two 128-column slices
template <typename BT>
int launch_bwd_tc_d(int head_dim, int part, const Args& a, const Dropout& dr,
                    cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_bwd_tc<64, 64, 64, BT>(part, a, dr, stream);
    case 128:
      return launch_bwd_tc<128, 32, 128, BT>(part, a, dr, stream);
    case 256:
      return launch_bwd_tc<256, 32, 128, BT>(part, a, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Row 7 on the tensor cores: one block per (64-key tile, bh, 64-column
// slice), then the summing kernel over dq_part (f32 [S / 64, BH, S, D]).
template <int D>
int launch_fused_tc(const Args& a, const Dropout& dr, cudaStream_t stream) {
  constexpr int kBytes = fused_tc_smem_bytes<D>();
  static const cudaError_t attr =
      allow_smem(flash_bhsd_bwd_fused_tc_kernel<D>, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.s % kTcRows != 0 || a.bias_mode == kFullBias || !a.dq_part)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bhsd_bwd_fused_tc_kernel<D>
      <<<dim3(a.s / kTcRows, a.bh_count, D / 64), 128, kBytes, stream>>>(a,
                                                                      dr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_dq_sum<__nv_bfloat16, kTcRows>(a, D, stream);
}

int launch_fused_tc_d(int head_dim, const Args& a, const Dropout& dr,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_fused_tc<64>(a, dr, stream);
    case 128:
      return launch_fused_tc<128>(a, dr, stream);
    case 256:
      return launch_fused_tc<256>(a, dr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool args_ok(const Args& a, int dtype) {
  if (a.bh_count <= 0 || a.bh_count > 65535 || a.s <= 0 ||
      (dtype != 0 && dtype != 1))
    return false;
  if (a.bias_mode == kNoBias) return true;
  if (!a.bias || a.row_div <= 0 || a.row_mod <= 0) return false;
  if (a.bias_mode == kKeyBias) return !a.bias_bf16;
  return a.bias_mode == kFullBias;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               int bias_mode, int bias_bf16, int row_div, int row_mod,
               int bh_count, int s, float sm_scale, int causal, int q_off,
               int k_off) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias_mode ? bias : nullptr;
  a.bias_mode = bias_mode;
  a.bias_bf16 = bias_bf16;
  a.row_div = row_div;
  a.row_mod = row_mod;
  a.bh_count = bh_count;
  a.s = s;
  a.sm_scale = sm_scale;
  a.causal = causal;
  a.q_off = q_off;
  a.k_off = k_off;
  return a;
}

}  // namespace

// Row 6.  dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the
// tensor-core kernel) (q, k, v, o).  bias_mode: 0 none, 1 key (f32 [rows,
// S]), 2 full ([rows, S, S], bf16 when bias_bf16); row = (bh / row_div) %
// row_mod.  lse: f32 [BH, S].  drop_mode: 0 none, 1 the uint8 keep mask
// [BH, S, S], 2 Philox from (seed, offset) with threshold thresh; keep_div
// divides the kept numerator; bits_out (uint8 [BH, S, S], or null)
// receives the Philox bits drawn.  p_out and m_out, check outputs of the
// tensor-core kernel (null on the training path, and always in f32):
// p_out (bf16 [BH, S, S], zeros where a causal tile is skipped) the
// rounded p c its P . V products take, relative to the running max m_out
// (f32 [BH, S, S / 64]: the max after each key tile, left as given where a
// tile is skipped).  Returns 0, the CUDA error of a refused launch, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int flash_bhsd_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_mode, int bias_bf16, int row_div, int row_mod, void* o,
    void* lse, int bh_count, int s, int head_dim, float sm_scale, int causal,
    int q_off, int k_off, int dtype, int drop_mode, const void* mask,
    void* bits_out, unsigned long long seed, int offset, int thresh,
    float keep_div, void* p_out, void* m_out, void* stream) {
  Args a = make_args(q, k, v, bias, bias_mode, bias_bf16, row_div, row_mod,
                     bh_count, s, sm_scale, causal, q_off, k_off);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.p_out = p_out;
  a.m_out = static_cast<float*>(m_out);
  if (!args_ok(a, dtype) || !dropout_ok(drop_mode, mask, thresh, keep_div) ||
      (dtype == 0 && (p_out || m_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr =
      make_dropout(drop_mode, mask, bits_out, seed, offset, thresh, keep_div);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_d<float>(head_dim, a, dr, st);
  return launch_fwd_tc_d(head_dim, a, dr, st);
}

// Rows 7-9 on the SIMT cores (dtype 0 = float32 only; bf16 takes
// flash_bhsd_bwd_tc_launch).  part: 0 the single pass (row 7: dq, dk,
// dv, and the key dbias [BH, S] when dbias is given; dq_part is f32
// scratch [S / T, BH, S, D], T = 64, 32 at D = 256), 1 dq (row 8), 2 dk
// and dv (row 9: the full dbias [BH, S, S] f32 when dbias is given).
// lse, delta: f32 [BH, S]; dout and the gradients in the dtype; the rest
// as the forward's.
extern "C" int flash_bhsd_bwd_launch(
    int part, const void* q, const void* k, const void* v, const void* bias,
    int bias_mode, int bias_bf16, int row_div, int row_mod, const void* lse,
    const void* delta, const void* dout, void* dq, void* dk, void* dv,
    void* dq_part, void* dbias, int bh_count, int s, int head_dim,
    float sm_scale, int causal, int q_off, int k_off, int dtype,
    int drop_mode, const void* mask, unsigned long long seed, int offset,
    int thresh, float keep_div, void* stream) {
  Args a = make_args(q, k, v, bias, bias_mode, bias_bf16, row_div, row_mod,
                     bh_count, s, sm_scale, causal, q_off, k_off);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_part = static_cast<float*>(dq_part);
  a.dbias = static_cast<float*>(dbias);
  if (!args_ok(a, dtype) || dtype != 0 ||
      !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr =
      make_dropout(drop_mode, mask, nullptr, seed, offset, thresh, keep_div);
  return launch_bwd_d(head_dim, part, a, dr,
                      static_cast<cudaStream_t>(stream));
}

// Rows 7-9 on the tensor cores (dtype 1 = bfloat16): the arguments of
// flash_bhsd_bwd_launch, then three check outputs that are null on the
// training path (bf16 [BH, S, S]): p_out and ds_out receive the rounded p
// c and ds of row 7 or row 9, dsq_out row 8's ds.  Part 0 (row 7) takes
// no bias or a key bias, and dq_part as f32 scratch [S / 64, BH, S, D].
// Parts 1 and 2 (rows 8 and 9) take a full bias, f32 or bf16.
extern "C" int flash_bhsd_bwd_tc_launch(
    int part, const void* q, const void* k, const void* v, const void* bias,
    int bias_mode, int bias_bf16, int row_div, int row_mod, const void* lse,
    const void* delta, const void* dout, void* dq, void* dk, void* dv,
    void* dq_part, void* dbias, int bh_count, int s, int head_dim,
    float sm_scale, int causal, int q_off, int k_off, int dtype,
    int drop_mode, const void* mask, unsigned long long seed, int offset,
    int thresh, float keep_div, void* p_out, void* ds_out, void* dsq_out,
    void* stream) {
  Args a = make_args(q, k, v, bias, bias_mode, bias_bf16, row_div, row_mod,
                     bh_count, s, sm_scale, causal, q_off, k_off);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_part = static_cast<float*>(dq_part);
  a.dbias = static_cast<float*>(dbias);
  a.p_out = p_out;
  a.ds_out = ds_out;
  a.dsq_out = dsq_out;
  const bool fused_ok = part == kFused && bias_mode != kFullBias && !dsq_out;
  const bool split_ok = (part == kDq || part == kDkv) &&
                        bias_mode == kFullBias;
  if (!args_ok(a, dtype) || dtype != 1 || !(fused_ok || split_ok) ||
      (p_out == nullptr) != (ds_out == nullptr) ||
      !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr =
      make_dropout(drop_mode, mask, nullptr, seed, offset, thresh, keep_div);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (part == kFused) return launch_fused_tc_d(head_dim, a, dr, st);
  if (bias_bf16)
    return launch_bwd_tc_d<__nv_bfloat16>(head_dim, part, a, dr, st);
  return launch_bwd_tc_d<float>(head_dim, part, a, dr, st);
}
