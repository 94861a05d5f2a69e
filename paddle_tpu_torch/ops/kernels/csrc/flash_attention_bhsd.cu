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
//     recompute s and dp (two of the five products).
//
// Bound.  Forward 4 * BH * S * S * D flops (about half when causal), row
// 7 10x, row 8 6x, row 9 8x, against the dtype's peak, and the bytes of
// each kernel's inputs and outputs against 3.35 TB/s.  At the encoder's
// full-bias shapes the [B, nh, S, S] bias (67 MB in bf16) outweighs q, k,
// v and o, and rows 6, 8 and 9 each stream it once: the bytes bound.
// These kernels run f32 FMA on the SIMT cores, so they sit far above it.
//
// Design.  As the [B, S, H] kernels: one block of 256 threads owns one
// tile of T rows (T = 64, 32 at D = 256) of one bh and streams the other
// operand's tiles through shared memory; all arithmetic is f32 (bf16
// widens on load).  Thread (ty, tx) of a 16 x 16 grid holds rows
// ty * T/16 .. and columns tx + 16 j of each score tile and of each
// accumulator; row max and sum reduce over 16 lanes with xor shuffles;
// tile rows in shared memory are padded by one float.  Causal tiles that
// no row sees are skipped in all four kernels.  Later work: tensor cores
// (mma.sync / wgmma on bf16), TMA tile loads, one pass for rows 8 and 9.
//
// C interface (ctypes): flash_bhsd_fwd_launch and flash_bhsd_bwd_launch
// return cudaGetLastError() after the launch (the first failing one).
// The kernels run on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;        // forward: query rows per block
constexpr int kThreads = 256;  // 16 x 16

constexpr int kNoBias = 0;
constexpr int kKeyBias = 1;
constexpr int kFullBias = 2;

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
// shared-memory row stride TT + 1.
template <int TT>
__device__ __forceinline__ void tile_probs(const Args& a, const Dropout& dr,
                                           int bh, int64_t brow, int q0,
                                           int k0,
                                           const float (&s)[TT / 16][TT / 16],
                                           const float (&dp)[TT / 16][TT / 16],
                                           const float* lse_s,
                                           const float* delta_s, float* ps,
                                           float* dss) {
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
      if (ps) ps[rl * TP + cl] = p * cm[i][j];
      dss[rl * TP + cl] = p * (dp[i][j] * cm[i][j] - delta_s[rl]);
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
// written as dbias when asked.
template <typename T, int TT, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bhsd_bwd_kv_kernel(Args a, Dropout dr) {
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
  float dbsum = 0.f;  // FUSED: column threadIdx.x's dbias sum

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
    tile_probs<TT>(a, dr, bh, brow, q0, k0, s, dp, lse_s, delta_s, ps, dss);
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
          prow[tx + 16 * jd] = dq[i][jd] * a.sm_scale;
      }
      if (a.dbias && threadIdx.x < TT)
        for (int r = 0; r < TT; ++r) dbsum += dss[r * TP + threadIdx.x];
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
            dk[i][jd] * a.sm_scale);
      store(static_cast<T*>(a.dv) + at + tx + 16 * jd, dv[i][jd]);
    }
  }
  if (FUSED && a.dbias && threadIdx.x < TT)
    a.dbias[(int64_t)bh * a.s + k0 + threadIdx.x] = dbsum;
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
    tile_probs<TT>(a, dr, bh, brow, q0, k0, s, dp, lse_s, delta_s, nullptr,
                   dss);
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

template <typename T, int TT, int D>
int launch_bwd(int part, const Args& a, const Dropout& dr,
               cudaStream_t stream) {
  constexpr int kKv = kv_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  constexpr int kQ = dq_smem_floats<TT, D>() * static_cast<int>(sizeof(float));
  static const cudaError_t attr_fused =
      allow_smem(flash_bhsd_bwd_kv_kernel<T, TT, D, true>, kKv);
  static const cudaError_t attr_dkv =
      allow_smem(flash_bhsd_bwd_kv_kernel<T, TT, D, false>, kKv);
  static const cudaError_t attr_dq =
      allow_smem(flash_bhsd_bwd_dq_kernel<T, TT, D>, kQ);
  if (a.s % TT != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.s / TT, a.bh_count);
  if (part == kFused) {
    if (attr_fused != cudaSuccess) return static_cast<int>(attr_fused);
    if (a.bias_mode == kFullBias || !a.dq_part)
      return static_cast<int>(cudaErrorInvalidValue);
    flash_bhsd_bwd_kv_kernel<T, TT, D, true>
        <<<grid, kThreads, kKv, stream>>>(a, dr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t total = (int64_t)a.bh_count * a.s * D;
    const int64_t need = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(need < 132 * 16 ? need : 132 * 16);
    flash_bhsd_dq_sum_kernel<T, TT><<<blocks, kThreads, 0, stream>>>(a, D);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == kDq) {
    if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
    flash_bhsd_bwd_dq_kernel<T, TT, D><<<grid, kThreads, kQ, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == kDkv) {
    if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
    flash_bhsd_bwd_kv_kernel<T, TT, D, false>
        <<<grid, kThreads, kKv, stream>>>(a, dr);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bwd_d(int head_dim, int part, const Args& a, const Dropout& dr,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_bwd<T, 64, 64>(part, a, dr, stream);
    case 128:
      return launch_bwd<T, 64, 128>(part, a, dr, stream);
    case 256:
      return launch_bwd<T, 32, 256>(part, a, dr, stream);
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

// Row 6.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, o).  bias_mode: 0
// none, 1 key (f32 [rows, S]), 2 full ([rows, S, S], bf16 when bias_bf16);
// row = (bh / row_div) % row_mod.  lse: f32 [BH, S].  drop_mode: 0 none,
// 1 the uint8 keep mask [BH, S, S], 2 Philox from (seed, offset) with
// threshold thresh; keep_div divides the kept numerator; bits_out (uint8
// [BH, S, S], or null) receives the Philox bits drawn.  Returns 0, the
// CUDA error of a refused launch, or cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" int flash_bhsd_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_mode, int bias_bf16, int row_div, int row_mod, void* o,
    void* lse, int bh_count, int s, int head_dim, float sm_scale, int causal,
    int q_off, int k_off, int dtype, int drop_mode, const void* mask,
    void* bits_out, unsigned long long seed, int offset, int thresh,
    float keep_div, void* stream) {
  Args a = make_args(q, k, v, bias, bias_mode, bias_bf16, row_div, row_mod,
                     bh_count, s, sm_scale, causal, q_off, k_off);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  if (!args_ok(a, dtype) || !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr =
      make_dropout(drop_mode, mask, bits_out, seed, offset, thresh, keep_div);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_d<float>(head_dim, a, dr, st);
  return launch_fwd_d<__nv_bfloat16>(head_dim, a, dr, st);
}

// Rows 7-9.  part: 0 the single pass (row 7: dq, dk, dv, and the key
// dbias [BH, S] when dbias is given; dq_part is f32 scratch [S / T, BH,
// S, D], T = 64, 32 at D = 256), 1 dq (row 8), 2 dk and dv (row 9: the
// full dbias [BH, S, S] f32 when dbias is given).  lse, delta: f32 [BH,
// S]; dout and the gradients in the dtype; the rest as the forward's.
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
  if (!args_ok(a, dtype) || !dropout_ok(drop_mode, mask, thresh, keep_div))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr =
      make_dropout(drop_mode, mask, nullptr, seed, offset, thresh, keep_div);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_d<float>(head_dim, part, a, dr, st);
  return launch_bwd_d<__nv_bfloat16>(head_dim, part, a, dr, st);
}
