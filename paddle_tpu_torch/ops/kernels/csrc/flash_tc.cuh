// Fragment helpers of the flash-attention kernels on the tensor cores,
// shared by flash_attention_bsh.cu (rows 4 and 5, [B, S, H] tiles) and
// flash_attention_bhsd.cu (rows 6-9, [B, nh, S, D] tiles): the cp.async
// tile copy into the swizzled layout of hopper_mma.cuh, the staged bias
// tiles, the dropout multipliers of an accumulator fragment (the explicit
// mask or the Philox bits of flash_common.cuh, drawn so that every word
// is used), the 16-bit store of an m64n64 accumulator, and the forward of
// one 64-query tile (fwd_tc_tile), which rows 4 and 6 both run: the one
// forward body, whatever the layout.  Each takes the operands' element
// type E (hopper_mma.cuh): bf16, or __half for row 4's f16 form.
//
// Every item sits in an anonymous namespace, local to the library that
// includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kTcRows = 64;  // rows of a warpgroup's tile: M of every wgmma

// cp.async an R x D tile (R rows from src, row stride rs elements: H of
// [B, S, H], D of [B, nh, S, D]) into D / 64 swizzled column blocks of R
// rows
template <int R, int D, typename E>
__device__ __forceinline__ void tile_async(uint32_t dst, const E* src,
                                           int64_t rs) {
  static_assert(sizeof(E) == 2, "16-bit operands: 8 a 16-byte chunk");
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < R * CH; idx += 128) {
    const int r = idx / CH, ch = idx - r * CH;
    cp_async16(dst + (ch >> 3) * (R * 128) + swz128(r, ch & 7),
               src + r * rs + ch * 8, true);
  }
}

__device__ __forceinline__ uint32_t pick4(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ float keep_mult(const Dropout& dr, uint32_t word) {
  return (word & 0xFFu) < dr.thresh ? dr.inv_keep : 0.f;
}

// Dropout multipliers c of an accumulator fragment of NB n8 blocks whose
// rows are KEYS (row0 and row0 + 8, absolute) and columns QUERIES (col0 +
// 8 i + 2 t + {0, 1}): a dk/dv kernel's S^T.  The lanes t and t ^ 1
// need the same two Philox counters (key, query / 4): the even lane draws
// the one of row0, the odd lane the one of row0 + 8, and each passes the
// two words the other needs by one shuffle, so every word drawn is used.
template <int NB>
__device__ __forceinline__ void drop_keys_by_queries(const Dropout& dr,
                                                     int bh, int sq, int skv,
                                                     int row0, int col0,
                                                     float (&c)[4 * NB]) {
  const int t = threadIdx.x & 3;
  if (dr.mode == kNoDrop) {
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) c[i] = 1.f;
    return;
  }
  if (dr.mode == kMaskDrop) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = row0 + ((e & 2) ? 8 : 0);
        const int q = col0 + 8 * i + 2 * t + (e & 1);
        c[4 * i + e] =
            dr.mask[((int64_t)bh * sq + q) * skv + key] ? dr.inv_keep : 0.f;
      }
    return;
  }
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int qg = (col0 + 8 * i + 2 * t) >> 2;
    const uint4 r = philox(
        make_uint4(row0 + (odd ? 8 : 0), qg, bh, dr.offset), dr.key0,
        dr.key1);
    const uint32_t g0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
    const uint32_t g1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
    c[4 * i + 0] = keep_mult(dr, odd ? g0 : r.x);
    c[4 * i + 1] = keep_mult(dr, odd ? g1 : r.y);
    c[4 * i + 2] = keep_mult(dr, odd ? r.z : g0);
    c[4 * i + 3] = keep_mult(dr, odd ? r.w : g1);
  }
}

// The same for a fragment whose rows are QUERIES (row0, row0 + 8) and
// columns KEYS (col0 + 8 i + 2 t + {0, 1}): a dq kernel's or the
// forward's S.  The four
// lanes g = 4 a + s (s = 0..3) of one t hold 4 consecutive queries, the
// 4 words of each counter: lane s draws counter s of the block's four
// (key 2t or 2t + 1, query row0 or row0 + 8) and three xor shuffles
// transpose the 4 x 4 words.
template <int NB>
__device__ __forceinline__ void drop_queries_by_keys(const Dropout& dr,
                                                     int bh, int sq, int skv,
                                                     int row0, int col0,
                                                     float (&c)[4 * NB]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, s = (lane >> 2) & 3;
  if (dr.mode == kNoDrop) {
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) c[i] = 1.f;
    return;
  }
  if (dr.mode == kMaskDrop) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = row0 + ((e & 2) ? 8 : 0);
        const int key = col0 + 8 * i + 2 * t + (e & 1);
        c[4 * i + e] =
            dr.mask[((int64_t)bh * sq + q) * skv + key] ? dr.inv_keep : 0.f;
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const uint4 r = philox(
        make_uint4(col0 + 8 * i + 2 * t + (s & 1),
                   (row0 >> 2) + ((s & 2) ? 2 : 0), bh, dr.offset),
        dr.key0, dr.key1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, pick4(r, s ^ 1), 4);
    const uint32_t r2 = __shfl_xor_sync(0xffffffffu, pick4(r, s ^ 2), 8);
    const uint32_t r3 = __shfl_xor_sync(0xffffffffu, pick4(r, s ^ 3), 12);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = m ^ s;  // the round that brought counter m's word s
      const uint32_t wd = k == 0 ? pick4(r, s) : k == 1 ? r1 : k == 2 ? r2
                                                                      : r3;
      c[4 * i + m] = keep_mult(dr, wd);
    }
  }
}

// store a 64 x 64 block of f32 accumulators as E rows (bf16 or f16), row
// stride rs elements
template <typename E>
__device__ __forceinline__ void store_frag(E* dst, int64_t rs,
                                           const float (&d)[32]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + r * rs + col) =
        pack2<E>(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(dst + (r + 8) * rs + col) =
        pack2<E>(d[4 * i + 2], d[4 * i + 3]);
  }
}

// bias modes of the staged bias tile
constexpr int kNoBias = 0;
constexpr int kKeyBias = 1;
constexpr int kFullBias = 2;

// a staged bias row: 64 keys and a pad that keeps the dk/dv kernel's
// transposed read of a fragment's bias (row = key) free of bank
// conflicts, and the dq kernel's (row = query) too for a bf16 bias (an
// f32 one takes 2-way conflicts there)
template <typename BT>
__host__ __device__ constexpr int bias_pitch() {
  return 64 + 16 / static_cast<int>(sizeof(BT));
}

template <typename BT>
__host__ __device__ constexpr int bias_tile_bytes(int rows) {
  return rows * bias_pitch<BT>() * static_cast<int>(sizeof(BT));
}

// cp.async R rows of 64 bias values (row stride s elements) into rows of
// bias_pitch<BT>() at dst
template <int R, typename BT>
__device__ __forceinline__ void bias_async(uint32_t dst, const BT* src,
                                           int s) {
  constexpr int CH = 64 * static_cast<int>(sizeof(BT)) / 16;  // chunks a row
  constexpr int EL = 16 / static_cast<int>(sizeof(BT));       // values a chunk
  constexpr int P = bias_pitch<BT>() * static_cast<int>(sizeof(BT));
  for (int idx = threadIdx.x; idx < R * CH; idx += 128) {
    const int r = idx / CH, ch = idx - r * CH;
    cp_async16(dst + r * P + ch * 16, src + (int64_t)r * s + ch * EL, true);
  }
}

// m and l of one query row over the quad of lanes that holds it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// the forward of one 64-query tile (rows 4 and 6)
// ---------------------------------------------------------------------------

// shared memory of the bias tile of one key tile: a full bias's 64 query
// rows, a key bias's 64 values
template <int BMODE, typename BT>
__host__ __device__ constexpr int fwd_bias_bytes() {
  return BMODE == kFullBias ? bias_tile_bytes<BT>(kTcRows)
                            : BMODE == kKeyBias ? 64 * 4 : 0;
}

template <int D, int DO, int BMODE, typename BT>
constexpr int fwd_tc_smem_bytes() {
  return kTcRows * D * 2 + 2 * kTcRows * (D + DO) * 2 +
         2 * fwd_bias_bytes<BMODE, BT>() + 1024;
}

// One block's part of the forward, its pointers already at the block's
// head (b, h) and slice, whatever the layout: [B, S, H] rows (row 4) or
// [B, nh, S, D] rows (row 6) differ only in the row stride.
template <typename E = __nv_bfloat16>
struct FwdTileT {
  const E* q;              // query row q0, column 0 of the head
  const E* k;              // key row 0, column 0 of the head
  const E* v;              // key row 0, the slice's first column
  E* o;                    // query row q0, the slice's first column
  int64_t rs;              // row stride of q, k, v and o (elements)
  const void* bias;        // key: f32 at key 0; full: [Sq, Skv] rows at
                           // query row q0; null without a bias
  float* lse;              // at query row q0 of bh ([BH, Sq])
  E* p_out;                // check outputs [BH, Sq, Skv] and [BH, Sq,
  float* m_out;            // Skv / 64], or null
  int bh, sq, skv, q0, nk; // nk: the key tiles this query tile visits
  int causal, q_off, k_off;
  float sm_scale;
  int checks;              // this slice writes lse and the check outputs
};
using FwdTile = FwdTileT<>;

// o and lse of one (64-query tile, bh, DO-column slice of the head): one
// warpgroup; Q lands once, the key tiles (64 rows of k, the slice of v,
// and the bias tile: a full bias's [64 queries x 64 keys], a key bias's
// 64 values) stream through a 2-stage cp.async ring.  Per key tile: S = Q
// . K^T (wgmma, K-major B), with the dropout multipliers (Philox:
// arithmetic alone) drawn while it runs, then in registers the scores
// (scale, bias in f32, p = 0 at a masked score), the online softmax (row
// max and sum over the quad of lanes that holds a row, exp by the ex2
// unit; l sums the undropped p), and p c rounded to E as the A operand
// of O += (p c) . V (V MN-major), after O is rescaled by alpha = exp(m -
// m_new) (the previous tile's P . V has retired by then): p c is rounded
// relative to the running max of the key tiles seen so far.  A row that
// sees no key keeps m = NEG_INF, alpha = 1, l = 0: o = 0, lse = NEG_INF.
// The slice f.checks writes lse and the check outputs.
template <int D, int DO, int BMODE, typename BT, typename E>
__device__ __forceinline__ void fwd_tc_tile(const FwdTileT<E>& f,
                                            const Dropout& dr) {
  constexpr int T_BYTES = kTcRows * D * 2;     // the Q tile, a K tile
  constexpr int STAGE = T_BYTES + kTcRows * DO * 2;   // K, then V's slice
  constexpr int NB = kTcRows / 8;
  constexpr int BP = bias_pitch<BT>();
  constexpr int BIAS_BYTES = fwd_bias_bytes<BMODE, BT>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t qs = raw + pad;
  const uint32_t kv0 = qs + T_BYTES;   // stage st at kv0 + st * STAGE
  uint8_t* bias_p = smem_raw + pad + T_BYTES + 2 * STAGE;  // [2] tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = f.q0, nk = f.nk, skv = f.skv;
  const BT* biasb = static_cast<const BT*>(f.bias);

  auto load_kv = [&](int kt, int st) {
    const uint32_t kd = kv0 + st * STAGE;
    const int64_t at = (int64_t)kt * kTcRows * f.rs;
    tile_async<kTcRows, D>(kd, f.k + at, f.rs);
    tile_async<kTcRows, DO>(kd + T_BYTES, f.v + at, f.rs);
    const uint32_t bd = smem_u32(bias_p + st * BIAS_BYTES);
    if constexpr (BMODE == kFullBias)
      bias_async<kTcRows, BT>(bd, biasb + kt * kTcRows, skv);
    else if constexpr (BMODE == kKeyBias)
      bias_async<1, BT>(bd, biasb + kt * kTcRows, skv);
  };

  tile_async<kTcRows, D>(qs, f.q, f.rs);
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  const int qr0 = 16 * warp + g;  // this thread's query rows qr0, qr0 + 8
  const float scale = f.sm_scale;
  // masked: causal and key k_off + col above query q_off + row
  const int diag = f.causal ? f.q_off - f.k_off + q0 + qr0 : 0x3fffffff;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[DO / 64][32];
#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) zero(o[cb]);

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();   // this key tile (and, first, Q) has landed
    fence_async_smem();
    __syncthreads();      // for every thread; the other stage is free
    if (kt + 1 < nk) load_kv(kt + 1, st ^ 1);
    cp_async_commit();

    const uint32_t kd = kv0 + st * STAGE, vd = kd + T_BYTES;
    const BT* bias_t = reinterpret_cast<const BT*>(bias_p + st * BIAS_BYTES);
    float sacc[32];
    zero(sacc);
    fence_regs(sacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kTcRows * 128) + (kk & 3) * 32;
      wgmma_ss<64, 0, E>(sacc, desc_sw128(qs + off), desc_sw128(kd + off));
    }
    wg_commit();
    // the dropout multipliers (Philox: arithmetic alone) while the
    // products run
    const int k0 = kt * kTcRows;
    float cm[32];
    drop_queries_by_keys<NB>(dr, f.bh, f.sq, skv, q0 + qr0, k0, cm);
    wg_wait<0>();
    fence_regs(sacc);

    // the scores and their row maxima (a masked score is NEG_INF)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int qr = qr0 + ((e & 2) ? 8 : 0);
        const int kc = 8 * i + 2 * t + (e & 1);
        float x = sacc[idx] * scale;
        if constexpr (BMODE == kFullBias) x += to_float(bias_t[qr * BP + kc]);
        if constexpr (BMODE == kKeyBias) x += to_float(bias_t[kc]);
        if (k0 + kc > diag + ((e & 2) ? 8 : 0)) x = kNegInf;
        sacc[idx] = x;
        if (e & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // alpha = 1 where the max did not move: also in a row that has seen
    // no key yet (m = m_new = NEG_INF), never exp(NEG_INF - NEG_INF)
    const float al0 = mn0 == m0 ? 1.f : __expf(m0 - mn0);
    const float al1 = mn1 == m1 ? 1.f : __expf(m1 - mn1);

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int qr = qr0 + ((e & 2) ? 8 : 0);
        const int kc = 8 * i + 2 * t + (e & 1);
        // p = 0 at a masked score, also in a row that sees no key
        const float p = k0 + kc > diag + ((e & 2) ? 8 : 0)
                            ? 0.f
                            : __expf(sacc[idx] - ((e & 2) ? mn1 : mn0));
        if (e & 2)
          rs1 += p;
        else
          rs0 += p;
        sacc[idx] = p * cm[idx];   // p c: the numerator only
        if (f.checks && (f.p_out || dr.bits_out)) {
          const int64_t at = ((int64_t)f.bh * f.sq + q0 + qr) * skv + k0 + kc;
          if (f.p_out) f.p_out[at] = round_to<E>(sacc[idx]);
          if (dr.bits_out) dr.bits_out[at] = cm[idx] != 0.f ? 1 : 0;
        }
      }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
    if (f.checks && f.m_out && t == 0) {
      const int64_t at =
          ((int64_t)f.bh * f.sq + q0 + qr0) * (skv / kTcRows) + kt;
      f.m_out[at] = mn0;
      f.m_out[at + 8 * (skv / kTcRows)] = mn1;
    }

    // O = O alpha + (p c) . V: the previous tile's products have retired
    // (wg_wait<0> below), so the accumulators may be rescaled here
#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        o[cb][4 * i] *= al0;
        o[cb][4 * i + 1] *= al0;
        o[cb][4 * i + 2] *= al1;
        o[cb][4 * i + 3] *= al1;
      }
      fence_regs(o[cb]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t pa[4];
      a_frag<E>(sacc, kk, pa);
#pragma unroll
      for (int cb = 0; cb < DO / 64; ++cb)
        wgmma_rs_n64<1, E>(o[cb], pa,
                        desc_sw128(vd + cb * (kTcRows * 128) + kk * 16 * 128));
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < DO / 64; ++cb) fence_regs(o[cb]);
  }
  cp_async_wait<0>();

  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int cb = 0; cb < DO / 64; ++cb) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      o[cb][4 * i] /= ls0;
      o[cb][4 * i + 1] /= ls0;
      o[cb][4 * i + 2] /= ls1;
      o[cb][4 * i + 3] /= ls1;
    }
    store_frag(f.o + cb * 64, f.rs, o[cb]);
  }
  if (f.checks && t == 0) {
    f.lse[qr0] = m0 + logf(ls0);
    f.lse[qr0 + 8] = m1 + logf(ls1);
  }
}

}  // namespace
