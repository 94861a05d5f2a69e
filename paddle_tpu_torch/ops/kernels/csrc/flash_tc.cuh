// Fragment helpers of the flash-attention kernels on the tensor cores,
// shared by flash_attention_bsh.cu (row 5, [B, S, H] tiles) and
// flash_attention_bhsd.cu (rows 6, 8 and 9, [B, nh, S, D] tiles): the
// cp.async tile copy into the swizzled layout of hopper_mma.cuh, the
// dropout multipliers of an accumulator fragment (the explicit mask or
// the Philox bits of flash_common.cuh, drawn so that every word is used),
// and the bf16 store of an m64n64 accumulator.
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
template <int R, int D>
__device__ __forceinline__ void tile_async(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int64_t rs) {
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

// store a 64 x 64 block of f32 accumulators as bf16 rows, row stride rs
// elements
__device__ __forceinline__ void store_frag(__nv_bfloat16* dst, int64_t rs,
                                           const float (&d)[32]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + r * rs + col) =
        pack_bf16(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(dst + (r + 8) * rs + col) =
        pack_bf16(d[4 * i + 2], d[4 * i + 3]);
  }
}

}  // namespace
