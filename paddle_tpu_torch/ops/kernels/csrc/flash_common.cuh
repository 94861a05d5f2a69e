// Device helpers shared by the flash-attention kernels for Hopper
// (flash_attention_bsh.cu, the [B, S, H] layout, and
// flash_attention_bhsd.cu, the [B, nh, S, D] layout): element loads and
// stores that widen bf16 to f32, half-warp reductions, and the dropout
// of both, so that every kernel draws the same keep bits.
//
// Dropout acts on the numerator only: c = keep / keep_div.  The keep bit
// of (bh = b * nh + h, query row i, key column j) comes from
//   * an explicit uint8 mask [B, nh, Sq, Skv] (the TPU kernels' has_mask
//     path), keep_div = 1 - p;
//   * a counter-based Philox4x32-10 keyed by the 64-bit seed, at counter
//     (j, i / 4, bh, offset): word i % 4 of the result, low byte below
//     thresh = clamp(round((1 - p) * 256), 1, 256) keeps
//     (_dropout_quantized_thresh), keep_div = thresh / 256.
// The bit is a function of (seed, offset, bh, i, j) alone, not of any
// tiling, so a backward kernel regenerates its forward's bits.
//
// Included by each .cu of csrc/; every item sits in an anonymous
// namespace, local to the library that includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

// dropout modes
constexpr int kNoDrop = 0;
constexpr int kMaskDrop = 1;
constexpr int kPhiloxDrop = 2;

struct Dropout {
  int mode;               // kNoDrop, kMaskDrop or kPhiloxDrop
  const uint8_t* mask;    // [B, nh, Sq, Skv] keep bytes (kMaskDrop)
  uint8_t* bits_out;      // forward debug output of the drawn bits, or null
  uint32_t key0, key1;    // the seed (kPhiloxDrop)
  uint32_t offset;
  uint32_t thresh;        // keep iff byte < thresh (kPhiloxDrop)
  float inv_keep;         // 1 / keep_div
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// reduce over the 16 lanes of a half-warp (tx = lane & 15)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Philox4x32-10 (Salmon et al., SC'11; the constants of Random123)
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int row) {
  const int w = row & 3;
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// The multipliers c of a thread's R x C scores (rows row0 + i, columns
// col0 + 16 * j; row0 % 4 == 0 or R <= 2 with row0 even, so the rows share
// one Philox counter): keep / keep_div, or 1 without dropout.
template <int R, int C>
__device__ __forceinline__ void dropout_scale(const Dropout& dr, int bh,
                                              int sq, int skv, int row0,
                                              int col0, float (&c)[R][C],
                                              bool write_bits) {
  if (dr.mode == kNoDrop) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) c[i][j] = 1.f;
    return;
  }
  const int64_t base = (int64_t)bh * sq * skv;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = col0 + 16 * j;
    uint4 r = make_uint4(0, 0, 0, 0);
    if (dr.mode == kPhiloxDrop)
      r = philox(make_uint4(col, row0 >> 2, bh, dr.offset), dr.key0,
                 dr.key1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + i;
      const int64_t at = base + (int64_t)row * skv + col;
      bool keep;
      if (dr.mode == kPhiloxDrop) {
        keep = (word_of(r, row) & 0xFFu) < dr.thresh;
        if (write_bits && dr.bits_out) dr.bits_out[at] = keep ? 1 : 0;
      } else {
        keep = dr.mask[at] != 0;
      }
      c[i][j] = keep ? dr.inv_keep : 0.f;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

Dropout make_dropout(int mode, const void* mask, void* bits_out,
                     unsigned long long seed, int offset, int thresh,
                     float keep_div) {
  Dropout dr;
  dr.mode = mode;
  dr.mask = static_cast<const uint8_t*>(mask);
  dr.bits_out = static_cast<uint8_t*>(bits_out);
  dr.key0 = static_cast<uint32_t>(seed);
  dr.key1 = static_cast<uint32_t>(seed >> 32);
  dr.offset = static_cast<uint32_t>(offset);
  dr.thresh = static_cast<uint32_t>(thresh);
  dr.inv_keep = mode == kNoDrop ? 1.f : 1.f / keep_div;
  return dr;
}

bool dropout_ok(int mode, const void* mask, int thresh, float keep_div) {
  if (mode == kNoDrop) return true;
  if (!(keep_div > 0.f)) return false;
  if (mode == kMaskDrop) return mask != nullptr;
  return mode == kPhiloxDrop && thresh >= 1 && thresh <= 256;
}

}  // namespace
