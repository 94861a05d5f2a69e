// Residual add + LayerNorm over the last axis, forward and backward, for
// Hopper (sm_90a).
//
// Forward.  Replaces the TPU kernel paddle_tpu/ops/pallas/add_ln.py
// _fwd_kernel (launched by _ln_fwd).  For every row r of x [R, H] (and
// y [R, H] when given):
//
//     s        = x[r] + y[r]                      (f32)
//     mean[r]  = sum(s) / H
//     rstd[r]  = 1 / sqrt(sum((s - mean)^2) / H + eps)   (biased variance)
//     out[r]   = (s - mean) * rstd * scale + shift        cast to x's dtype
//
// Statistics are f32 whatever the input dtype, as in the TPU kernel; the
// wrapper hands scale/shift over as f32.
//
// Bound.  About 8 flops an element against a few bytes: memory.  The
// function reads x (and y) and writes out once, plus scale, shift and the
// two f32 stats a row: bytes / 3.35 TB/s; at BERT-base's training rows
// (4096 x 768 bf16 with the residual) 18.9 MB: 5.6 us.  What kept the
// first design from it: 8-byte bf16 loads, scale and shift read only
// after both reductions (a second dependent round trip at the end of
// every row), and one row a warp, so no warp had loads in flight while
// it reduced.
//
// Design.  The TPU kernel normalises a block of rows per grid step with
// the row held in VMEM.  Here one warp owns one row at a time and holds
// it in registers: lane i loads the VEC-element chunks i, i+32, i+64, ...
// with one 16-byte load each (8 bf16 or 4 f32; bf16 with H % 8 != 0
// takes 8-byte chunks of 4, another instantiation of the same kernel), so
// the row is read from device memory once; mean and the sum of squared
// deviations are two xor-shuffle reductions over the registers (the
// two-pass variance, no cancellation), and the output is written from the
// same registers.  The grid is one wave (the wrapper's fwd_geometry: two
// blocks an SM, eight warps a block up to H = 1024, four beyond), and
// each warp walks the rows row, row + stride, ...: up to H = 1024 the
// next row's loads are issued, as raw bits, before this row's reductions,
// so every warp keeps a row in flight while it reduces, and scale and
// shift are loaded before each row's reductions (from L1 after the first
// row), so they arrive while the row is reduced; wider rows hold one row
// in their registers and load scale and shift after.  H must be a
// multiple of 4 and at most 4096; the wrapper checks.
//
// Backward.  Replaces the TPU kernel add_ln.py _bwd_kernel (launched by
// _ln_bwd).  With the forward's mean and rstd and the cotangent g:
//
//     xhat     = (x[r] + y[r] - mean[r]) * rstd[r]        (f32)
//     gs       = g[r] * scale
//     dx[r]    = rstd[r] * (gs - mean(gs) - xhat * mean(gs * xhat))
//     dscale   = sum_r g[r] * xhat,   dshift = sum_r g[r]
//
// dx is cast to x's dtype and serves as dy too.
//
// Bound: memory (about 13 flops an element): x, y and g read and dx
// written once, plus scale and the two stats a row, bytes / 3.35 TB/s
// (at BERT-base's training rows, 4096 x 768 bf16 with the residual, 25.2
// MB: 7.5 us).  What keeps a kernel from it: reading a row twice, narrow
// loads, too few rows in flight to cover the memory latency, and the
// column sums dscale and dshift, which cross every row and so every block.
//
// Design.  One warp a row, the row read once: lane i loads chunks i, i+32,
// ... of x (+ y) and g with one 16-byte load each (8 bf16 or 4 f32; bf16
// with H % 8 != 0 takes 8-byte chunks of 4, another instantiation of the
// same kernel) and keeps them in registers for both row reductions
// (mean(gs), mean(gs * xhat): xor shuffles) and the dx store.  The grid is
// sized by rows (the wrapper's bwd_geometry: one 16-warp block an SM,
// each warp walking rows_per_block / 16 rows), so every SM holds 16 rows'
// loads in flight and the grid is one wave.  Each warp adds its rows'
// g * xhat and g into its own slice of shared memory (lane-interleaved
// float4s, no bank conflicts, rows in order); the block sums its slices in
// warp order and writes one partial row [2][H].  No second kernel sums
// those rows: the
// last block of each group of 16 to finish (an atomic ticket that wraps
// back to zero for the next call) sums its group's rows in block order
// into a group row, and the last group's block sums the group rows in
// group order into dscale and dshift.  Only the election is atomic; the
// order of every sum is fixed, so results are bit-for-bit deterministic.
// Two levels keep the tail short: one block reading every partial row
// (0.8 MB at BERT's shape) would take longer than the rest of the kernel.
// The workspace (partial rows, group rows, tickets) is the wrapper's,
// cached per device, stream and H.  H <= 1024 runs sixteen warps a block
// with the row in registers; wider rows four warps, two blocks an SM, and
// past a few thousand columns the registers spill: right, but slow.
//
// C interface (ctypes): add_ln_fwd_launch and add_ln_bwd_launch return
// cudaGetLastError() after the launch.  The kernels run on the caller's
// stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
// VEC-wide chunks: 4 (a 16-byte f32 or 8-byte bf16 load) or 8 (a 16-byte
// bf16 load)
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[4]) { load4(p, v); }
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[8]) { load8(p, v); }
template <typename T>
__device__ __forceinline__ void storev(T* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[8]) {
  store8(p, v);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// VEC-wide chunks as raw bits: 16 bytes (8 bf16 or 4 f32) or 8 bytes (4
// bf16), loaded now and widened when the row's turn comes
template <typename T, int VEC>
using raw_t = typename std::conditional<VEC * sizeof(T) == 16, uint4,
                                        uint2>::type;

__device__ __forceinline__ void widen(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen_bf16(uint32_t w, float* v) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w));
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ void widen(const uint4& r, float (&v)[8]) {
  widen_bf16(r.x, v); widen_bf16(r.y, v + 2);
  widen_bf16(r.z, v + 4); widen_bf16(r.w, v + 6);
}
__device__ __forceinline__ void widen(const uint2& r, float (&v)[4]) {
  widen_bf16(r.x, v); widen_bf16(r.y, v + 2);
}

struct FwdArgs {
  const void* x;
  const void* y;        // null without the residual
  const float* scale;
  const float* shift;
  void* out;
  float* mean;
  float* rstd;
  int rows, h;
  float eps;
};

// VEC: elements a chunk (one load a lane); NCH: the most chunks a lane
// holds (H <= 32 * VEC * NCH).  Rows of up to 32 elements a lane (H <=
// 1024) are pipelined, eight warps a block; wider rows are not (their
// registers hold one row), four warps a block.
template <int VEC, int NCH>
__host__ __device__ constexpr bool fwd_pipelined() {
  return NCH * VEC <= 32;
}
template <int VEC, int NCH>
__host__ __device__ constexpr int fwd_warps() {
  return fwd_pipelined<VEC, NCH>() ? 8 : 4;
}

// One row from its registers v (x + y, f32): mean and rstd by two xor-
// shuffle reductions (the two-pass variance), then the affine and the
// stores.  Up to H = 1024 (the pipelined rows) scale and shift are loaded
// first, so they arrive while the row is reduced; wider rows hold too
// much in registers for that and load them after the reductions.
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void fwd_row(const FwdArgs& a, int row,
                                        float (&v)[NCH][VEC]) {
  constexpr bool kEarly = fwd_pipelined<VEC, NCH>();
  constexpr int NP = kEarly ? NCH : 1;
  const int lane = threadIdx.x & 31;
  const int h = a.h;
  const int nch = h / VEC;
  float scv[NP][VEC], shv[NP][VEC];
  if constexpr (kEarly) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = lane + 32 * c;
      if (ch < nch) {
        loadv(a.scale + ch * VEC, scv[c]);
        loadv(a.shift + ch * VEC, shv[c]);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < nch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[c][i];
    }
  }
  const float mu = warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < nch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[c][i] - mu;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rs = 1.f / sqrtf(warp_sum(sq) / h + a.eps);
  T* __restrict__ out = static_cast<T*>(a.out) + (int64_t)row * h;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      if constexpr (!kEarly) {
        loadv(a.scale + ch * VEC, scv[0]);
        loadv(a.shift + ch * VEC, shv[0]);
      }
      const float* sc = scv[kEarly ? c : 0];
      const float* sh = shv[kEarly ? c : 0];
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (v[c][i] - mu) * rs * sc[i] + sh[i];
      storev(out + ch * VEC, o);
    }
  }
  if (lane == 0) {
    a.mean[row] = mu;
    a.rstd[row] = rs;
  }
}

template <typename T, int VEC, int NCH, bool HAS_Y>
__global__ void __launch_bounds__(fwd_warps<VEC, NCH>() * 32, 2)
add_ln_fwd_kernel(FwdArgs a) {
  constexpr int WARPS = fwd_warps<VEC, NCH>();
  using R = raw_t<T, VEC>;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ y = static_cast<const T*>(a.y);
  const int lane = threadIdx.x & 31;
  const int h = a.h;
  const int nch = h / VEC;
  const int stride = gridDim.x * WARPS;  // rows a wave of warps covers
  int row = blockIdx.x * WARPS + (threadIdx.x >> 5);

  float v[NCH][VEC];
  if constexpr (fwd_pipelined<VEC, NCH>()) {
    // the warp walks rows row, row + stride, ...; the next row's loads
    // are issued, as raw bits, before this row's reductions
    R rx[NCH], ry[NCH];
    auto fetch = [&](int r) {
      const int64_t off = (int64_t)r * h;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = lane + 32 * c;
        if (ch < nch) {
          rx[c] = *reinterpret_cast<const R*>(x + off + ch * VEC);
          if (HAS_Y) ry[c] = *reinterpret_cast<const R*>(y + off + ch * VEC);
        }
      }
    };
    if (row < a.rows) fetch(row);
    for (; row < a.rows; row += stride) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (lane + 32 * c < nch) {
          widen(rx[c], v[c]);
          if (HAS_Y) {
            float w[VEC];
            widen(ry[c], w);
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[c][i] += w[i];
          }
        }
      }
      if (row + stride < a.rows) fetch(row + stride);
      fwd_row<T, VEC, NCH>(a, row, v);
    }
  } else {
    // wide rows: one row in the registers at a time
    for (; row < a.rows; row += stride) {
      const int64_t off = (int64_t)row * h;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = lane + 32 * c;
        if (ch < nch) {
          loadv(x + off + ch * VEC, v[c]);
          if (HAS_Y) {
            float w[VEC];
            loadv(y + off + ch * VEC, w);
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[c][i] += w[i];
          }
        }
      }
      fwd_row<T, VEC, NCH>(a, row, v);
    }
  }
}

template <typename T, int VEC, int NCH>
int launch_fwd(const FwdArgs& a, int nblocks, int threads,
               cudaStream_t stream) {
  if (threads != fwd_warps<VEC, NCH>() * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.y)
    add_ln_fwd_kernel<T, VEC, NCH, true><<<nblocks, threads, 0, stream>>>(a);
  else
    add_ln_fwd_kernel<T, VEC, NCH, false><<<nblocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the narrowest instantiation that holds a lane's chunks
template <typename T, int VEC>
int launch_fwd_v(const FwdArgs& a, int nblocks, int threads,
                 cudaStream_t stream) {
  const int per_lane = (a.h / VEC + 31) / 32;
  if (per_lane <= 2) return launch_fwd<T, VEC, 2>(a, nblocks, threads, stream);
  if (per_lane <= 3) return launch_fwd<T, VEC, 3>(a, nblocks, threads, stream);
  if (per_lane <= 4) return launch_fwd<T, VEC, 4>(a, nblocks, threads, stream);
  if (per_lane <= 6) return launch_fwd<T, VEC, 6>(a, nblocks, threads, stream);
  if (per_lane <= 8) return launch_fwd<T, VEC, 8>(a, nblocks, threads, stream);
  if (per_lane <= 16)
    return launch_fwd<T, VEC, 16>(a, nblocks, threads, stream);
  if constexpr (VEC == 4)
    if (per_lane <= 32)
      return launch_fwd<T, 4, 32>(a, nblocks, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kGroup = 16;  // block partial rows that one group sum takes

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Called by every thread after the block's writes to device memory: true
// in the one block of the n sharing `ticket` that arrives last.  The
// barrier orders the block's writes before thread 0's fence, which
// publishes them before its ticket (the release of a semaphore).  The
// atomicInc wraps at n - 1, so the last block also leaves the ticket at 0
// for the next call.
__device__ __forceinline__ bool finished_last(unsigned* ticket, int n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(ticket, static_cast<unsigned>(n - 1)) ==
           static_cast<unsigned>(n - 1);
  }
  __syncthreads();
  return last;
}

// out[i] = rows[0][i] + rows[1][i] + ... + rows[n-1][i], in that order, for
// i < len (rows len floats apart, read from L2: other blocks wrote them);
// the second half of a row goes to out1 when it is given.
__device__ __forceinline__ void sum_rows(const float* rows, int n, int len,
                                         float* out0, float* out1) {
  const int half = len / 2;
  for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x) {
    float4 t = __ldcg(reinterpret_cast<const float4*>(rows + i));
#pragma unroll 4
    for (int r = 1; r < n; ++r)
      add4(t, __ldcg(reinterpret_cast<const float4*>(rows + (int64_t)r * len
                                                     + i)));
    float* dst = out1 && i >= half ? out1 + (i - half) : out0 + i;
    *reinterpret_cast<float4*>(dst) = t;
  }
}

struct BwdArgs {
  const void* x;
  const void* y;        // null without the residual
  const float* scale;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  float* dscale;
  float* dshift;
  float* part;          // [nblocks + ngroups][2][h]: block rows, group rows
  unsigned* ticket;     // [1 + ngroups], 0 between calls
  int rows, h, rows_per_block;
};

// VEC: elements a chunk (one load a lane); NCH: the most chunks a lane
// holds (H <= 32 * VEC * NCH).  Sixteen warps a block up to H = 1024, four
// beyond (the partial sums' shared memory grows with H).
template <int VEC, int NCH>
__host__ __device__ constexpr int bwd_warps() {
  return NCH * VEC <= 32 ? 16 : 4;
}
template <int VEC, int NCH>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return bwd_warps<VEC, NCH>() * 2 * NCH * (VEC / 4) * 32 * 16;
}

// The row at off, read once: x (+ y) into v and g into gg, one VEC-wide
// chunk a load (lane, lane + 32, ...)
template <typename T, int VEC, int NCH, bool HAS_Y>
__device__ __forceinline__ void bwd_load(const T* __restrict__ x,
                                         const T* __restrict__ y,
                                         const T* __restrict__ g,
                                         int64_t off, int nch,
                                         float (&v)[NCH][VEC],
                                         float (&gg)[NCH][VEC]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      loadv(x + off + ch * VEC, v[c]);
      if (HAS_Y) {
        float w[VEC];
        loadv(y + off + ch * VEC, w);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] += w[i];
      }
      loadv(g + off + ch * VEC, gg[c]);
    }
  }
}

// One row from its registers: its g * xhat and g added into the warp's
// slice `mine` of the column sums, its two row sums, and dx.
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void bwd_row(const BwdArgs& a, float4* mine,
                                        T* __restrict__ dx, int row, int nch,
                                        float (&v)[NCH][VEC],
                                        float (&gg)[NCH][VEC]) {
  constexpr int Q4 = VEC / 4;
  constexpr int SLOTS = NCH * Q4 * 32;
  const int lane = threadIdx.x & 31;
  const int64_t off = (int64_t)row * a.h;
  const float mu = a.mean[row];
  const float rs = a.rstd[row];
  // xhat and g * scale replace the row in place
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      float sc[VEC];
      loadv(a.scale + ch * VEC, sc);
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        float4* psc = mine + (c * Q4 + q) * 32 + lane;
        float4* psh = psc + SLOTS;
        float4 u = *psc, w = *psh;
        float* uf = reinterpret_cast<float*>(&u);
        float* wf = reinterpret_cast<float*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float xh = (v[c][i] - mu) * rs;
          const float gs = gg[c][i] * sc[i];
          uf[e] = fmaf(gg[c][i], xh, uf[e]);
          wf[e] += gg[c][i];
          s1 += gs;
          s2 = fmaf(gs, xh, s2);
          v[c][i] = xh;
          gg[c][i] = gs;
        }
        *psc = u;
        *psh = w;
      }
    }
  }
  const float inv_h = 1.f / a.h;
  const float m1 = warp_sum(s1) * inv_h;
  const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = rs * (gg[c][i] - m1 - v[c][i] * m2);
      storev(dx + off + ch * VEC, o);
    }
  }
}

template <typename T, int VEC, int NCH, bool HAS_Y>
__global__ void __launch_bounds__(bwd_warps<VEC, NCH>() * 32, 1)
add_ln_bwd_kernel(BwdArgs a) {
  constexpr int WARPS = bwd_warps<VEC, NCH>();
  constexpr int Q4 = VEC / 4;            // float4s a chunk
  constexpr int SLOTS = NCH * Q4 * 32;   // float4s of one warp's one sum
  // [WARPS][2][NCH * Q4][32]: each warp's column sums of g * xhat and g
  // over its rows, lane-interleaved so a warp's float4 access is one
  // contiguous 512-byte line (no bank conflicts)
  extern __shared__ float4 red[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ y = static_cast<const T*>(a.y);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = a.h;
  const int nch = h / VEC;

  float4* mine = red + warp * 2 * SLOTS;
  for (int s = lane; s < 2 * SLOTS; s += 32)
    mine[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int r1 = min(a.rows, (blockIdx.x + 1) * a.rows_per_block);
  for (int row = blockIdx.x * a.rows_per_block + warp; row < r1;
       row += WARPS) {
    float v[NCH][VEC], gg[NCH][VEC];
    bwd_load<T, VEC, NCH, HAS_Y>(x, y, g, (int64_t)row * h, nch, v, gg);
    bwd_row<T, VEC, NCH>(a, mine, dx, row, nch, v, gg);
  }
  __syncthreads();

  // the block's partial row: every slot summed over the warps in order
  const int nblocks = gridDim.x;
  for (int s = threadIdx.x; s < 2 * SLOTS; s += WARPS * 32) {
    const int which = s / SLOTS;
    const int cq = (s - which * SLOTS) >> 5;
    const int ch = (s & 31) + 32 * (cq / Q4);
    if (ch >= nch) continue;
    float4 t = red[s];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) add4(t, red[w * 2 * SLOTS + s]);
    *reinterpret_cast<float4*>(a.part + ((int64_t)blockIdx.x * 2 + which) * h
                               + ch * VEC + 4 * (cq % Q4)) = t;
  }

  // The last block of each group of kGroup sums the group's rows (in block
  // order) into a group row; the last group's block sums the group rows (in
  // group order) into dscale and dshift.  Only the election is atomic.
  const int grp = blockIdx.x / kGroup;
  const int g0 = grp * kGroup;
  const int ngroups = (nblocks + kGroup - 1) / kGroup;
  if (!finished_last(a.ticket + 1 + grp, min(kGroup, nblocks - g0))) return;
  float* group_rows = a.part + (int64_t)nblocks * 2 * h;
  sum_rows(a.part + (int64_t)g0 * 2 * h, min(kGroup, nblocks - g0), 2 * h,
           group_rows + (int64_t)grp * 2 * h, nullptr);
  if (!finished_last(a.ticket, ngroups)) return;
  sum_rows(group_rows, ngroups, 2 * h, a.dscale, a.dshift);
}

template <typename T, int VEC, int NCH>
int launch_bwd(const BwdArgs& a, int nblocks, int threads,
               cudaStream_t stream) {
  constexpr int kSmem = bwd_smem_bytes<VEC, NCH>();
  if (threads != bwd_warps<VEC, NCH>() * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.y) {
    static const cudaError_t attr =
        allow_smem(add_ln_bwd_kernel<T, VEC, NCH, true>, kSmem);  // once
    if (attr != cudaSuccess) return static_cast<int>(attr);
    add_ln_bwd_kernel<T, VEC, NCH, true><<<nblocks, threads, kSmem, stream>>>(a);
  } else {
    static const cudaError_t attr =
        allow_smem(add_ln_bwd_kernel<T, VEC, NCH, false>, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    add_ln_bwd_kernel<T, VEC, NCH, false><<<nblocks, threads, kSmem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the narrowest instantiation that holds a lane's chunks
template <typename T, int VEC>
int launch_bwd_v(const BwdArgs& a, int nblocks, int threads,
                 cudaStream_t stream) {
  const int per_lane = (a.h / VEC + 31) / 32;
  if (per_lane <= 2) return launch_bwd<T, VEC, 2>(a, nblocks, threads, stream);
  if (per_lane <= 3) return launch_bwd<T, VEC, 3>(a, nblocks, threads, stream);
  if (per_lane <= 4) return launch_bwd<T, VEC, 4>(a, nblocks, threads, stream);
  if (per_lane <= 6) return launch_bwd<T, VEC, 6>(a, nblocks, threads, stream);
  if (per_lane <= 8) return launch_bwd<T, VEC, 8>(a, nblocks, threads, stream);
  if (per_lane <= 16)
    return launch_bwd<T, VEC, 16>(a, nblocks, threads, stream);
  if constexpr (VEC == 4)
    if (per_lane <= 32)
      return launch_bwd<T, 4, 32>(a, nblocks, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, out); scale and shift are f32.
// y may be null.  nblocks and threads come from the wrapper's
// fwd_geometry (threads 256 up to h = 1024, 128 beyond); the warps walk
// the rows with a stride of nblocks * threads / 32.  Returns 0 on
// success, the CUDA error code of a refused launch, or
// cudaErrorInvalidValue for an unsupported dtype, width or geometry.
extern "C" int add_ln_fwd_launch(const void* x, const void* y,
                                 const void* scale, const void* shift,
                                 void* out, void* mean, void* rstd, int rows,
                                 int h, float eps, int nblocks, int threads,
                                 int dtype, void* stream) {
  if (rows <= 0 || h <= 0 || h % 4 != 0 || h > 4096 || nblocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a = {x, y, static_cast<const float*>(scale),
                     static_cast<const float*>(shift), out,
                     static_cast<float*>(mean), static_cast<float*>(rstd),
                     rows, h, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_v<float, 4>(a, nblocks, threads, s);
  if (dtype == 1)
    return h % 8 == 0
               ? launch_fwd_v<__nv_bfloat16, 8>(a, nblocks, threads, s)
               : launch_fwd_v<__nv_bfloat16, 4>(a, nblocks, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (x, y, g, dx); scale, mean, rstd,
// dscale and dshift are f32.  y may be null.  part is the f32 workspace
// [nblocks + ngroups][2][h] and ticket the [1 + ngroups] counters, zero
// before the first call (each call leaves them at zero), with nblocks =
// ceil(rows / rows_per_block), ngroups = ceil(nblocks / 16) and threads
// 512 up to h = 1024, 128 beyond.  Returns 0 on success, the CUDA error
// code of a refused launch, or cudaErrorInvalidValue for an unsupported
// dtype, width or geometry.
extern "C" int add_ln_bwd_launch(const void* x, const void* y,
                                 const void* scale, const void* mean,
                                 const void* rstd, const void* g, void* dx,
                                 void* dscale, void* dshift, void* part,
                                 void* ticket, int rows, int h,
                                 int rows_per_block, int nblocks,
                                 int threads, int dtype, void* stream) {
  if (rows <= 0 || h <= 0 || h % 4 != 0 || h > 4096 || rows_per_block <= 0
      || nblocks != (rows + rows_per_block - 1) / rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {x, y, static_cast<const float*>(scale),
                     static_cast<const float*>(mean),
                     static_cast<const float*>(rstd), g, dx,
                     static_cast<float*>(dscale), static_cast<float*>(dshift),
                     static_cast<float*>(part),
                     static_cast<unsigned*>(ticket), rows, h,
                     rows_per_block};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_v<float, 4>(a, nblocks, threads, s);
  if (dtype == 1)
    return h % 8 == 0
               ? launch_bwd_v<__nv_bfloat16, 8>(a, nblocks, threads, s)
               : launch_bwd_v<__nv_bfloat16, 4>(a, nblocks, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
