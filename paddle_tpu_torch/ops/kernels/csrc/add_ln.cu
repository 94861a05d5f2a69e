// Residual add + LayerNorm forward over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/add_ln.py _fwd_kernel
// (launched by _ln_fwd).  For every row r of x [R, H] (and y [R, H] when
// given):
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
// two f32 stats a row: bytes / 3.35 TB/s.
//
// Design.  The TPU kernel normalises a block of rows per grid step with
// the row held in VMEM.  Here one warp owns one row and holds it in
// registers: lane i loads the 4-element chunks i, i+32, i+64, ... with one
// 16-byte (f32) or 8-byte (bf16) load each, so the row is read from device
// memory once; mean and the sum of squared deviations are two xor-shuffle
// reductions over the registers (the two-pass variance, no cancellation),
// and the output is written from the same registers.  Eight warps a
// block, one row a warp, so 4096 rows make 512 blocks.  H must be a
// multiple of 4 and at most 4096 (32 chunks a lane); the wrapper checks.
//
// C interface (ctypes): add_ln_fwd_launch returns cudaGetLastError()
// after the launch.  The kernel runs on the caller's stream, allocates
// nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

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

// NCH: the most 4-element chunks a lane holds (H <= 128 * NCH)
template <typename T, int NCH, bool HAS_Y>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out,
                  float* __restrict__ mean, float* __restrict__ rstd,
                  int rows, int h, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nch = h >> 2;
  const int64_t off = (int64_t)row * h;

  float v[NCH][4];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      load4(x + off + 4 * ch, v[c]);
      if (HAS_Y) {
        float w[4];
        load4(y + off + 4 * ch, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[c][i] += w[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += v[c][i];
    }
  }
  const float mu = warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < nch) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = v[c][i] - mu;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rs = 1.f / sqrtf(warp_sum(sq) / h + eps);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch) {
      float sc[4], sh[4], o[4];
      load4(scale + 4 * ch, sc);
      load4(shift + 4 * ch, sh);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = (v[c][i] - mu) * rs * sc[i] + sh[i];
      store4(out + off + 4 * ch, o);
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T, int NCH>
int launch(const void* x, const void* y, const void* scale, const void* shift,
           void* out, void* mean, void* rstd, int rows, int h, float eps,
           cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (y)
    add_ln_fwd_kernel<T, NCH, true><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<T*>(out), static_cast<float*>(mean),
        static_cast<float*>(rstd), rows, h, eps);
  else
    add_ln_fwd_kernel<T, NCH, false><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<T*>(out),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(const void* x, const void* y, const void* scale,
             const void* shift, void* out, void* mean, void* rstd, int rows,
             int h, float eps, cudaStream_t stream) {
  if (h <= 128 * 8)
    return launch<T, 8>(x, y, scale, shift, out, mean, rstd, rows, h, eps,
                        stream);
  return launch<T, 32>(x, y, scale, shift, out, mean, rstd, rows, h, eps,
                       stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, out); scale and shift are f32.
// y may be null.  Returns 0 on success, the CUDA error code of a refused
// launch, or cudaErrorInvalidValue for an unsupported dtype or width.
extern "C" int add_ln_fwd_launch(const void* x, const void* y,
                                 const void* scale, const void* shift,
                                 void* out, void* mean, void* rstd, int rows,
                                 int h, float eps, int dtype, void* stream) {
  if (rows <= 0 || h <= 0 || h % 4 != 0 || h > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(x, y, scale, shift, out, mean, rstd, rows, h, eps,
                           s);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(x, y, scale, shift, out, mean, rstd, rows,
                                   h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
