// Flash-attention forward over head-interleaved [B, S, H] tensors for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// _make_fwd_bsh_kernel (launched by _flash_fwd_bsh).  For batch b, head h
// (H = nh * D, head h owns columns [h*D, (h+1)*D) of every row) and query
// row i:
//
//     s[j]   = q[b,i,h] . k[b,j,h] * sm_scale + bias[b,j]   (-1e30 above
//              the diagonal when causal)
//     o[b,i,h] = sum_j softmax(s)[j] v[b,j,h]
//     lse[b,h,i] = m + log(max(l, 1e-30))
//
// with the online softmax of the TPU kernel: m starts at -1e30, each key
// tile updates m_new = max(m, max s), l = l*exp(m - m_new) + sum exp(s -
// m_new), acc = acc*exp(m - m_new) + p v, and the output is acc /
// max(l, 1e-30).  sm_scale is folded into q when it is a power of two
// (prescale, as _prescale_ok decides), otherwise it multiplies the
// scores.  The optional bias is one f32 value per key ([B, 1, Skv]: the
// BERT padding mask).  Dropout is not done here: the wrapper refuses a
// nonzero dropout_prob on the card.
//
// Bound.  4*B*nh*Sq*Skv*D flops (half of it when causal) against the
// card's float32 rate outside the tensor cores (this kernel runs FMA on
// the SIMT cores), and the bytes of q, k, v, bias, o and lse against
// 3.35 TB/s; at BERT-base's shapes (S = 512, D = 64) the flops bound.
//
// Design.  The TPU kernel walks a (batch, query block) grid and keeps a
// whole sequence of K/V resident in VMEM.  Here one block of 256 threads
// owns one (query tile of 64 rows, head, batch) triple, so B*nh*Sq/64
// blocks fill the 132 SMs, and streams its head's K/V in tiles of BK rows
// through shared memory, reading the head's D-column slice straight from
// the [B, S, H] rows: no head split or merge transposes.  All arithmetic
// is f32 (bf16 inputs widen on load).  Thread (ty, tx) of a 16 x 16 grid
// holds query rows ty*4 .. ty*4+3, score columns tx + 16*j and output
// columns tx + 16*j in registers; row max and row sum reduce over the 16
// lanes of a half-warp with xor shuffles.  The probabilities pass through
// shared memory to the P.V product.  Rows of Q and K in shared memory are
// padded by one float, so the 16 lanes reading 16 different K rows hit 16
// banks.  A causal block skips the key tiles above its diagonal, as
// _hi_blocks does.
//
// Later work, not done here: tensor cores (mma.sync / wgmma on bf16),
// TMA or cp.async tile loads, and keeping P in registers.
//
// C interface (ctypes): flash_attention_bsh_launch returns
// cudaGetLastError() after the launch.  The kernel runs on the caller's
// stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBQ = 64;            // query rows per block
constexpr int kThreads = 256;      // 16 x 16

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

template <int D, int BK>
constexpr int smem_floats() {
  return kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bsh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int skv, int nh, float sm_scale, int prescale,
                     int causal) {
  constexpr int DP = D + 1;   // padded row stride of Q and K tiles
  constexpr int BKP = BK + 1;  // padded row stride of the P tile
  constexpr int NJ = BK / 16;  // score columns per thread
  constexpr int ND = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][DP]
  float* ks = qs + kBQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [kBQ][BKP]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t hstride = (int64_t)nh * D;  // between rows of [B, S, H]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* __restrict__ qb = q + ((int64_t)b * sq + q0) * hstride + h * D;
  const T* __restrict__ kb = k + (int64_t)b * skv * hstride + h * D;
  const T* __restrict__ vb = v + (int64_t)b * skv * hstride + h * D;
  const float* __restrict__ biasb = bias ? bias + (int64_t)b * skv : nullptr;

  // q * sm_scale is exact when sm_scale is a power of two
  const float qmul = prescale ? sm_scale : 1.f;
  const float smul = prescale ? 1.f : sm_scale;
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r * DP + c] = to_float(qb[r * hstride + c]) * qmul;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }

  int nk = skv / BK;
  if (causal) nk = min(nk, (q0 + kBQ + BK - 1) / BK);

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int64_t g = (int64_t)(k0 + r) * hstride + c;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * smul;
        if (biasb) x += biasb[col];
        if (causal && col > row) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
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
    T* __restrict__ orow = o + ((int64_t)b * sq + row) * hstride + h * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store(orow + tx + 16 * jd, acc[i][jd] / l_safe);
    if (tx == 0) lse[((int64_t)b * nh + h) * sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int batch, int sq, int skv, int nh,
           float sm_scale, int prescale, int causal, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<D, BK>() * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be asked for (once a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bsh_kernel<T, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (sq % kBQ != 0 || skv % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sq / kBQ, nh, batch);
  flash_fwd_bsh_kernel<T, D, BK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), sq, skv, nh, sm_scale,
      prescale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             const void* bias, void* o, void* lse, int batch, int sq, int skv,
             int nh, float sm_scale, int prescale, int causal,
             cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64, 64>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                               sm_scale, prescale, causal, stream);
    case 128:
      return launch<T, 128, 64>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                                sm_scale, prescale, causal, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, bias, o, lse, batch, sq, skv, nh,
                                sm_scale, prescale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Returns 0 on
// success, the CUDA error code of a refused launch, or
// cudaErrorInvalidValue for an unsupported dtype, head_dim or length.
extern "C" int flash_attention_bsh_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int batch, int sq, int skv, int nh, int head_dim,
    float sm_scale, int prescale, int causal, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || (causal && sq != skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, bias, o, lse, batch, sq, skv,
                           nh, sm_scale, prescale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, bias, o, lse, batch, sq,
                                   skv, nh, sm_scale, prescale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
