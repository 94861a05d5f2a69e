// Paged decode-step attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_paged_kernel, launched by _pallas_paged_attention).  For every batch
// slot b and query head h:
//
//     o[b,h] = softmax(q[b,h] . K[b]^T * sm_scale) V[b]
//
// where K[b]/V[b] are the first lengths[b] logical positions gathered
// through page_table[b] from the pools k_pages/v_pages [P, page, KH, D].
// A grouped-query head reads kv head h / (H / KH).
//
// Bound.  One query token per slot does ~4*D flops per cached position
// and reads 2*KH*D*itemsize bytes for it, so the kernel is bound by
// memory: bytes = sum_b min(len_b, maxp*page)*KH*D*2*itemsize, plus one
// int32 table entry per live page, the lengths, q and out, against the
// card's 3.35 TB/s.
//
// Design.  The TPU kernel walks a sequential (batch, pages) grid and
// carries its online-softmax state across pages in VMEM scratch.  Blocks
// on Hopper run in parallel and in no order, so here one block owns one
// (slot, head) pair and loops over ONLY the live pages, ceil(len/page):
// it reads its page-table row and length itself (in place of the TPU's
// scalar prefetch), never touches a masked page (those contribute exactly
// zero, so the result equals the reference's full sweep), and reads only
// the rows at positions t < len: the bytes of the bound.  Each warp streams a strided share of the
// positions, TOK positions per iteration with all their K and V row loads
// issued before any arithmetic, so several loads are in flight per warp.
// A lane holds D/32 contiguous elements of a row (one vector load); dot
// products over D are reduced with xor shuffles.  The online-softmax
// state (m, l, acc) lives in registers per warp; the warps' states merge
// through shared memory at the end, and the output is acc / max(l, 1e-30)
// as in the TPU kernel.  Accumulation is f32 for f32 and bf16 inputs.
//
// Later work, not done here: at the serving shapes (8 slots x 12 heads =
// 96 blocks on 132 SMs) the card is not full, and the loads are plain;
// splitting each sequence's length across blocks (flash-decoding),
// cp.async/TMA page loads and bf16 pools are the next steps.
//
// C interface (ctypes): paged_attention_launch returns cudaGetLastError()
// after the launch.  The kernel runs on the caller's stream, allocates
// nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kTok = 4;    // positions per warp per iteration

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N contiguous elements of type T (N * sizeof(T) bytes, aligned to
// that size by the caller) with the widest vector loads available and
// widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&dst)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 4 || kBytes == 8 || kBytes % 16 == 0,
                "row slice must be 4, 8 or a multiple of 16 bytes");
  alignas(16) unsigned char buf[kBytes];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
  } else {
    *reinterpret_cast<uint32_t*>(buf) = *reinterpret_cast<const uint32_t*>(p);
  }
  const T* e = reinterpret_cast<const T*>(buf);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_float(e[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       T* __restrict__ out,
                       int n_heads, int kv_heads, int page, int maxp,
                       float sm_scale) {
  constexpr int V = D / 32;  // elements of a row held by one lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (n_heads / kv_heads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a length past the table's reach covers every tabled position, as in
  // the dense reference
  const int len = min(lengths[b], maxp * page);
  const int* __restrict__ row_table = page_table + (int64_t)b * maxp;
  const int64_t pos_stride = (int64_t)kv_heads * D;  // between positions
  const int64_t head_off = (int64_t)kvh * D + lane * V;

  float qv[V];
  load_row<T, V>(q + ((int64_t)b * n_heads + h) * D + lane * V, qv);

  float m = -INFINITY, l = 0.f;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int t0 = warp * kTok; t0 < len; t0 += kWarps * kTok) {
    float kr[kTok][V], vr[kTok][V];
    bool live[kTok];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int t = t0 + j;
      live[j] = t < len;
      const int ts = live[j] ? t : t0;  // t0 < len: always a live row
      const int pid = row_table[ts / page];
      const int64_t off = ((int64_t)pid * page + ts % page) * pos_stride
                          + head_off;
      load_row<T, V>(k_pages + off, kr[j]);
      load_row<T, V>(v_pages + off, vr[j]);
    }
    float s[kTok];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) d = fmaf(qv[i], kr[j][i], d);
      s[j] = d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      s[j] = live[j] ? s[j] * sm_scale : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    // s[0] is live, so m_new is finite; exp(-inf) = 0 on the first pass
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for a masked position
      l += p;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(p, vr[j][i], acc[i]);
    }
    m = m_new;
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sm_acc[warp][lane * V + i] = acc[i];
  __syncthreads();
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float scale[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no position has m = -inf and contributes nothing
    scale[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - m_all);
    l_all = fmaf(sm_l[w], scale[w], l_all);
  }
  const float inv_l = 1.f / fmaxf(l_all, 1e-30f);
  T* __restrict__ o = out + ((int64_t)b * n_heads + h) * D;
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][d], scale[w], a);
    o[d] = from_float<T>(a * inv_l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const void* page_table, const void* lengths, void* out,
            int batch, int n_heads, int kv_heads, int page, int maxp,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid(n_heads, batch);
  paged_attention_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), n_heads,
      kv_heads, page, maxp, sm_scale);
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k_pages,
             const void* v_pages, const void* page_table, const void* lengths,
             void* out, int batch, int n_heads, int kv_heads, int page,
             int maxp, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      launch<T, 64>(q, k_pages, v_pages, page_table, lengths, out, batch,
                    n_heads, kv_heads, page, maxp, sm_scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k_pages, v_pages, page_table, lengths, out, batch,
                     n_heads, kv_heads, page, maxp, sm_scale, stream);
      return 0;
    case 256:
      launch<T, 256>(q, k_pages, v_pages, page_table, lengths, out, batch,
                     n_heads, kv_heads, page, maxp, sm_scale, stream);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, the CUDA error
// code of a refused launch, or cudaErrorInvalidValue for an unsupported
// dtype / head_dim / head grouping.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int n_heads, int kv_heads, int head_dim, int page, int maxp,
    float sm_scale, int dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || n_heads % kv_heads != 0 || page <= 0 ||
      maxp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad = 1;
  if (dtype == 0)
    bad = launch_d<float>(head_dim, q, k_pages, v_pages, page_table, lengths,
                          out, batch, n_heads, kv_heads, page, maxp, sm_scale,
                          s);
  else if (dtype == 1)
    bad = launch_d<__nv_bfloat16>(head_dim, q, k_pages, v_pages, page_table,
                                  lengths, out, batch, n_heads, kv_heads, page,
                                  maxp, sm_scale, s);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
