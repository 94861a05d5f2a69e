// Paged decode-step attention for Hopper (sm_90a), split across blocks
// along the sequence (flash-decoding).
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
// card's 3.35 TB/s (17.5 MB, 5.2 us at the decode step's shape).
//
// Design.  The TPU kernel walks a sequential (batch, pages) grid and
// carries its online-softmax state across pages in VMEM scratch.  On
// Hopper a decode step has few slots (8 x 12 heads at the serving shape)
// and one long slot would keep a one-block-a-(slot, head) grid waiting on
// a single SM, so here the sequence is split:
//
//   * The grid is (chunk, kv head x head group, slot).  A chunk is
//     chunk_pages whole pages (the wrapper's split_geometry: about 64
//     positions), and the number of chunks comes from the table's width,
//     maxp, never from lengths: the wrapper does not read lengths on the
//     host.  A block whose chunk starts at or past len exits at once.
//   * One block serves every query head of its kv head (up to 32; more
//     heads make head groups, each reading the rows again), so each K and
//     V row at a position < len is read from device memory once.
//   * The block streams its chunk through a 4-stage ring of 8 KB stages
//     in shared memory with 16-byte cp.async copies, so its whole chunk
//     (32 KB at D 64 in f32) is in flight from the start, and the SMs
//     hold several blocks each.  The page ids of the chunk are read into
//     shared memory first (in place of the TPU's scalar prefetch).
//   * Warps split the block's heads and a tile's positions (warp-uniform
//     liveness); a lane holds D/32 contiguous elements of a row, dot
//     products over D are xor-shuffle reductions, and each warp keeps an
//     online-softmax state (m, l, acc) a head in registers.  The warps'
//     states merge through shared memory into the chunk's partial.
//   * A slot with one live chunk writes acc / max(l, 1e-30) at once.
//     Otherwise every live chunk writes its f32 partial (m, l, acc[D]) to
//     the wrapper's workspace, and the last block of the (slot, kv head,
//     head group) to finish, elected by an atomic ticket that wraps back
//     to zero for the next call, merges the partials in chunk order:
//     M = max m_c, L = sum l_c exp(m_c - M), o = sum acc_c exp(m_c - M) /
//     max(L, 1e-30).  Only the election is atomic; every sum has a fixed
//     order, so two calls give the same bits.  A length 0 gives 0.
//
// Accumulation is f32 for f32 and bf16 inputs.  The plain version of this
// order is paged_attention_split_reference in paged_attention.py.
//
// What holds it back now: the partials' round trip through L2 and the
// serial merge in the last block of a long slot (16 chunks at the decode
// shape), the dead blocks of short slots that the grid still launches,
// and the per-block cp.async ring, which holds one chunk and so covers
// one memory latency, not a pipeline of them.
//
// C interface (ctypes): paged_attention_launch returns cudaGetLastError()
// after the launch.  The kernel runs on the caller's stream, allocates
// nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;              // ring depth
constexpr int kStageBytes = 8192;       // K and V rows of one stage
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBatch = 4;               // positions a warp scores together
constexpr int kMaxChunkPages = 64;      // split_geometry: <= 64 positions
constexpr int kMerge = 8;               // partials in flight in the merge

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* lengths;
  void* out;
  float* part;        // [B*H*nchunks][D] acc, then [B*H*nchunks][2] (m, l)
  unsigned* ticket;   // [B*KH*hgroups], 0 between calls
  int n_heads, kv_heads, page, maxp, chunk_pages, nchunks, hgroups;
  float sm_scale;
};

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

// Called by every thread after the block's writes to device memory: true
// in the one block of the n sharing `ticket` that arrives last.  The
// barrier orders the block's writes before thread 0's fence, which
// publishes them before its ticket.  The atomicInc wraps at n - 1, so the
// last block also leaves the ticket at 0 for the next call.  (The same
// election as add_ln.cu's backward.)
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

// HPW: query heads a warp holds; WP: warps that split a tile's positions
// for one head.  The block's warps form (kWarps / WP) head groups x WP
// position groups and serve GB = kWarps / WP * HPW query heads.
template <typename T, int D, int HPW, int WP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  constexpr int V = D / 32;                  // elements of a row a lane holds
  constexpr int kRow = D * static_cast<int>(sizeof(T));  // bytes of a row
  constexpr int TP = kStageBytes / (2 * kRow);  // positions a stage
  constexpr int kPieces = kRow / 16;         // 16-byte copies a row
  constexpr int PPW = TP / WP;               // positions of a tile a warp takes
  constexpr int NB = PPW < kBatch ? PPW : kBatch;
  constexpr int GB = kWarps / WP * HPW;
  static_assert(TP % WP == 0 && PPW % NB == 0, "tile split");
  static_assert(kWarps * HPW * D * 4 <= kRingBytes, "merge fits the ring");

  __shared__ __align__(16) unsigned char ring[kRingBytes];
  __shared__ int tbl[kMaxChunkPages];
  __shared__ float red_m[kWarps][HPW];
  __shared__ float red_l[kWarps][HPW];

  const int c = blockIdx.x;
  const int kvh = blockIdx.y / a.hgroups;
  const int hg = blockIdx.y - kvh * a.hgroups;
  const int b = blockIdx.z;
  const int group = a.n_heads / a.kv_heads;
  const int gb = min(GB, group - hg * GB);   // heads this block serves
  const int h0 = kvh * group + hg * GB;      // its first query head
  // a length past the table's reach covers every tabled position, as in
  // the dense reference
  const int len = min(a.lengths[b], a.maxp * a.page);
  const int chunk_len = a.chunk_pages * a.page;
  const int n_live = max(1, (len + chunk_len - 1) / chunk_len);
  if (c >= n_live) return;
  const int p_begin = c * chunk_len;
  const int p_end = min(len, p_begin + chunk_len);
  const int ntiles = (p_end - p_begin + TP - 1) / TP;  // 0 when len == 0
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wh = warp / WP;
  const int wp = warp - wh * WP;

  for (int i = threadIdx.x; i < a.chunk_pages; i += kThreads) {
    const int lp = c * a.chunk_pages + i;
    tbl[i] = lp < a.maxp ? a.page_table[(int64_t)b * a.maxp + lp] : 0;
  }
  __syncthreads();

  const char* kp = static_cast<const char*>(a.k_pages);
  const char* vp = static_cast<const char*>(a.v_pages);
  const int64_t head_off = (int64_t)kvh * kRow;
  const int64_t pos_stride = (int64_t)a.kv_heads * kRow;
  // K then V rows of TP positions of tile `tile` into its stage; rows at
  // positions >= len are not read
  auto issue = [&](int tile) {
    unsigned char* st = ring + (tile % kStages) * kStageBytes;
    const int t0 = tile * TP;                  // relative to p_begin
    for (int i = threadIdx.x; i < 2 * TP * kPieces; i += kThreads) {
      const int which = i / (TP * kPieces);
      const int rem = i - which * (TP * kPieces);
      const int t = rem / kPieces;
      const int piece = rem - t * kPieces;
      const int rel = t0 + t;
      if (p_begin + rel < p_end) {
        const int pid = tbl[rel / a.page];
        const int64_t off = ((int64_t)pid * a.page + rel % a.page)
                            * pos_stride + head_off + piece * 16;
        cp_async16(smem_u32(st + (which * TP + t) * kRow + piece * 16),
                   (which ? vp : kp) + off, true);
      }
    }
    cp_async_commit();
  };

  float qv[HPW][V];
#pragma unroll
  for (int k = 0; k < HPW; ++k) {
    const int hh = wh * HPW + k;
    if (hh < gb) {
      load_row<T, V>(static_cast<const T*>(a.q)
                     + ((int64_t)b * a.n_heads + h0 + hh) * D + lane * V,
                     qv[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) qv[k][i] = 0.f;
    }
  }
  float m[HPW], l[HPW], acc[HPW][V];
#pragma unroll
  for (int k = 0; k < HPW; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    else cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + kStages - 1 < ntiles) issue(tile + kStages - 1);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(ring
                                             + (tile % kStages) * kStageBytes);
    const T* vs = ks + TP * D;
    const int t0 = p_begin + tile * TP;
#pragma unroll
    for (int j0 = 0; j0 < PPW; j0 += NB) {
      bool live[NB];
      float kr[NB][V];
      float s[HPW][NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int t = wp + WP * (j0 + j);
        live[j] = t0 + t < p_end;
        if (live[j]) {
          load_row<T, V>(ks + t * D + lane * V, kr[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) kr[j][i] = 0.f;
        }
      }
      if (!live[0]) break;  // positions are in order: the rest are dead
#pragma unroll
      for (int k = 0; k < HPW; ++k) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) d = fmaf(qv[k][i], kr[j][i], d);
          s[k][j] = d;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < HPW; ++k) {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            s[k][j] += __shfl_xor_sync(0xffffffffu, s[k][j], o);
        }
      }
      float vr[NB][V];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int t = wp + WP * (j0 + j);
        if (live[j]) {
          load_row<T, V>(vs + t * D + lane * V, vr[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) vr[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < HPW; ++k) {
        float mx = m[k];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          s[k][j] = live[j] ? s[k][j] * a.sm_scale : -INFINITY;
          mx = fmaxf(mx, s[k][j]);
        }
        // live[0] holds, so mx is finite; exp(-inf) = 0 on the first pass
        const float alpha = expf(m[k] - mx);
        l[k] *= alpha;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] *= alpha;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float p = expf(s[k][j] - mx);  // 0 for a dead position
          l[k] += p;
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = fmaf(p, vr[j][i], acc[k][i]);
        }
        m[k] = mx;
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the position groups' states of each head into the chunk's
  // partial, through the ring's shared memory: red_acc [kWarps][HPW][D]
  float* red_acc = reinterpret_cast<float*>(ring);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < HPW; ++k) {
      red_m[warp][k] = m[k];
      red_l[warp][k] = l[k];
    }
  }
#pragma unroll
  for (int k = 0; k < HPW; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      red_acc[(warp * HPW + k) * D + lane * V + i] = acc[k][i];
  }
  __syncthreads();

  const int64_t bh0 = (int64_t)b * a.n_heads + h0;
  float* part_acc = a.part;
  float* part_ml = a.part
                   + (int64_t)gridDim.z * a.n_heads * a.nchunks * D;
  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
    const int hh = idx / D;
    const int d = idx - hh * D;
    const int k = hh % HPW;
    const int w0 = hh / HPW * WP;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WP; ++w) mx = fmaxf(mx, red_m[w0 + w][k]);
    float sum_l = 0.f, sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < WP; ++w) {
      // a warp that saw no position has m = -inf and contributes nothing
      const float mw = red_m[w0 + w][k];
      const float sc = mw == -INFINITY ? 0.f : expf(mw - mx);
      sum_l = fmaf(red_l[w0 + w][k], sc, sum_l);
      sum_a = fmaf(red_acc[((w0 + w) * HPW + k) * D + d], sc, sum_a);
    }
    const int64_t bh = bh0 + hh;
    if (n_live == 1) {
      out[bh * D + d] = from_float<T>(sum_a / fmaxf(sum_l, 1e-30f));
    } else {
      const int64_t slot = bh * a.nchunks + c;
      part_acc[slot * D + d] = sum_a;
      if (d == 0) {
        part_ml[2 * slot] = mx;
        part_ml[2 * slot + 1] = sum_l;
      }
    }
  }
  if (n_live == 1) return;

  // the last chunk block of (slot, kv head, head group) merges the
  // partials in chunk order (read from L2: other blocks wrote them)
  unsigned* tk = a.ticket + ((int64_t)b * a.kv_heads + kvh) * a.hgroups + hg;
  if (!finished_last(tk, n_live)) return;
  const float2* ml_all = reinterpret_cast<const float2*>(part_ml);
  for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
    const int hh = idx / D;
    const int d = idx - hh * D;
    const int64_t slot0 = (bh0 + hh) * a.nchunks;
    const float2* ml = ml_all + slot0;
    const float* ac = part_acc + slot0 * D + d;
    // kMerge chunks' partials in flight at a time; the sums stay in
    // chunk order
    float mx = -INFINITY;
    for (int c0 = 0; c0 < n_live; c0 += kMerge) {
      float mv[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j)
        mv[j] = c0 + j < n_live ? __ldcg(ml + c0 + j).x : -INFINITY;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) mx = fmaxf(mx, mv[j]);
    }
    float sum_l = 0.f, sum_a = 0.f;
    for (int c0 = 0; c0 < n_live; c0 += kMerge) {
      float2 mlv[kMerge];
      float av[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const bool live_c = c0 + j < n_live;
        mlv[j] = live_c ? __ldcg(ml + c0 + j) : make_float2(-INFINITY, 0.f);
        av[j] = live_c ? __ldcg(ac + (int64_t)(c0 + j) * D) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        if (c0 + j < n_live) {
          const float sc = expf(mlv[j].x - mx);
          sum_l = fmaf(mlv[j].y, sc, sum_l);
          sum_a = fmaf(av[j], sc, sum_a);
        }
      }
    }
    out[(bh0 + hh) * D + d] = from_float<T>(sum_a / fmaxf(sum_l, 1e-30f));
  }
}

template <typename T, int D, int HPW, int WP>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid(a.nchunks, a.kv_heads * a.hgroups, batch);
  paged_attention_kernel<T, D, HPW, WP><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// heads_per_block (GB) -> the warps' split: 1, 2 and 4 heads split a
// tile's positions over 4, 2 and 1 warps; 8, 16 and 32 heads give each
// warp 2, 4 and 8 heads
template <typename T, int D>
int launch_hpb(const Args& a, int batch, int hpb, cudaStream_t stream) {
  switch (hpb) {
    case 1: return launch<T, D, 1, 4>(a, batch, stream);
    case 2: return launch<T, D, 1, 2>(a, batch, stream);
    case 4: return launch<T, D, 1, 1>(a, batch, stream);
    case 8: return launch<T, D, 2, 1>(a, batch, stream);
    case 16: return launch<T, D, 4, 1>(a, batch, stream);
    case 32: return launch<T, D, 8, 1>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_d(int head_dim, const Args& a, int batch, int hpb,
             cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_hpb<T, 64>(a, batch, hpb, stream);
    case 128: return launch_hpb<T, 128>(a, batch, hpb, stream);
    case 256: return launch_hpb<T, 256>(a, batch, hpb, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part is the f32 workspace of
// batch * n_heads * nchunks * (head_dim + 2) floats and ticket the
// batch * kv_heads * hgroups counters, zero before the first call (each
// call leaves them at zero), with nchunks = ceil(maxp / chunk_pages) and
// hgroups = ceil((n_heads / kv_heads) / heads_per_block).  Returns 0 on
// success, the CUDA error code of a refused launch, or
// cudaErrorInvalidValue for an unsupported dtype, head_dim, head grouping
// or geometry.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part,
    void* ticket, int batch, int n_heads, int kv_heads, int head_dim,
    int page, int maxp, int chunk_pages, int heads_per_block, float sm_scale,
    int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || kv_heads <= 0 ||
      n_heads % kv_heads != 0 || page <= 0 || maxp <= 0 ||
      chunk_pages <= 0 || chunk_pages > kMaxChunkPages ||
      heads_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / kv_heads;
  if ((int64_t)kv_heads * ((group + heads_per_block - 1) / heads_per_block)
      > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the narrowest block that holds the group, or 32 heads a block
  const int want = group >= 32 ? 32 : group <= 1 ? 1 : group <= 2 ? 2
                 : group <= 4 ? 4 : group <= 8 ? 8 : group <= 16 ? 16 : 32;
  if (heads_per_block != want) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q, k_pages, v_pages,
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(lengths), out,
                  static_cast<float*>(part), static_cast<unsigned*>(ticket),
                  n_heads, kv_heads, page, maxp, chunk_pages,
                  (maxp + chunk_pages - 1) / chunk_pages,
                  (group + heads_per_block - 1) / heads_per_block, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(head_dim, a, batch, heads_per_block, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, a, batch, heads_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
