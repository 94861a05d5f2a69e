// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// conv_bn.cu (rows 10 and 11), flash_attention_bsh.cu (rows 4 and 5) and
// flash_attention_bhsd.cu (rows 6-9): warpgroup matrix multiplies
// (wgmma.mma_async, bf16 or f16 operands, f32 accumulators in registers), the
// shared-memory matrix descriptor of the 128-byte swizzled layout they
// read, and 16-byte cp.async copies that zero-fill what lies outside a
// tensor.
//
// The tile layout.  An operand tile sits in shared memory as blocks of 64
// bf16 columns (128 bytes a row); a block of R rows is R x 128 bytes,
// 1024-byte aligned, and the 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8) of that row (swz128): the 128B swizzle the descriptor
// names, so the 8 rows of a core matrix hit 8 different bank groups.
// One such block serves two ways:
//   * K-major (the contraction runs along the row): rows are M or N, a
//     k16 step advances the start address by 32 bytes, SBO = 1024 (the
//     next 8 rows);
//   * MN-major (rows are the contraction index, columns are N; trans-b
//     1, or M with trans-a 1 for an A read from shared memory,
//     wgmma_ss_n64_mn): a k16 step advances 16 rows (2048 bytes), SBO =
//     1024 bytes between 8-row groups; a product N wider than 64 is
//     issued as one n64 instruction per column block, so the only stride
//     a descriptor carries is the 1024 bytes between 8-row groups
//     (desc_sw128 writes it to both offset fields; LBO is not read for
//     these products).
//
// Accumulators of m64nN: thread (warp w of the warpgroup, lane = 4 g + t)
// holds rows 16 w + g and 16 w + g + 8, columns 8 i + 2 t and 8 i + 2 t + 1
// of every n8 block i, as d[4 i + 0..1] (row g) and d[4 i + 2..3] (row g +
// 8).  Rounded to bf16 (or f16) pairs, the accumulator of one product is
// the A operand of the next from registers (a_frag): the k16 step kk
// takes d[8 kk .. 8 kk + 7].  Every helper takes the operands' element
// type E (bf16 by default, __half for the f16 forms): an f16 tile has the
// bf16 tile's size, layout and swizzle.
//
// Every item sits in an anonymous namespace, local to the library that
// includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk `chunk` (16 bytes) of row `row` in a swizzled block
__device__ __forceinline__ uint32_t swz128(uint32_t row, uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// 16-byte copy global -> shared; 16 zero bytes instead where !valid (src
// is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's completed shared-memory writes visible to wgmma's
// (async proxy) reads; a __syncthreads follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a 128B-swizzled operand block starting at shared address
// `saddr` (the block 1024-byte aligned; saddr may sit 32, 64 or 96 bytes
// into it for a k16 step)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(1024 >> 4) << 16;    // LBO (not read: see above)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // SBO: next 8 rows
  d |= static_cast<uint64_t>(1) << 62;            // 128B swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The 16-bit element type E of a product's operands: __nv_bfloat16 (the
// default) or __half.  The two share every size, layout and swizzle;
// only the instruction's type suffix and the register packing differ.
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// f16 pairs round to nearest even; past 65504 a value becomes inf, as
// the conversion does (no saturation)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}
// one f32 rounded to E
template <typename E>
__device__ __forceinline__ E round_to(float x) {
  if constexpr (kIsF16<E>)
    return __float2half_rn(x);
  else
    return __float2bfloat16_rn(x);
}
// the A fragment of k16 step kk from an m64nN accumulator array, each
// value rounded to E (round to nearest even); kk must be a constant
// after unrolling, or the array goes to local memory
template <typename E = __nv_bfloat16, int R>
__device__ __forceinline__ void a_frag(const float (&d)[R], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack2<E>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<E>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<E>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<E>(d[8 * kk + 6], d[8 * kk + 7]);
}

// the type suffix of E's wgmma
#define HOPPER_MMA_BF16 ".f32.bf16.bf16"
#define HOPPER_MMA_F16 ".f32.f16.f16"

// accumulator operand lists of m64n32 / m64n64 / m64n128
#define HOPPER_ACC16                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15])
#define HOPPER_ACC32                                                   \
  HOPPER_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC64                                                   \
  HOPPER_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_REGS16                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, "             \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS32                            \
  HOPPER_REGS16 ", "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64                            \
  HOPPER_REGS32 ", "                             \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// D[64 x 32] += A[64 x 16] * B[16 x 32], A and B from shared memory
#define HOPPER_SS_N32(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n32k16" TY " {"            \
               HOPPER_REGS16 "}, %16, %17, p, 1, 1, 0, %19;\n}\n"          \
               : HOPPER_ACC16                                              \
               : "l"(da), "l"(db), "r"(1), "n"(TB))
template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  if constexpr (kIsF16<E>)
    HOPPER_SS_N32(HOPPER_MMA_F16);
  else
    HOPPER_SS_N32(HOPPER_MMA_BF16);
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A and B from shared memory
#define HOPPER_SS_N64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16" TY " {"            \
               HOPPER_REGS32 "}, %32, %33, p, 1, 1, 0, %35;\n}\n"          \
               : HOPPER_ACC32                                              \
               : "l"(da), "l"(db), "r"(1), "n"(TB))
template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (kIsF16<E>)
    HOPPER_SS_N64(HOPPER_MMA_F16);
  else
    HOPPER_SS_N64(HOPPER_MMA_BF16);
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A and B from shared memory
#define HOPPER_SS_N128(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16" TY " {"           \
               HOPPER_REGS64 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"          \
               : HOPPER_ACC64                                              \
               : "l"(da), "l"(db), "r"(1), "n"(TB))
template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (kIsF16<E>)
    HOPPER_SS_N128(HOPPER_MMA_F16);
  else
    HOPPER_SS_N128(HOPPER_MMA_BF16);
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the
// accumulator layout of a previous product, packed to E pairs: a_frag<E>)
#define HOPPER_RS_N64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16" TY " {"            \
               HOPPER_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;" \
               "\n}\n"                                                     \
               : HOPPER_ACC32                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1), "n"(TB))
template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (kIsF16<E>)
    HOPPER_RS_N64(HOPPER_MMA_F16);
  else
    HOPPER_RS_N64(HOPPER_MMA_BF16);
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], both from shared memory and both
// MN-major (trans-a 1, trans-b 1): A's tile rows are the contraction index
// and its 64 columns M, laid out as an MN-major B block is
#define HOPPER_SS_N64_MN(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16" TY " {"            \
               HOPPER_REGS32 "}, %32, %33, p, 1, 1, 1, 1;\n}\n"            \
               : HOPPER_ACC32                                              \
               : "l"(da), "l"(db), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  if constexpr (kIsF16<E>)
    HOPPER_SS_N64_MN(HOPPER_MMA_F16);
  else
    HOPPER_SS_N64_MN(HOPPER_MMA_BF16);
}

// D[64 x N] += A * B with both operands in shared memory, N in {32, 64, 128}
template <int N, int TB, typename E = __nv_bfloat16, int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da,
                                         uint64_t db) {
  static_assert(R == N / 2, "an m64nN accumulator holds N / 2 floats");
  if constexpr (N == 32)
    wgmma_ss_n32<TB, E>(d, da, db);
  else if constexpr (N == 64)
    wgmma_ss_n64<TB, E>(d, da, db);
  else
    wgmma_ss_n128<TB, E>(d, da, db);
}

}  // namespace
