// Hopper (sm_90a) tile machinery of the flash kernels: TMA tensor maps and
// loads, the mbarrier ring that hands tiles from a producer warpgroup to
// consumer warpgroups, wgmma shared-memory descriptors and the bf16 and
// float16 wgmma products with float32 accumulators in registers (the
// element type a template parameter, bf16 by default), and the register
// hand-over between warpgroups (setmaxnreg), named barriers and bulk
// reductions. K4 (flash_fwd_sm90.cu) and K9 (flash_bwd_sm90.cu) use it;
// the paged decode kernel K2 (paged_decode_sm90.cu) its pool maps, TMA
// loads and mbarriers; the bf16 ragged-stream kernel K1
// (ragged_stream_sm90.cu) all of it but the register hand-over and the
// bulk reductions.
//
// Layouts. A tile of a [rows, D] bf16 matrix (D contiguous) lands in shared
// memory through TMA as boxes of `box` columns (64, or 32 at D 32: the
// swizzle span, 128 or 64 bytes a row), box b of a tile of R rows at byte
// b * R * 2 * box, each box swizzled by TMA (SWIZZLE_128B / _64B). wgmma
// reads it through a descriptor of the same swizzle:
//   * K-major (the reduction runs along D: Q and K in S = Q.K^T): 8-row
//     groups SBO = 8 * row bytes apart; the k-th 16-column step of a box
//     starts 32 * k bytes into it (the hardware applies the swizzle to the
//     address, so the step moves inside the swizzled rows).
//   * MN-major (the reduction runs along the rows: V in O = P.V, read with
//     wgmma's transpose-B flag): 8-row groups SBO = 8 * row bytes apart,
//     the next box of columns LBO = one box apart; the k-th 16-row step
//     starts 16 * row bytes into the box.
// Every tile starts on a 1024-byte boundary (the 128-byte swizzle's
// period), so the descriptors' base offset is 0. A box of fewer rows than
// the period holds (K1's BS 4 pool blocks: 512 bytes) may start inside it:
// TMA and wgmma apply the swizzle to the shared-memory address (bits 4-6
// XOR bits 7-9; 4-5 and 7-8 for 64 bytes), so the box continues its
// tile's pattern.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace pt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed (the
// loop in PTX: no C++ branch for the compiler to keep registers across).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Fetches a tensor map into the TMA unit's cache ahead of its first use.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box at (column c0, row c1, matrix c2) of a 3-D tensor map into shared
// memory at dst; completes `bar`'s transaction count by the box's bytes
// (rows past the end are zero-filled and counted too).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The float32 box at (column c0, row c1, matrix c2) of a 3-D tensor map
// added from shared memory at src into global memory, as one bulk
// operation of this thread's bulk group (elements past the tensor's ends
// are not written).
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- register hand-over -----------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ------------------------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, and the swizzle (128 or 64 bytes) of the TMA box it reads.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulator registers in program order around the asynchronous
// products: no read of d moves above a wait, no write below a product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register-A fragments: an in-flight product still reads
// them, so their registers must not be reused before its wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Whether the 16-bit element type T is float16 (else bfloat16): the two
// differ only in the type names of the wgmma strings, the tensor maps and
// the conversions.
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// Two floats as one register of two T (the low half is `lo`), rounded to
// nearest; float16 rounds past its range to +-inf.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2<__nv_bfloat16>(lo, hi);
}

// The two T of a packed register as floats (x the low half).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (kIsHalf<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Stores two floats as two T at p (4-byte aligned).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// Accumulator layout of m64nN (float32, N / 2 registers a thread): thread t
// of the warpgroup (warp w = t / 32, lane l) holds rows 16w + l / 4 (i % 4
// < 2) and 16w + l / 4 + 8 (i % 4 >= 2) of register i, at column
// 8 * (i / 4) + 2 * (l % 4) + i % 2. The registers 8k .. 8k+7 of an
// m64n128 accumulator, packed pairwise, are the A fragment of rows x keys
// 16k .. 16k+15 for wgmma's register-A form.

// The products below take the element type T of their 16-bit operands
// (__nv_bfloat16, the default, or __half); the accumulators are float32.

// S = A.B^T: A [64 x 16] and B [128 x 16], both K-major in shared memory
// (descriptors da, db); accumulate = 0 overwrites d.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
#define PT_WGMMA_SS128(AB)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "        \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
      "%60, %61, %62, %63"                                                \
      "}, "                                                               \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (kIsHalf<T>)
    PT_WGMMA_SS128("f16");
  else
    PT_WGMMA_SS128("bf16");
#undef PT_WGMMA_SS128
}

// O += A.B: A [64 x 16] in registers (the fragment above), B [16 x N]
// MN-major in shared memory (transpose-B), N = 32, 64 or 128.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "N of 32, 64 or 128");
#define PT_WGMMA_RS32(AB)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "         \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15"                                                \
      "}, "                                                               \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define PT_WGMMA_RS64(AB)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31"                            \
      "}, "                                                               \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define PT_WGMMA_RS128(AB)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "        \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
      "%60, %61, %62, %63"                                                \
      "}, "                                                               \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (N == 32) {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_RS32("f16");
    else
      PT_WGMMA_RS32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_RS64("f16");
    else
      PT_WGMMA_RS64("bf16");
  } else {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_RS128("f16");
    else
      PT_WGMMA_RS128("bf16");
  }
#undef PT_WGMMA_RS32
#undef PT_WGMMA_RS64
#undef PT_WGMMA_RS128
}

// S = A.B^T at N 64: A [64 x 16] and B [64 x 16], both K-major in shared
// memory (the backward's S^T = K.Q^T and dP^T = V.dO^T).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
#define PT_WGMMA_SS64(AB)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31"                            \
      "}, "                                                               \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                          \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (kIsHalf<T>)
    PT_WGMMA_SS64("f16");
  else
    PT_WGMMA_SS64("bf16");
#undef PT_WGMMA_SS64
}

// D = A.B: A [64 x 16] K-major and B [16 x N] MN-major (transpose-B), both
// in shared memory, N = 16, 32 or 64 (the backward's dQ = dS.K, half of D
// for each consumer); accumulate = 0 overwrites d.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "N of 16, 32 or 64");
#define PT_WGMMA_TB16(AB)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " "       \
      "{"                                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                  \
      "}, "                                                             \
      "%8, %9, p, 1, 1, 0, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),     \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                              \
      : "l"(da), "l"(db), "r"(accumulate))
#define PT_WGMMA_TB32(AB)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "         \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15"                                                \
      "}, "                                                               \
      "%16, %17, p, 1, 1, 0, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "l"(da), "l"(db), "r"(accumulate))
#define PT_WGMMA_TB64(AB)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{"                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31"                            \
      "}, "                                                               \
      "%32, %33, p, 1, 1, 0, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                          \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (N == 16) {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_TB16("f16");
    else
      PT_WGMMA_TB16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_TB32("f16");
    else
      PT_WGMMA_TB32("bf16");
  } else {
    if constexpr (kIsHalf<T>)
      PT_WGMMA_TB64("f16");
    else
      PT_WGMMA_TB64("bf16");
  }
#undef PT_WGMMA_TB16
#undef PT_WGMMA_TB32
#undef PT_WGMMA_TB64
}

// ---- named barriers, the async proxy, bulk reductions -----------------------

// Waits for `count` threads (a multiple of 32) at barrier `id` (1..15; 0
// is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk operations have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until they are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (so the library links against the runtime alone, not
// -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a contiguous tensor [mats, rows, cols] of `elem_bytes`-byte
// elements read (or reduced into) in boxes of [box_rows, box_cols]
// (box_cols * elem_bytes is the swizzle: 128 or 64); rows past the end of
// a matrix read as zeros and are never written. False on failure.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     int elem_bytes, const void* base, int mats, int rows,
                     int cols, int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t eb = static_cast<cuuint64_t>(elem_bytes);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * eb,
                                 static_cast<cuuint64_t>(rows) * cols * eb};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = box_cols * elem_bytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map of one layer's paged pool viewed as [rows, heads, dh] (rows =
// N * BS pool rows, dh contiguous) of `elem_bytes`-byte elements (bf16,
// float32 or int8 codes), read in boxes of {box_cols (0: dh), box_heads,
// box_rows}. Without `swizzle` the box lands linearly (the paged decode
// kernel reads the rows so, and K1 its int8 codes); with it each box row
// of box_cols * elem_bytes (128 or 64) bytes is swizzled over that span,
// as wgmma reads it (K1's bf16 query and pool tiles, one head a box).
// Heads past the end read as zeros (and count in the box's bytes). False
// on failure.
inline bool make_pool_map(CUtensorMap* map, CUtensorMapDataType type,
                          int elem_bytes, const void* base, int rows,
                          int heads, int dh, int box_rows, int box_heads,
                          int box_cols = 0, bool swizzle = false) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  if (box_cols == 0) box_cols = dh;
  const cuuint64_t eb = static_cast<cuuint64_t>(elem_bytes);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * eb,
                                 static_cast<cuuint64_t>(heads) * dh * eb};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz =
      !swizzle ? CU_TENSOR_MAP_SWIZZLE_NONE
      : box_cols * elem_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of 16-bit T, bf16 by default (the flash kernels' q, k, v, dO
// tiles).
template <typename T = __nv_bfloat16>
inline bool make_map_3d(CUtensorMap* map, const void* base, int mats,
                        int rows, int cols, int box_rows, int box_cols) {
  return make_map(map,
                  kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, base, mats, rows, cols, box_rows, box_cols);
}

// A float32 map (the backward's dq workspace, reduced into).
inline bool make_map_3d_f32(CUtensorMap* map, const void* base, int mats,
                            int rows, int cols, int box_rows, int box_cols) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, mats, rows,
                  cols, box_rows, box_cols);
}

}  // namespace sm90
}  // namespace pt
