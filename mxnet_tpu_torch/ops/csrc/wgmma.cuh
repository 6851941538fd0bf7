// Hopper's warpgroup matrix products (wgmma, sm_90a) and the shared-memory
// descriptors and fences around them, for the kernels that run on them
// (conv1x1_bn_stats.cu, flash_fwd.cu, flash_bwd.cu).
//
// A warpgroup is four consecutive warps (threads 128 w .. 128 w + 127 of
// a block). One wgmma.mma_async computes d (+)= a * b for a 64-row tile
// of d, asynchronously, in all four warps at once: b is always read from
// shared memory through a matrix descriptor, a from shared memory too
// ("SS") or from registers ("RS"). The fp32 accumulators of d are spread
// as mma.sync's C fragments (g = lane / 4, t = lane % 4): warp w of the
// warpgroup holds rows 16 w .. 16 w + 15, and d[j] = (16 w + g, 8 j + 2 t),
// (16 w + g, 8 j + 2 t + 1), (16 w + g + 8, 8 j + 2 t), (16 w + g + 8, 8 j +
// 2 t + 1). An RS product's a is mma.sync.m16n8k16's A fragment of the
// warp's 16 rows (bf16_mma.cuh), so two 8-column accumulator tiles of one
// product, packed to the operand type (c_to_a), are the a of the next
// over those 16 columns.
//
// Order: wg_fence() before the first product of a batch whose
// accumulators or a registers the threads wrote; wg_commit() closes a
// batch into a group, wg_wait<N>() waits until at most N groups are in
// flight; pin() keeps the compiler from moving accumulator reads or
// writes across those points. Generic-proxy writes to shared memory
// (st.shared, cp.async) need fence_async_smem() and a barrier before a
// product reads them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mxtt {

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle (rows
// of 128 bytes, 8-row atoms of 1024 bytes, the 16-byte piece q of row r
// at piece q ^ (r % 8); the tile's atoms 1024-byte aligned): start
// address, leading and stride byte offsets. K-major (k along the rows,
// which a k step of 16 bf16 / f16 or 8 tf32 advances by 32 bytes): LBO
// unused (16), SBO = 1024 between 8-row groups. N-major (n along the
// rows, 16-bit types only, the transpose bit set): LBO between 64-column blocks, SBO = 1024
// between groups of 8 k rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo,
                                               int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// the accumulator operands of a product 128 (64) columns wide, and their
// register names in the instruction
#define MXTT_D128                                                           \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),           \
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),           \
      "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),           \
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),       \
      "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),       \
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),       \
      "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),       \
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),       \
      "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
#define MXTT_D64                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define MXTT_R64                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MXTT_R32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31"

// The 16-bit products are templates on the operand type T, bf16
// (__nv_bfloat16, the default) or f16 (__half): the same instruction with
// its type in the name, .f32.bf16.bf16 or .f32.f16.f16 (fp32
// accumulators either way; both types are 2 bytes, so the tiles, their
// swizzle and the descriptors do not change). `if constexpr` picks one
// of the two spellings of each asm statement, which a macro inside the
// function writes once.
template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<T, __half>::value;
}
static_assert(sizeof(__half) == sizeof(__nv_bfloat16),
              "the 16-bit forms share their tiles");

// SS: d (+)= a * b, a 64 x 16 K-major and b 16 x N, both T in shared
// memory; b N-major when TB = 1 (the default), K-major when TB = 0;
// scale_d = 0 starts from zero
template <int TB = 1, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_n128(float (*d)[4], uint64_t a,
                                           uint64_t b, int scale_d) {
#define MXTT_SS_N128(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
               " {" MXTT_R64 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"          \
               : MXTT_D128                                                  \
               : "l"(a), "l"(b), "r"(scale_d), "n"(TB))
  if constexpr (is_f16<T>())
    MXTT_SS_N128("f16");
  else
    MXTT_SS_N128("bf16");
#undef MXTT_SS_N128
}

template <int TB = 1, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_n64(float (*d)[4], uint64_t a,
                                          uint64_t b, int scale_d) {
#define MXTT_SS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " {" MXTT_R32 "}, %32, %33, p, 1, 1, 0, %35;\n}\n"          \
               : MXTT_D64                                                   \
               : "l"(a), "l"(b), "r"(scale_d), "n"(TB))
  if constexpr (is_f16<T>())
    MXTT_SS_N64("f16");
  else
    MXTT_SS_N64("bf16");
#undef MXTT_SS_N64
}

// SS, tf32: d (+)= a * b, a 64 x 8 and b 8 x N, both K-major tf32 in
// shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float (*d)[4], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
               MXTT_R64 "}, %64, %65, p, 1, 1;\n}\n"
               : MXTT_D128
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (*d)[4], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               MXTT_R32 "}, %32, %33, p, 1, 1;\n}\n"
               : MXTT_D64
               : "l"(a), "l"(b), "r"(scale_d));
}

// RS: d (+)= a * b, a 64 x 16 from registers (each warp its 16 rows as
// mma.sync's A fragment, four 32-bit registers of two T) and b 16 x N of
// T in shared memory, N-major when TB = 1, K-major when TB = 0
template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (*d)[4],
                                              const uint32_t a[4],
                                              uint64_t b, int scale_d) {
#define MXTT_RS_N128(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
               " {" MXTT_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;"  \
               "\n}\n"                                                      \
               : MXTT_D128                                                  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),        \
                 "r"(scale_d), "n"(TB))
  if constexpr (is_f16<T>())
    MXTT_RS_N128("f16");
  else
    MXTT_RS_N128("bf16");
#undef MXTT_RS_N128
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (*d)[4],
                                             const uint32_t a[4],
                                             uint64_t b, int scale_d) {
#define MXTT_RS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " {" MXTT_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;"  \
               "\n}\n"                                                      \
               : MXTT_D64                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),        \
                 "r"(scale_d), "n"(TB))
  if constexpr (is_f16<T>())
    MXTT_RS_N64("f16");
  else
    MXTT_RS_N64("bf16");
#undef MXTT_RS_N64
}

#undef MXTT_D128
#undef MXTT_D64
#undef MXTT_R64
#undef MXTT_R32

// the 16-bit products by width (N = 64 or 128) and operand type
template <int N, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (*d)[4], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width 64 or 128");
  if constexpr (N == 128)
    wgmma_n128<TB, T>(d, a, b, scale_d);
  else
    wgmma_n64<TB, T>(d, a, b, scale_d);
}
template <int N, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (*d)[4], const uint32_t a[4],
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width 64 or 128");
  if constexpr (N == 128)
    wgmma_rs_n128<TB, T>(d, a, b, scale_d);
  else
    wgmma_rs_n64<TB, T>(d, a, b, scale_d);
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
__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait<0>();
}
// keep the compiler from moving accumulator reads across the async product
template <int NJ>
__device__ __forceinline__ void pin(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// generic-proxy writes (cp.async, st.shared) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace mxtt
