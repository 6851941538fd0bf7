// The copies that feed Hopper's wgmma kernels (flash_fwd.cu, flash_bwd.cu):
// tiles of bf16 or f16 rows in the 128-byte swizzle the products' descriptors
// read (wgmma.cuh sw128_desc), filled by TMA (cp.async.bulk.tensor, one
// thread asks for a whole tile and the copy engine counts its bytes on a
// stage's mbarrier) or, where TMA cannot read (D % 8 != 0, a base not
// 16-byte aligned), element by element by the threads; the mbarriers
// around them; ex2.approx for the softmax on the products' accumulators;
// and, on the host, the tensor maps TMA reads through.
//
// Alignment, as the card enforces it: a TMA box starts on a 16-byte
// boundary of global memory and lands on a 128-byte one of shared memory,
// and a swizzled tile's 8-row atoms on 1024-byte ones.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace mxtt {

// 2^x (ex2.approx.ftz: relative error about 2^-22, subnormal results 0):
// exp(s scale - m) = 2^(s scale log2(e) - m log2(e)), one FFMA and one
// MUFU op where expf takes about eight instructions
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// element (r, c) of a tile of `rows` rows in the 128-byte swizzle: 64-
// column blocks of `rows` rows of 64 two-byte elements, the 16-byte piece
// q of row r at piece q ^ (r % 8)
__device__ __forceinline__ int sw_off(int r, int c, int rows) {
  return (c >> 6) * rows * 64 + r * 64 +
         ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// rows [r0, r0 + ROWS) of a (limit, D) matrix of T (bf16 or f16) into a
// swizzled tile of ROWS rows element by element, by NT threads (the copy
// where TMA cannot go: D % 8 != 0 or a base not 16-byte aligned); rows
// past `limit` are zeros and columns [D, DP) are never written
// (zero_pad_sw)
template <int ROWS, int NT, typename T>
__device__ __forceinline__ void copy_rows_sw(T* dst, const T* src, int r0,
                                             int limit, int D, int tid) {
  for (int idx = tid; idx < ROWS * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[sw_off(r, c, ROWS)] =
        r0 + r < limit ? src[(size_t)(r0 + r) * D + c] : to_t<T>(0.f);
  }
}

// columns [D, DP) of a swizzled tile of `rows` rows are zeros
template <typename T>
__device__ __forceinline__ void zero_pad_sw(T* m, int rows, int D, int DP,
                                            int tid, int nthreads) {
  const int w = DP - D;
  for (int idx = tid; idx < rows * w; idx += nthreads) {
    const int r = idx / w;
    m[sw_off(r, D + idx - r * w, rows)] = to_t<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// mbarriers and TMA (cp.async.bulk.tensor): one thread asks for a whole
// tile; the copy engine writes it into the 128-byte swizzle and counts its
// bytes on the stage's barrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, announcing `bytes` still to come by TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// box (c0 .., c1 .., c2) of a tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// a box of shared memory (in the tensor map's swizzle) into box (c0 ..,
// c1 .., c2) of a tensor; what lies past the tensor's edges is not
// written. A thread's stores form a group at tma_store_commit
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the thread's committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// tensor maps (host): cuTensorMapEncodeTiled from the driver, found
// through the runtime, so nothing links against libcuda
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// the tensor-map element type of T
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a (BH, S, D) tensor of two-byte elements of `type` (bf16 or f16) as
// boxes of `rows` rows x 64 columns (128 bytes) in the 128-byte swizzle;
// rows past S and columns past D read as zeros
inline bool map_rows(CUtensorMap* m, CUtensorMapDataType type,
                     const void* base, int BH, int S, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(m, type, 3, const_cast<void*>(base), dims, strides,
                        box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mxtt
