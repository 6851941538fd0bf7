// 16-bit values around the tensor cores' products, for the bfloat16 and
// float16 kernels (flash_fwd.cu, flash_bwd.cu, conv1x1_bn_stats.cu).
//
// An accumulator tile in the C fragment layout of mma.sync.m16n8k16 (g =
// lane / 4, t = lane % 4: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1)), which is also how wgmma spreads a warp's 16 rows,
// packs pairwise into the A fragment of the next product over its
// columns (a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8,
// 2t+8..), two 16-bit values a register, the lower index in the low
// half): P feeds P V from registers with no permutation (`c_to_a`).
// Outputs are rounded once and stored a pair at a time (`store_pair`).
// Each helper is a template on the element type T, bf16 (the default) or
// f16; both round to nearest even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mxtt {

using bf16 = __nv_bfloat16;
using f16 = __half;

// two fp32 values rounded to T, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// one fp32 value rounded to T, and a T widened to fp32 (exact)
template <typename T>
__device__ __forceinline__ T to_t(float x) {
  if constexpr (std::is_same<T, f16>::value)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

// the C fragments of two 8-column tiles (columns [0, 8) and [8, 16)) as
// the A fragment of the product over those 16 columns, rounded to T
template <typename T = bf16>
__device__ __forceinline__ void c_to_a(const float c0[4], const float c1[4],
                                       uint32_t a[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// out[i], out[i + 1] = lo, hi rounded to T: one 32-bit store where both
// lie in the row (`pair`: D is even, so i is even and aligned), else the
// one that does
template <typename T>
__device__ __forceinline__ void store_pair(T* out, size_t i, float lo,
                                           float hi, bool pair,
                                           bool second) {
  if (pair && second) {
    *reinterpret_cast<uint32_t*>(out + i) = pack2<T>(lo, hi);
  } else {
    out[i] = to_t<T>(lo);
    if (second) out[i + 1] = to_t<T>(hi);
  }
}

}  // namespace mxtt
