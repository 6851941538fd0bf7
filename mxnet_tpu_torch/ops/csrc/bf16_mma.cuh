// bf16 products on the tensor cores, and the shared-memory staging around
// them, for the bfloat16 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu).
//
// One mma.sync.m16n8k16 with bf16 operands and fp32 accumulators does the
// work that the fp32 forms spread over three split-TF32 m16n8k8 products
// (tf32_mma.cuh): the operands are bf16 already, so their products are
// exact in fp32 and only the sums round. Tiles live in shared memory with
// rows of DP + 8 bf16 (`bf16_pitch`: 16 bytes of pad), so 32-bit fragment
// loads of 8 rows x 4 words and ldmatrix's 8 rows of 16 bytes hit 32
// different banks, and every row starts 16-byte aligned.
//
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower
// index in the low half:
//   A 16x16: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8,
//            2t+8..)
//   B 16x8:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C 16x8:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the C fragments of two 8-column score tiles, packed pairwise, are the
// A fragment of the product over those 16 columns (`c_to_a`): P feeds P V
// from registers with no permutation. A B operand whose k runs along a
// row of shared memory (K in Q K^T) is two 32-bit loads (`frag_b_rows`);
// one whose k runs down the rows (V in P V) is ldmatrix .trans
// (`frag_b_trans`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int bf16_pitch(int DP) { return DP + 8; }

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values rounded to bf16 (round to nearest even), `lo` in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [0, 16) x columns [kk, kk + 16) of a shared matrix
__device__ __forceinline__ void frag_a(const bf16* m, int pitch, int kk,
                                       int g, int t, uint32_t a[4]) {
  const bf16* r0 = m + g * pitch + kk + 2 * t;
  const bf16* r1 = r0 + 8 * pitch;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B fragment whose k runs along a row: B[k][n] = m[n][k]; `m` points at
// element (n = 0, k = kk)
__device__ __forceinline__ void frag_b_rows(const bf16* m, int pitch, int g,
                                            int t, uint32_t b[2]) {
  const bf16* r = m + g * pitch + 2 * t;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// B fragments of two 8-column tiles whose k runs down the rows: B[k][n] =
// m[k][n] for k in [0, 16) and n in [0, 8) (b[0]) and [8, 16) (b[1]);
// `m` points at element (k = 0, n = 0). One ldmatrix.x4.trans: lane i
// gives the address of row i % 8 (+ 8 for lanes 8-15 and 24-31) of
// matrix i / 8, columns 8 * (i / 16) on
__device__ __forceinline__ void frag_b_trans(const bf16* m, int pitch,
                                             int lane, uint32_t b[2][2]) {
  const bf16* p = m + ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch +
                  8 * (lane >> 4);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(s));
}

// the C fragments of two 8-column tiles (columns [0, 8) and [8, 16)) as
// the A fragment of the product over those 16 columns, rounded to bf16
__device__ __forceinline__ void c_to_a(const float c0[4], const float c1[4],
                                       uint32_t a[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src,
                                                bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

// rows [r0, r0 + n) of a (limit, D) bf16 matrix into shared rows of
// `pitch` elements; rows past `limit` are zeros. vec: D % 8 == 0 and
// `src` 16-byte aligned, so each row goes in 16-byte cp.async pieces;
// else element by element with ordinary loads and stores (cp.async
// moves 4 bytes at least), complete when the caller's next barrier
// passes.
__device__ __forceinline__ void copy_rows_bf16(bf16* dst, int pitch,
                                               const bf16* src, int r0, int n,
                                               int limit, int D, bool vec,
                                               int tid, int nthreads) {
  if (vec) {
    const int per_row = D / 8;
    for (int idx = tid; idx < n * per_row; idx += nthreads) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 8;
      const bool ok = r0 + r < limit;
      cp_async16_bf16(dst + r * pitch + c,
                      ok ? src + (size_t)(r0 + r) * D + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < n * D; idx += nthreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      dst[r * pitch + c] = r0 + r < limit ? src[(size_t)(r0 + r) * D + c]
                                          : __float2bfloat16(0.f);
    }
  }
}

// columns [D, DP) of `rows` shared rows are zeros (never copied into)
__device__ __forceinline__ void zero_pad_bf16(bf16* m, int pitch, int rows,
                                              int D, int DP, int tid,
                                              int nthreads) {
  const int w = DP - D;
  for (int idx = tid; idx < rows * w; idx += nthreads) {
    const int r = idx / w;
    m[r * pitch + D + (idx - r * w)] = __float2bfloat16(0.f);
  }
}

// out[i], out[i + 1] = lo, hi rounded to bf16: one 32-bit store where
// both lie in the row (`pair`: D is even, so i is even and aligned),
// else the one that does
__device__ __forceinline__ void store_pair(bf16* out, size_t i, float lo,
                                           float hi, bool pair,
                                           bool second) {
  if (pair && second) {
    *reinterpret_cast<uint32_t*>(out + i) = pack_bf16(lo, hi);
  } else {
    out[i] = __float2bfloat16(lo);
    if (second) out[i + 1] = __float2bfloat16(hi);
  }
}

}  // namespace mxtt
