// Split TF32 on the tensor cores, and the shared-memory staging around
// it, for the fp32 flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Each fp32 operand x becomes hi = tf32(x) (cvt.rna) and lo = tf32(x -
// hi), and each product is lo*hi + hi*lo + hi*hi through
// mma.sync.m16n8k8 with fp32 accumulators ("3xTF32", the arithmetic of
// CUTLASS's OpMultiplyAddFastF32). The dropped lo*lo term is 2^-22
// relative: a few times fp32's rounding, where one-pass TF32 keeps about
// 3 digits; a long walk adds its tiles' products by fp32 fma
// (tile_add). Tiles live in shared memory with rows of DP + 4 floats
// (`pitch_of`), so the fragment loads below hit 32 different banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mxtt {

// ---------------------------------------------------------------------------
// split TF32 on mma.sync.m16n8k8 (row.col, fp32 accumulators)
// Fragments (g = lane / 4, t = lane % 4):
//   A 16x8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16x8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a * b[i] and d[i] += e * f[i] for i < N in split TF32: the
// small terms first, then hi * hi, each pass over all 2N accumulators so
// that consecutive mma.sync instructions do not wait on each other
template <int N>
__device__ __forceinline__ void mma3x2(float (*c)[4], const uint32_t ah[4],
                                       const uint32_t al[4],
                                       uint32_t (*bh)[2],
                                       uint32_t (*bl)[2],
                                       float (*d)[4], const uint32_t eh[4],
                                       const uint32_t el[4],
                                       uint32_t (*fh)[2],
                                       uint32_t (*fl)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[i], al, bh[i]);
    mma_tf32(d[i], el, fh[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[i], ah, bl[i]);
    mma_tf32(d[i], eh, fl[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[i], ah, bh[i]);
    mma_tf32(d[i], eh, fh[i]);
  }
}

// c[i] += a * b[i] for i < N, likewise
template <int N>
__device__ __forceinline__ void mma3x1(float (*c)[4], const uint32_t ah[4],
                                       const uint32_t al[4],
                                       uint32_t (*bh)[2],
                                       uint32_t (*bl)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], ah, bh[i]);
}

// acc[i] = acc[i] * (a0 for rows g, a1 for rows g + 8) + tile[i] for i < N,
// by fp32 fma. A long walk sums its tiles this way, each tile's products
// taken in zeroed accumulators: mma.sync's own accumulation into a
// running sum lost accuracy with every tile (on an H100 the kernels'
// distance from float64 grew with the walk, to 13-19x the fp32 plain
// version's at S = 2048-4096; at most 3.3x with tile_add)
template <int N>
__device__ __forceinline__ void tile_add(float (*acc)[4], float (*tile)[4],
                                         float a0, float a1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i][0] = fmaf(acc[i][0], a0, tile[i][0]);
    acc[i][1] = fmaf(acc[i][1], a0, tile[i][1]);
    acc[i][2] = fmaf(acc[i][2], a1, tile[i][2]);
    acc[i][3] = fmaf(acc[i][3], a1, tile[i][3]);
  }
}

// A fragment of rows [0, 16) x columns [kk, kk + 8) of a shared matrix
__device__ __forceinline__ void load_a(const float* m, int pitch, int kk,
                                       int g, int t, uint32_t ah[4],
                                       uint32_t al[4]) {
  const float* r0 = m + g * pitch + kk + t;
  const float* r1 = r0 + 8 * pitch;
  split(r0[0], ah[0], al[0]);
  split(r1[0], ah[1], al[1]);
  split(r0[4], ah[2], al[2]);
  split(r1[4], ah[3], al[3]);
}

// B fragment whose k runs along a row: B[k][n] = m[n][k]; `m` points at
// element (n = 0, k = kk)
__device__ __forceinline__ void load_b_rows(const float* m, int pitch,
                                            int g, int t, uint32_t bh[2],
                                            uint32_t bl[2]) {
  const float* r = m + g * pitch + t;
  split(r[0], bh[0], bl[0]);
  split(r[4], bh[1], bl[1]);
}

// B fragment whose k runs down the rows in the permuted order (k = t is
// row 2t, k = t + 4 is row 2t + 1): B[k][n] = m[row(k)][n]; `m` points at
// element (row 0, n = 0)
__device__ __forceinline__ void load_b_perm(const float* m, int pitch,
                                            int g, int t, uint32_t bh[2],
                                            uint32_t bl[2]) {
  const float* r = m + 2 * t * pitch + g;
  split(r[0], bh[0], bl[0]);
  split(r[pitch], bh[1], bl[1]);
}

// the C fragment of one 16 x 8 score tile as the A fragment of the
// permuted contraction (columns 2t, 2t + 1 become k = t, t + 4)
__device__ __forceinline__ void c_as_a(const float c[4], uint32_t ah[4],
                                       uint32_t al[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + n) of a (limit, D) fp32 matrix into shared rows of
// `pitch` floats; rows past `limit` are zero-filled (the source address
// then stays at `src`, which is valid). vec: D % 4 == 0 and `src` 16-byte
// aligned, so each row goes in 16-byte pieces.
__device__ __forceinline__ void copy_rows(float* dst, int pitch,
                                          const float* src, int r0, int n,
                                          int limit, int D, bool vec,
                                          int tid, int nthreads) {
  if (vec) {
    const int per_row = D / 4;
    for (int idx = tid; idx < n * per_row; idx += nthreads) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 4;
      const bool ok = r0 + r < limit;
      cp_async16(dst + r * pitch + c,
                 ok ? src + (size_t)(r0 + r) * D + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < n * D; idx += nthreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const bool ok = r0 + r < limit;
      cp_async4(dst + r * pitch + c,
                ok ? src + (size_t)(r0 + r) * D + c : src, ok);
    }
  }
}

// entries [r0, r0 + n) of a vector, zero past `limit`
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int r0, int n, int limit, int tid,
                                         int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    const bool ok = r0 + i < limit;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// columns [D, DP) of `rows` shared rows are zeros (never copied into)
__device__ __forceinline__ void zero_pad(float* m, int pitch, int rows,
                                         int D, int DP, int tid,
                                         int nthreads) {
  const int w = DP - D;
  for (int idx = tid; idx < rows * w; idx += nthreads) {
    const int r = idx / w;
    m[r * pitch + D + (idx - r * w)] = 0.f;
  }
}

__host__ __device__ constexpr int pitch_of(int DP) { return DP + 4; }

// Raise a kernel's dynamic shared-memory limit to the most any plan gives
// it, once per kernel instance and device (`ready` holds one bit per
// device): the attribute is a host call, and most launches of the flash
// kernels need more than the 48 KB default.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t most,
                    std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace mxtt
