// LayerNorm forward over the last axis, fp32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_ln_kernel (launched by
// _fused_ln_fwd_impl). Same function, with fp32 statistics: mean first,
// then the variance of the centred values (not E[x^2] - E[x]^2), then
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// and it writes y, mean and rstd (the backward's residuals). The backward
// (_fused_ln_vjp_bwd) was XLA in the JAX package and is plain torch here.
//
// Layout: x, y (rows, D) contiguous fp32; gamma, beta (D,), fp32 or
// bf16 (a model after cast("bfloat16") whose activations stay fp32, as
// the JAX package's do: the kernel reads gamma as fp32,
// pallas_kernels.py:1216-1217); mean, rstd (rows,). Any row count and any width D >= 1. The TPU kernel takes
// D % 128 == 0 (and rows % 8 == 0) and leaves other shapes to XLA; here
// the ragged edge of a row is masked, so one kernel family takes them all.
//
// What bounds it on this card: bytes. Each element is read once and
// written once with about 8 FLOP between: at BERT's shape (8192 x 768)
// that is 50.3 MB, 15.0 us at 3.35 TB/s, against 0.75 us of fp32
// arithmetic.
//
// Design, two forms chosen by D:
//   * D <= kWarpMaxD (1024): one warp per row, 8 rows per 256-thread
//     block. A row lives in the warp's registers: lane l holds elements
//     l, l + 32, ... (VPL of them, VPL the smallest of 4, 8, 16, 24, 32
//     that covers D / 32; a template parameter, so the array stays in
//     registers), each load and store instruction of the warp touches 128
//     contiguous bytes, and elements at or past D are masked. x is read
//     from memory once; both passes over it (mean, then centred variance)
//     run from registers, with warp shuffles for the two sums. No shared
//     memory, no block-wide barrier. The TPU kernel's (256, D) VMEM block
//     becomes 8 rows of registers: the card needs many small blocks in
//     flight rather than a few large ones.
//   * D > kWarpMaxD: one 256-thread block per row, each thread striding
//     the row by 256. A row is too wide for one warp's registers, so the
//     block reads it three times (sum, centred squares, output); the
//     first read comes from memory and the other two mostly from L1 / L2
//     (a row of 8192 floats is 32 KB). The two sums reduce across the
//     block's 8 warps through shared memory.
// Both forms are templates on gamma / beta's type G and widen each
// element to fp32 where y is formed (to_f32); with fp32 G that is the
// identity, so the fp32 kernels' arithmetic and bits are one code.
//
// bfloat16 and float16 forms (mxtt_layer_norm_bf16, mxtt_layer_norm_f16;
// one code, templates on x's type X): x and y in X, gamma / beta fp32 or
// X (read as fp32; float16 AMP leaves them fp32, cast("float16") makes
// them f16), fp32 statistics; y = ((x - mean) * rstd) * gamma + beta in
// fp32, rounded once to X (_ln_kernel's astype(o_ref.dtype),
// pallas_kernels.py:1216-1217), on chunks of 8 values (16 bytes). Lane l
// of the one-warp form (D <= 1024) holds chunks l, l + 32, ... (C of them,
// the smallest of 1-4 that covers D / 256). Above that, one block a row
// holds the row in registers too, as the bf16 it reads (4 registers a
// chunk, so many blocks stay resident an SM), and x is read from memory
// once: thread i of NT holds chunks i, i + NT, ... (C of them; template
// parameters: 128 threads x 2 chunks up to D = 2048, 128 x 4 up to 4096,
// 256 x 4 up to 8192). The mean and then the centred variance come from
// the registers with one block sum each, and y is written from the same
// registers. (The fp32 form's one-block form reads its row three times;
// above D = 8192 the bf16 form does too, 256 threads striding the row.)
// A chunk is one
// 16-byte load or store when D % 8 == 0 and x, y, gamma and beta are
// 16-byte aligned (`vec`), else 8 masked element loads: the element each
// thread holds, and so every sum's order, is the same either way. Where
// `vec` holds, a chunk's 8 gamma and 8 beta come in 16-byte loads too
// (two each in fp32, one each in 16 bits; `load_param8`) when y is
// formed: read one 4-byte load an element, fp32 gamma made the fp16 form
// at (1216, 768) 1.30x slower than F.layer_norm. Loading them beside the
// chunk's x instead (16 registers a chunk, their latency under the row's
// sums) made fp32 and 16-bit gamma cost the same but slowed the forms
// 1.2-1.5x at 8192 rows of 768 and 1024. Each thread sums its
// elements in order, then the warp (and the block) as in the fp32 form.
// At (2048, 4096) the bytes are 33.6 MB, 10.0 us at 3.35 TB/s (the
// three-read form this replaced ran at 0.62 of that bound).
// At BERT's shape (8192 x 768) the bytes are 25.2 MB, 7.5 us at 3.35
// TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpMaxD = 1024;    // widest row the one-warp form holds
// widest bf16 row a block holds in registers (256 threads x 4 chunks)
constexpr int kRegMaxD = 8192;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
// an fp32 value rounded (to nearest even) to the 16-bit type X
template <typename X>
__device__ __forceinline__ X from_f32(float v) {
  if constexpr (std::is_same<X, f16>::value)
    return __float2half_rn(v);
  else
    return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// VPL: values of a row each lane holds (VPL * 32 >= D); G: gamma / beta
template <typename G, int VPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp_kernel(const float* __restrict__ x,
                       const G* __restrict__ gamma,
                       const G* __restrict__ beta, float* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + (size_t)row * D;
  float vals[VPL];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < VPL; ++c) {
    const int d = lane + 32 * c;
    vals[c] = d < D ? xr[d] : 0.f;
    sum += vals[c];
  }
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < VPL; ++c) {
    // masked slots become -mu here: keep them out of the sum
    vals[c] -= mu;
    if (lane + 32 * c < D) sq = fmaf(vals[c], vals[c], sq);
  }
  const float rs = rsqrtf(warp_sum(sq) / D + eps);
  float* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < VPL; ++c) {
    const int d = lane + 32 * c;
    if (d < D) yr[d] = (vals[c] * rs) * to_f32(gamma[d]) + to_f32(beta[d]);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// the sum of every thread's `v` over a block of NW warps, in every
// thread; `red` holds NW floats and is free again when this returns
template <int NW = kWarps>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red[w];
  __syncthreads();
  return total;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
layer_norm_row_kernel(const float* __restrict__ x,
                      const G* __restrict__ gamma,
                      const G* __restrict__ beta, float* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int D, float eps) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * D;
  float sum = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) sum += xr[d];
  const float mu = block_sum(sum, red) / D;
  float sq = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = xr[d] - mu;
    sq = fmaf(v, v, sq);
  }
  const float rs = rsqrtf(block_sum(sq, red) / D + eps);
  float* yr = y + (size_t)row * D;
  for (int d = threadIdx.x; d < D; d += kThreads)
    yr[d] = ((xr[d] - mu) * rs) * to_f32(gamma[d]) + to_f32(beta[d]);
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename G>
int launch_f32(const float* x, const G* gamma, const G* beta, float* y,
               float* mean, float* rstd, int rows, int D, float eps,
               cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  const int vpl = (D + 31) / 32;
#define MXTT_LN_WARP(VPL)                                                   \
  layer_norm_warp_kernel<G, VPL><<<blocks, kThreads, 0, s>>>(               \
      x, gamma, beta, y, mean, rstd, rows, D, eps)
  if (vpl <= 4) {
    MXTT_LN_WARP(4);
  } else if (vpl <= 8) {
    MXTT_LN_WARP(8);
  } else if (vpl <= 16) {
    MXTT_LN_WARP(16);
  } else if (vpl <= 24) {
    MXTT_LN_WARP(24);
  } else if (D <= kWarpMaxD) {
    MXTT_LN_WARP(32);
  } else {
    layer_norm_row_kernel<G><<<rows, kThreads, 0, s>>>(x, gamma, beta, y,
                                                        mean, rstd, D, eps);
  }
#undef MXTT_LN_WARP
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 and float16 forms: templates on x's type X (bf16 or f16, both
// 2 bytes, so chunks of 8 are 16 bytes either way), deduced from x
// ---------------------------------------------------------------------------

// the 8 elements of chunk c (elements 8c .. 8c + 7) of a row, zeros past D
template <typename X>
__device__ __forceinline__ void load_chunk(const X* xr, int c, int D,
                                           bool vec, float out[8]) {
  const int d0 = 8 * c;
  if (vec) {
    if (d0 < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + d0);
      const X* h = reinterpret_cast<const X*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = to_f32(h[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = d0 + i < D ? to_f32(xr[d0 + i]) : 0.f;
  }
}

// the 8 values of gamma or beta at d0 .. d0 + 7 (d0 + 8 <= D, the base
// 16-byte aligned) as fp32: two 16-byte loads of fp32, one of 16-bit
template <typename G>
__device__ __forceinline__ void load_param8(const G* __restrict__ p, int d0,
                                            float out[8]) {
  if constexpr (std::is_same<G, float>::value) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + d0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + d0 + 4));
    const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = f[i];
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + d0));
    const G* h = reinterpret_cast<const G*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_f32(h[i]);
  }
}

// y of chunk c from its centred values v: (v * rs) * gamma + beta,
// rounded to X; the elements past D are not written. vec (D % 8 == 0 and
// x, y, gamma, beta 16-byte aligned): gamma and beta in 16-byte loads
// (`load_param8`), y in one 16-byte store; else one masked load an
// element. The arithmetic is the same either way
template <typename G, typename X>
__device__ __forceinline__ void store_chunk(X* yr, int c, int D, bool vec,
                                            const float v[8], float rs,
                                            const G* __restrict__ gamma,
                                            const G* __restrict__ beta) {
  const int d0 = 8 * c;
  if (d0 >= D) return;
  X h[8];
  if (vec) {
    float ga[8], be[8];
    load_param8(gamma, d0, ga);
    load_param8(beta, d0, be);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = from_f32<X>((v[i] * rs) * ga[i] + be[i]);
    *reinterpret_cast<uint4*>(yr + d0) = *reinterpret_cast<const uint4*>(h);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = min(d0 + i, D - 1);
      h[i] = from_f32<X>((v[i] * rs) * to_f32(gamma[d]) + to_f32(beta[d]));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (d0 + i < D) yr[d0 + i] = h[i];
  }
}

// C: chunks of 8 a lane holds (256 * C >= D)
template <typename G, int C, typename X>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp_bf16_kernel(const X* __restrict__ x,
                            const G* __restrict__ gamma,
                            const G* __restrict__ beta, X* __restrict__ y,
                            float* __restrict__ mean,
                            float* __restrict__ rstd, int rows, int D,
                            float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const X* xr = x + (size_t)row * D;
  float vals[C][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    load_chunk(xr, lane + 32 * c, D, vec, vals[c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += vals[c][i];
  }
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // masked slots become -mu here: keep them out of the sum
      vals[c][i] -= mu;
      if (8 * (lane + 32 * c) + i < D) sq = fmaf(vals[c][i], vals[c][i], sq);
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / D + eps);
  X* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < C; ++c)
    store_chunk(yr, lane + 32 * c, D, vec, vals[c], rs, gamma, beta);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// the 8 values of chunk c (elements 8c .. 8c + 7) of a row as they lie
// in memory, zeros past D: one 16-byte load (`vec`) or 8 masked ones
template <typename X>
__device__ __forceinline__ uint4 load_raw(const X* xr, int c, int D,
                                          bool vec) {
  const int d0 = 8 * c;
  if (vec)
    return d0 < D ? *reinterpret_cast<const uint4*>(xr + d0)
                  : make_uint4(0u, 0u, 0u, 0u);
  X h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = d0 + i < D ? xr[d0 + i] : from_f32<X>(0.f);
  return *reinterpret_cast<const uint4*>(h);
}

template <typename X>
__device__ __forceinline__ void unpack(const uint4& raw, float out[8]) {
  const X* h = reinterpret_cast<const X*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f32(h[i]);
}

// the one-block-a-row form: a row in the registers of NT threads, thread
// i holding chunks i, i + NT, ... (C of them, NT * C >= the row's chunks)
// as the X they are in memory (4 registers a chunk), read from memory
// once; the mean, then the centred variance from the registers, each one
// block sum; y from the same registers
template <typename G, int NT, int C, typename X>
__global__ void __launch_bounds__(NT)
layer_norm_row_bf16_kernel(const X* __restrict__ x,
                           const G* __restrict__ gamma,
                           const G* __restrict__ beta, X* __restrict__ y,
                           float* __restrict__ mean, float* __restrict__ rstd,
                           int D, float eps, int vec) {
  __shared__ float red[NT / 32];
  const int row = blockIdx.x;
  const X* xr = x + (size_t)row * D;
  uint4 raw[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    raw[c] = load_raw(xr, threadIdx.x + NT * c, D, vec);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[8];
    unpack<X>(raw[c], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  const float mu = block_sum<NT / 32>(sum, red) / D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[8];
    unpack<X>(raw[c], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float u = v[i] - mu;
      if (8 * (threadIdx.x + NT * c) + i < D) sq = fmaf(u, u, sq);
    }
  }
  const float rs = rsqrtf(block_sum<NT / 32>(sq, red) / D + eps);
  X* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[8];
    unpack<X>(raw[c], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] -= mu;
    store_chunk(yr, threadIdx.x + NT * c, D, vec, v, rs, gamma, beta);
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// rows wider than a block holds in registers (kRegMaxD): 256 threads
// stride the row by 256 chunks and read it three times (sum, centred
// squares, output), the first from memory and the others mostly from
// L1 / L2
template <typename G, typename X>
__global__ void __launch_bounds__(kThreads)
layer_norm_strided_bf16_kernel(const X* __restrict__ x,
                               const G* __restrict__ gamma,
                               const G* __restrict__ beta,
                               X* __restrict__ y, float* __restrict__ mean,
                               float* __restrict__ rstd, int D, float eps,
                               int vec) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const int chunks = (D + 7) / 8;
  const X* xr = x + (size_t)row * D;
  float v[8];
  float sum = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    load_chunk(xr, c, D, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  const float mu = block_sum(sum, red) / D;
  float sq = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    load_chunk(xr, c, D, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float u = v[i] - mu;
      if (8 * c + i < D) sq = fmaf(u, u, sq);
    }
  }
  const float rs = rsqrtf(block_sum(sq, red) / D + eps);
  X* yr = y + (size_t)row * D;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    load_chunk(xr, c, D, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] -= mu;
    store_chunk(yr, c, D, vec, v, rs, gamma, beta);
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename G, typename X>
int launch_bf16(const X* x, const G* gamma, const G* beta, X* y,
                float* mean, float* rstd, int rows, int D, float eps,
                int vec, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  const int chunks = (D + 7) / 8;
#define MXTT_LN_WARP(C)                                                     \
  layer_norm_warp_bf16_kernel<G, C><<<blocks, kThreads, 0, s>>>(            \
      x, gamma, beta, y, mean, rstd, rows, D, eps, vec)
#define MXTT_LN_ROW(NT, C)                                                  \
  layer_norm_row_bf16_kernel<G, NT, C><<<rows, NT, 0, s>>>(                 \
      x, gamma, beta, y, mean, rstd, D, eps, vec)
  // wider than one warp holds: the row in registers up to kRegMaxD
  if (chunks <= 32) {
    MXTT_LN_WARP(1);
  } else if (chunks <= 64) {
    MXTT_LN_WARP(2);
  } else if (chunks <= 96) {
    MXTT_LN_WARP(3);
  } else if (D <= kWarpMaxD) {
    MXTT_LN_WARP(4);
  } else if (chunks <= 2 * 128) {
    MXTT_LN_ROW(128, 2);
  } else if (chunks <= 4 * 128) {
    MXTT_LN_ROW(128, 4);
  } else if (D <= kRegMaxD) {
    MXTT_LN_ROW(256, 4);
  } else {
    layer_norm_strided_bf16_kernel<G><<<rows, kThreads, 0, s>>>(
        x, gamma, beta, y, mean, rstd, D, eps, vec);
  }
#undef MXTT_LN_ROW
#undef MXTT_LN_WARP
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 form: fp32 x and y, gamma / beta bf16 when gamma_bf16 else
// fp32, fp32 mean and rstd. Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue without launching for
// rows <= 0 or D <= 0.
extern "C" int mxtt_layer_norm_f32(const float* x, const void* gamma,
                                   const void* beta, float* y, float* mean,
                                   float* rstd, int rows, int D, float eps,
                                   int gamma_bf16, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gamma_bf16)
    return launch_f32(x, static_cast<const bf16*>(gamma),
                      static_cast<const bf16*>(beta), y, mean, rstd, rows, D,
                      eps, s);
  return launch_f32(x, static_cast<const float*>(gamma),
                    static_cast<const float*>(beta), y, mean, rstd, rows, D,
                    eps, s);
}

// The 16-bit forms: x and y of one type X, gamma / beta of X's type when
// gamma_x (else fp32), fp32 mean and rstd; vec: D % 8 == 0 and x, y,
// gamma, beta 16-byte aligned. The same return codes.
template <typename X>
int layer_norm_16(const void* x, const void* gamma, const void* beta,
                  void* y, float* mean, float* rstd, int rows, int D,
                  float eps, int gamma_x, int vec, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const X* xb = static_cast<const X*>(x);
  X* yb = static_cast<X*>(y);
  if (gamma_x)
    return launch_bf16(xb, static_cast<const X*>(gamma),
                       static_cast<const X*>(beta), yb, mean, rstd, rows, D,
                       eps, vec, s);
  return launch_bf16(xb, static_cast<const float*>(gamma),
                     static_cast<const float*>(beta), yb, mean, rstd, rows, D,
                     eps, vec, s);
}

// The bfloat16 form: bf16 x and y, gamma / beta bf16 when gamma_bf16 else
// fp32.
extern "C" int mxtt_layer_norm_bf16(const void* x, const void* gamma,
                                    const void* beta, void* y, float* mean,
                                    float* rstd, int rows, int D, float eps,
                                    int gamma_bf16, int vec, void* stream) {
  return layer_norm_16<bf16>(x, gamma, beta, y, mean, rstd, rows, D, eps,
                             gamma_bf16, vec, stream);
}

// The float16 form: f16 x and y, gamma / beta f16 when gamma_f16 (a block
// after cast("float16")) else fp32 (AMP keeps LayerNorm's parameters fp32).
extern "C" int mxtt_layer_norm_f16(const void* x, const void* gamma,
                                   const void* beta, void* y, float* mean,
                                   float* rstd, int rows, int D, float eps,
                                   int gamma_f16, int vec, void* stream) {
  return layer_norm_16<f16>(x, gamma, beta, y, mean, rstd, rows, D, eps,
                            gamma_f16, vec, stream);
}
