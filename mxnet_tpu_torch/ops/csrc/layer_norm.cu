// LayerNorm forward over the last axis, fp32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_ln_kernel (launched by
// _fused_ln_fwd_impl). Same function, with fp32 statistics: mean first,
// then the variance of the centred values (not E[x^2] - E[x]^2), then
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// and it writes y, mean and rstd (the backward's residuals). The backward
// (_fused_ln_vjp_bwd) was XLA in the JAX package and is plain torch here.
//
// Layout: x, y (rows, D) contiguous fp32; gamma, beta (D,); mean, rstd
// (rows,). Any row count and any width D >= 1. The TPU kernel takes
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
#include <cuda_runtime.h>

namespace {

constexpr int kWarpMaxD = 1024;    // widest row the one-warp form holds
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// VPL: values of a row each lane holds (VPL * 32 >= D)
template <int VPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y,
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
    if (d < D) yr[d] = (vals[c] * rs) * gamma[d] + beta[d];
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// the sum of every thread's `v` over the block, in every thread; `red`
// holds kWarps floats and is free again when this returns
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
layer_norm_row_kernel(const float* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
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
    yr[d] = ((xr[d] - mu) * rs) * gamma[d] + beta[d];
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <int VPL>
void launch_warp(const float* x, const float* gamma, const float* beta,
                 float* y, float* mean, float* rstd, int rows, int D,
                 float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_warp_kernel<VPL><<<blocks, kThreads, 0, stream>>>(
      x, gamma, beta, y, mean, rstd, rows, D, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue without launching for rows <= 0 or D <= 0.
extern "C" int mxtt_layer_norm_f32(const float* x, const float* gamma,
                                   const float* beta, float* y, float* mean,
                                   float* rstd, int rows, int D, float eps,
                                   void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = (D + 31) / 32;
  if (vpl <= 4) {
    launch_warp<4>(x, gamma, beta, y, mean, rstd, rows, D, eps, s);
  } else if (vpl <= 8) {
    launch_warp<8>(x, gamma, beta, y, mean, rstd, rows, D, eps, s);
  } else if (vpl <= 16) {
    launch_warp<16>(x, gamma, beta, y, mean, rstd, rows, D, eps, s);
  } else if (vpl <= 24) {
    launch_warp<24>(x, gamma, beta, y, mean, rstd, rows, D, eps, s);
  } else if (D <= kWarpMaxD) {
    launch_warp<32>(x, gamma, beta, y, mean, rstd, rows, D, eps, s);
  } else {
    layer_norm_row_kernel<<<rows, kThreads, 0, s>>>(x, gamma, beta, y, mean,
                                                     rstd, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
