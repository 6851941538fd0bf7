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
// (rows,). Any row count; D = 512 only (transformer_base's units), and the
// entry point refuses any other width: a model that needs another width
// adds its version here.
//
// What bounds it on this card: bytes. Each element is read once and
// written once with about 8 FLOP between: at the training shape
// (2048 x 512) that is 8.4 MB, 2.5 us at 3.35 TB/s, against 0.13 us of
// fp32 arithmetic.
//
// Design: one warp per row, 8 rows per 256-thread block. The TPU kernel
// holds a (256, D) block in VMEM; here a row lives in the warp's
// registers (lane l holds elements l, l + 32, ...: each load and store
// instruction of the warp touches 128 contiguous bytes), so x is read from
// memory exactly once and both passes over it (mean, then centred
// variance) run from registers, with warp shuffles for the two sums. No
// shared memory, no block-wide barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kD = 512;
constexpr int kPerLane = kD / 32;  // values of a row each lane holds
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
layer_norm_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int rows, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + (size_t)row * kD;
  float vals[kPerLane];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    vals[c] = xr[lane + 32 * c];
    sum += vals[c];
  }
  const float mu = warp_sum(sum) / kD;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    vals[c] -= mu;
    sq = fmaf(vals[c], vals[c], sq);
  }
  const float rs = rsqrtf(warp_sum(sq) / kD + eps);
  float* yr = y + (size_t)row * kD;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int d = lane + 32 * c;
    yr[d] = (vals[c] * rs) * gamma[d] + beta[d];
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue without launching for rows <= 0 or D != 512.
extern "C" int mxtt_layer_norm_f32(const float* x, const float* gamma,
                                   const float* beta, float* y, float* mean,
                                   float* rstd, int rows, int D, float eps,
                                   void* stream) {
  if (rows <= 0 || D != kD) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_f32_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, gamma, beta, y, mean, rstd, rows, eps);
  return static_cast<int>(cudaGetLastError());
}
