// 1x1 convolution as a matrix product with BatchNorm's batch statistics
// in its epilogue, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_conv1x1_stats_kernel
// (launched by conv1x1_bn_stats) and the probe kernel of
// tools/probe_fused_convbn.py (_kernel, via fused_conv1x1_stats), which
// compute the same function:
//   y = x @ w              (M, N) in x's dtype, from an fp32 accumulator
//   mean[n]   = sum_m y[m, n] / M      fp32, from the fp32 accumulator
//   meansq[n] = sum_m y[m, n]^2 / M    (before y is cast)
// x (M, K) and w (K, N) row-major, both fp32 or both bf16. A 1x1 NHWC
// convolution is exactly this product with M = B*H*W, K = Cin, N = Cout.
//
// What bounds it on this card: operations. At ResNet-50's four probe
// shapes (batch 128) the product is 13.15 GFLOP and moves 0.1-0.5 GB, so
// at the fp32 rate outside the tensor cores (67 TFLOP/s) it needs at
// least 0.196 ms, against 0.03-0.15 ms of bytes. (In bf16 on the tensor
// cores the first shape would be bound by bytes instead; this kernel runs
// bf16 through the same fp32 FMAs and leaves wgmma for a later version.)
// The statistics add three FLOP and no byte per output: y's tile is
// summed while it is still in registers, which is the point of the
// fusion (it saves the separate pass that re-reads y).
//
// Design, and what differs from the TPU kernel:
//   * The TPU grid runs in order, so the Pallas kernel adds each row
//     block's sums into one (8, N) accumulator across grid steps. CUDA
//     blocks run in no order. Here a block owns a 64-column strip and a
//     fixed set of 128-row tiles (tile t, t + gridDim.x, ...); each
//     thread keeps its columns' sums in registers over those tiles, the
//     block reduces them in shared memory and writes one row of a
//     (gridDim.x, N) fp32 scratch. A second kernel sums the scratch rows
//     in a fixed order and scales by 1/M. No atomics: the result is the
//     same from run to run, for a given (M, N) grid.
//   * The TPU kernel keeps the whole (K, N) weight in VMEM. At K = N =
//     2048 fp32 that is 16 MB, far more than shared memory, so K-tiles
//     of 16 of both operands are streamed through shared memory instead.
//   * A plain tiled SIMT product: 256 threads, a 128 x 64 output tile,
//     8 x 4 outputs per thread in registers, operands converted to fp32
//     on load (bf16 by __bfloat162float). Any M, K, N: loads past the
//     edges read zeros, and rows past M add nothing to the statistics
//     (the JAX kernel's zero padding). Offsets are 64-bit: M * N reaches
//     about 1e8 at batch 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;            // output rows per tile
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 16;             // K step through shared memory
constexpr int kThreads = 256;
constexpr int kTM = 8;              // rows per thread
constexpr int kTN = 4;              // columns per thread
constexpr int kColGroups = kBN / kTN;   // 16
constexpr int kRowGroups = kBM / kTM;   // 16
constexpr int kPad = 4;             // A tile padding (bank conflicts)
constexpr int kFinalCols = 32;      // finalize: columns per block
constexpr int kFinalGroups = 8;     // finalize: row groups per block

static_assert(kColGroups * kRowGroups == kThreads, "thread layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ part_s,
                     float* __restrict__ part_q, long long M, int K, int N,
                     int tiles_m) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];   // A tile, k-major
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float red_s[kRowGroups][kBN];
  __shared__ float red_q[kRowGroups][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;   // which 4 columns
  const int ty = tid / kColGroups;   // which 8 rows
  const int n0 = blockIdx.y * kBN;

  float s[kTN], q[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) s[j] = q[j] = 0.f;

  for (int tm = blockIdx.x; tm < tiles_m; tm += gridDim.x) {
    const long long m0 = static_cast<long long>(tm) * kBM;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      // A: 128 rows x 16 k; neighbouring threads read neighbouring k of
      // one row, and store it transposed (k-major) for the inner loop
#pragma unroll
      for (int i = 0; i < kBM * kBK / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kBK, c = idx % kBK;
        const long long gm = m0 + r;
        const int gk = k0 + c;
        As[c][r] = (gm < M && gk < K) ? to_f32(x[gm * K + gk]) : 0.f;
      }
      // B: 16 k x 64 columns, neighbouring threads on neighbouring n
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kBN, c = idx % kBN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N)
                       ? to_f32(w[static_cast<long long>(gk) * N + gn])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: y in the output dtype; the statistics from the fp32
    // accumulator, rows past M excluded
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long gm = m0 + ty * kTM + i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gn = n0 + tx * kTN + j;
        if (gn < N) y[gm * N + gn] = from_f32<T>(acc[i][j]);
        s[j] += acc[i][j];
        q[j] = fmaf(acc[i][j], acc[i][j], q[j]);
      }
    }
  }

  // the block's sums: 16 row groups per column, added in a fixed order
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red_s[ty][tx * kTN + j] = s[j];
    red_q[ty][tx * kTN + j] = q[j];
  }
  __syncthreads();
  if (tid < kBN) {
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int r = 0; r < kRowGroups; ++r) {
      ss += red_s[r][tid];
      qq += red_q[r][tid];
    }
    const int gn = n0 + tid;
    if (gn < N) {
      const long long o = static_cast<long long>(blockIdx.x) * N + gn;
      part_s[o] = ss;
      part_q[o] = qq;
    }
  }
}

// mean / meansq from the (rows, N) partial sums: each block takes 32
// columns; 8 row groups sum rows g, g + 8, ... in order, then one thread
// per column adds the 8 group sums in order and scales by 1/M.
__global__ void __launch_bounds__(kFinalCols * kFinalGroups)
conv1x1_stats_finalize(const float* __restrict__ part_s,
                       const float* __restrict__ part_q,
                       float* __restrict__ mean, float* __restrict__ meansq,
                       int rows, int N, float inv_m) {
  __shared__ float sh_s[kFinalGroups][kFinalCols];
  __shared__ float sh_q[kFinalGroups][kFinalCols];
  const int c = threadIdx.x % kFinalCols;
  const int g = threadIdx.x / kFinalCols;
  const int n = blockIdx.x * kFinalCols + c;
  float s = 0.f, q = 0.f;
  if (n < N) {
    for (int r = g; r < rows; r += kFinalGroups) {
      const long long o = static_cast<long long>(r) * N + n;
      s += part_s[o];
      q += part_q[o];
    }
  }
  sh_s[g][c] = s;
  sh_q[g][c] = q;
  __syncthreads();
  if (g == 0 && n < N) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int i = 0; i < kFinalGroups; ++i) {
      ts += sh_s[i][c];
      tq += sh_q[i][c];
    }
    mean[n] = ts * inv_m;
    meansq[n] = tq * inv_m;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, float* part_s,
           float* part_q, float* mean, float* meansq, long long M, int K,
           int N, int grid_m, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || grid_m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (M + kBM - 1) / kBM;
  if (tiles_m > 0x7fffffffLL || grid_m > tiles_m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(grid_m, (N + kBN - 1) / kBN);
  conv1x1_stats_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), part_s, part_q, M, K, N,
      static_cast<int>(tiles_m));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1x1_stats_finalize<<<(N + kFinalCols - 1) / kFinalCols,
                           kFinalCols * kFinalGroups, 0, st>>>(
      part_s, part_q, mean, meansq, grid_m, N,
      static_cast<float>(1.0 / static_cast<double>(M)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x @ w with the per-column mean and mean square of y. part_s and
// part_q are (grid_m, N) fp32 scratch that the caller allocates; grid_m
// (1 <= grid_m <= ceil(M / 128)) is the number of row-tile groups. Returns
// cudaGetLastError() after the two launches (0 = launched), or
// cudaErrorInvalidValue without launching for an empty or oversized
// shape.
extern "C" int mxtt_conv1x1_stats_f32(const void* x, const void* w, void* y,
                                      float* part_s, float* part_q,
                                      float* mean, float* meansq,
                                      long long M, int K, int N, int grid_m,
                                      void* stream) {
  return launch<float>(x, w, y, part_s, part_q, mean, meansq, M, K, N,
                       grid_m, stream);
}

extern "C" int mxtt_conv1x1_stats_bf16(const void* x, const void* w, void* y,
                                       float* part_s, float* part_q,
                                       float* mean, float* meansq,
                                       long long M, int K, int N, int grid_m,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, w, y, part_s, part_q, mean, meansq, M, K,
                               N, grid_m, stream);
}
