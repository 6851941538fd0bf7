// Flash-attention forward, fp32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas). Same function: online-softmax attention with fp32
// m / l / acc, an optional causal mask (qi >= kj), an optional per-batch
// key-length mask (kj < kv_len[b]), masked scores set to the finite -1e30
// the JAX package uses, a guarded divide so a row with no visible key
// writes zeros, and the per-row log-sum-exp m + log(max(l, 1e-30)).
// Sq may differ from Sk.
//
// Layout: q (B, H, Sq, D), k / v (B, H, Sk, D), out (B, H, Sq, D), all
// contiguous fp32; kv_len (B,) int32 or NULL; lse (B*H, Sq) fp32 — compact:
// the 128-lane broadcast of the TPU version is a Mosaic tiling constraint
// and is not copied.
//
// What bounds it on this card: at the serving prefill shape (B=1, H=8,
// S=128, D=64, kv_len 77) the function moves 0.85 MB (q, out, lse and the
// 77 live K/V rows, once each: 0.25 us at 3.35 TB/s) and does 20 MFLOP
// (0.30 us at the 67 TFLOP/s fp32 non-tensor-core rate), so its bound is
// 0.30 us, by operations. What is left is latency: the
// launch and each warp's serial walk over the key tiles. The data is fp32,
// so the dots run as fp32 FMAs (the tensor cores would need TF32 or bf16,
// i.e. other numerics than the plain version).
//
// Design: grid (B*H, ceil(Sq/BQ)); the TPU's sequential kv grid axis
// becomes a loop inside the block, because Hopper blocks run in no order.
// Each block stages its BQ = 8 query rows and, tile by tile, BK = 32 keys
// and values in shared memory (K rows padded by one float so the 32 lanes
// of a warp, one key each, hit 32 different banks). Each of the 8 warps
// owns one query row, so the serving shape runs 128 blocks of 8
// independent warps (PERF.md has the time of a first version with 4 rows
// per warp and 64 blocks); lane j scores key j of the tile with four
// partial sums,
// warp shuffles give the row max and sum, and the P.V update broadcasts
// p_j by shuffle while each lane owns D/32 output columns, stopping at the
// last key below the length. Tiles at or past min(Sk, kv_len[b]) and, when
// causal, tiles entirely above the diagonal are never loaded (the TPU's
// pl.when skip). The ragged edge (Sq or Sk not a multiple of the tile) is
// masked here, so every shape launches — no 128-multiple gate.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps;                  // query rows per block: one
                                             // per warp
constexpr int kBK = 32;                      // keys per tile: one per lane
constexpr float kMasked = -1e30f;            // the JAX package's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// DCH = ceil(D / 32): output columns per lane
template <int DCH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ kv_len, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int dpad = D + 1;
  float* ks = smem;                  // kBK x (D + 1)
  float* vs = ks + kBK * dpad;       // kBK x D
  float* qs = vs + kBK * D;          // kBQ x D

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;

  // keys at or past kend are masked for every row of the block
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  // tiles starting at or past kstop hold no visible key for any row here
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + kBQ);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = (q0 + r < Sq) ? q[qbase + (size_t)q0 * D + i] : 0.f;
  }

  const int qi = q0 + warp;    // this warp's row; past Sq: never stored
  const float* qrow = qs + warp * D;
  float m = kMasked, l = 0.f, acc[DCH];
#pragma unroll
  for (int c = 0; c < DCH; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < kstop; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (q is staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const bool in = k0 + r < Sk;
      const size_t g = kbase + (size_t)k0 * D + i;
      ks[r * dpad + c] = in ? k[g] : 0.f;
      vs[i] = in ? v[g] : 0.f;
    }
    __syncthreads();

    // lane j scores key k0 + j; four partial sums keep the FMA chain short
    const int kj = k0 + lane;
    const float* krow = ks + lane * dpad;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int c = 0;
    for (; c + 4 <= D; c += 4) {
      s0 = fmaf(qrow[c], krow[c], s0);
      s1 = fmaf(qrow[c + 1], krow[c + 1], s1);
      s2 = fmaf(qrow[c + 2], krow[c + 2], s2);
      s3 = fmaf(qrow[c + 3], krow[c + 3], s3);
    }
    for (; c < D; ++c) s0 = fmaf(qrow[c], krow[c], s0);
    float s = ((s0 + s1) + (s2 + s3)) * sm_scale;
    const bool keep = kj < kend && (!causal || kj <= qi);
    s = keep ? s : kMasked;

    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) acc[cc] *= alpha;
    // keys past kend have p == 0 exactly once a visible key set m; the
    // walk stops at the tile's last key below kend
    const int nj = min(kBK, kend - k0);
    for (int j = 0; j < nj; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const float* vrow = vs + j * D;
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc) {
        const int d = lane + 32 * cc;
        if (d < D) acc[cc] = fmaf(pj, vrow[d], acc[cc]);
      }
    }
    m = m_new;
  }

  if (qi < Sq) {
    // a row with every key masked has l == 0: it writes zeros
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) out[qbase + (size_t)qi * D + d] = acc[cc] / denom;
    }
    if (lane == 0) lse[(size_t)bh * Sq + qi] = m + logf(denom);
  }
}

template <int DCH>
void launch(const float* q, const float* k, const float* v, const int* kv_len,
            float* out, float* lse, int B, int H, int Sq, int Sk, int D,
            int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  const size_t smem = sizeof(float) * (kBK * (D + 1) + kBK * D + kBQ * D);
  flash_fwd_f32_kernel<DCH><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_len, out, lse, H, Sq, Sk, D, causal, sm_scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mxtt_flash_fwd_f32(const float* q, const float* k,
                                  const float* v, const int* kv_len,
                                  float* out, float* lse, int B, int H,
                                  int Sq, int Sk, int D, int causal,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) {
    launch<1>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, sm_scale, st);
  } else if (D <= 64) {
    launch<2>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, sm_scale, st);
  } else if (D <= 96) {
    launch<3>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, sm_scale, st);
  } else if (D <= 128) {
    launch<4>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, sm_scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
