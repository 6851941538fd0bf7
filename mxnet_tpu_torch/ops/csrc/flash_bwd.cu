// Flash-attention backward, fp32, for Hopper (sm_90a): two kernels.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_dkv_kernel and
// _flash_bwd_dq_kernel (launched by _flash_bwd_pallas). Same split as the
// JAX package (FlashAttention-2): one kernel accumulates dK / dV over the
// query tiles, the other dQ over the key tiles. Both recompute
//   p  = exp(s * scale - lse)     where the mask allows (qi, kj), else 0
//   dS = p * (dP - delta) * scale with dP = dO V^T
// from the compact (B*H, Sq) lse the forward kernel writes and the
// delta = rowsum(dO * O) the caller computes (and may shift, as
// flash_block_attention does), so nothing Sq x Sk ever reaches memory.
// The mask is the forward's: causal (kj <= qi, Sq == Sk) and the per-batch
// key length (kj < kv_len[b]). p is masked explicitly rather than through
// exp(-1e30 - lse) underflowing, so the dK / dV rows of keys at or past
// kv_len[b] are exactly 0 and a row with no visible key contributes 0.
//
// Layout: q, dO, dQ (B, H, Sq, D); k, v, dK, dV (B, H, Sk, D); all
// contiguous fp32. lse, delta (B*H, Sq) fp32. kv_len (B,) int32 or NULL.
//
// What bounds it on this card: at the training shape (B*H = 256, S = 64,
// D = 64) the pair moves 4 MB once each and does 8*Sq*Sk*D (dK/dV) plus
// 6*Sq*Sk*D (dQ) FLOP per (b, h): 0.94 GFLOP, 14 us at the 67 TFLOP/s fp32
// rate outside the tensor cores against 1.2 us for the bytes, so the bound
// is operations. The data is fp32 and the kernels keep fp32 FMAs (the
// tensor cores would need TF32 or bf16, i.e. other numerics than the plain
// version): that rate is the roof, and shared-memory bandwidth the wall
// under it.
//
// Design: the TPU kernels keep the reduction over the other sequence on a
// sequential "arbitrary" grid axis with VMEM scratch. Hopper blocks run in
// no order, so each block owns its output tile and loops over the other
// sequence inside: the dK/dV block owns BK = 32 keys of one (b, h) and walks
// the query tiles; the dQ block owns BQ = 32 queries and walks the key
// tiles. No block writes what another writes, so no atomics. A block has 8
// warps. For the score tile (32 x 32) warp w takes rows w, w+8, w+16, w+24
// and lane j takes key j: q and dO rows are read as warp broadcasts, and
// K and V rows are padded by one float so the 32 lanes hit 32 banks. For
// the accumulations the lanes run over D (coalesced, conflict-free) and
// each warp owns 4 rows of the output tile in registers. Tiles of the
// other sequence that hold no live (qi, kj) pair — above the diagonal
// when causal, at or past kv_len — are never loaded (the TPU kernels'
// pl.when skip), and a dK/dV block whose keys all lie at or past kv_len
// writes zeros and stops. The ragged edge (Sq or Sk not a multiple of 32)
// is masked here: every shape launches, no 128-multiple gate. Tiles live
// in dynamic shared memory: 41 KB at D = 64, 74 KB at D = 128 (above the
// 48 KB static limit, hence cudaFuncSetAttribute).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 32;                  // query rows per tile
constexpr int kBK = 32;                  // key rows per tile: one per lane
constexpr int kRows = kBQ / kWarps;      // tile rows per warp
constexpr unsigned kStaticSmem = 48 * 1024;

// s[r] = q_i . k_j and dp[r] = dO_i . v_j for i = warp + 8r, j = lane.
// qs / dos rows have stride D; ks / vs rows stride D + 1.
__device__ __forceinline__ void score_tile(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int D, int warp, int lane,
                                           float s[kRows], float dp[kRows]) {
  const float* krow = ks + lane * (D + 1);
  const float* vrow = vs + lane * (D + 1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  for (int c = 0; c < D; ++c) {
    const float kc = krow[c];
    const float vc = vrow[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      s[r] = fmaf(qs[i * D + c], kc, s[r]);
      dp[r] = fmaf(dos[i * D + c], vc, dp[r]);
    }
  }
}

// rows [r0, r0 + n) of a (rows, D) matrix into shared rows of stride
// `pitch`; rows past `limit` are zeros
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, int r0, int n,
                                          int limit, int D, int tid) {
  for (int idx = tid; idx < n * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * pitch + c] = (r0 + r < limit) ? src[(size_t)(r0 + r) * D + c]
                                          : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dK / dV: grid (B*H, ceil(Sk / BK))
// ---------------------------------------------------------------------------
template <int DCH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int causal,
                         float sm_scale) {
  extern __shared__ float smem[];
  const int dpad = D + 1;
  float* ks = smem;                   // kBK x (D + 1)
  float* vs = ks + kBK * dpad;        // kBK x (D + 1)
  float* qs = vs + kBK * dpad;        // kBQ x D
  float* dos = qs + kBQ * D;          // kBQ x D
  float* ps = dos + kBQ * D;          // kBQ x kBK
  float* dss = ps + kBQ * kBK;        // kBQ x kBK
  float* lse_s = dss + kBQ * kBK;     // kBQ
  float* delta_s = lse_s + kBQ;       // kBQ

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));

  float dk_acc[kRows][DCH], dv_acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  if (k0 < kend) {
    load_rows(ks, dpad, k + kbase, k0, kBK, Sk, D, tid);
    load_rows(vs, dpad, v + kbase, k0, kBK, Sk, D, tid);
    // causal: query tiles wholly above this key tile see none of its keys
    const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
    for (int q0 = qstart; q0 < Sq; q0 += kBQ) {
      __syncthreads();  // the previous query tile is consumed
      load_rows(qs, D, q + qbase, q0, kBQ, Sq, D, tid);
      load_rows(dos, D, dout + qbase, q0, kBQ, Sq, D, tid);
      if (tid < kBQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[kRows], dp[kRows];
      score_tile(qs, dos, ks, vs, D, warp, lane, s, dp);
      const int kj = k0 + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = warp + kWarps * r;
        const int qi = q0 + i;
        const bool keep = qi < Sq && kj < kend && (!causal || kj <= qi);
        const float p = keep ? expf(s[r] * sm_scale - lse_s[i]) : 0.f;
        ps[i * kBK + lane] = p;
        dss[i * kBK + lane] = p * (dp[r] - delta_s[i]) * sm_scale;
      }
      __syncthreads();

      // dV[j] += sum_i p[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
      const int ni = min(kBQ, Sq - q0);
      for (int i = 0; i < ni; ++i) {
        const float* qrow = qs + i * D;
        const float* dorow = dos + i * D;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = warp + kWarps * r;
          const float pij = ps[i * kBK + j];
          const float dsij = dss[i * kBK + j];
#pragma unroll
          for (int c = 0; c < DCH; ++c) {
            const int d = lane + 32 * c;
            if (d < D) {
              dv_acc[r][c] = fmaf(pij, dorow[d], dv_acc[r][c]);
              dk_acc[r][c] = fmaf(dsij, qrow[d], dk_acc[r][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + warp + kWarps * r;
    if (kj >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[kbase + (size_t)kj * D + d] = dk_acc[r][c];
        dv[kbase + (size_t)kj * D + d] = dv_acc[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (B*H, ceil(Sq / BQ))
// ---------------------------------------------------------------------------
template <int DCH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_len,
                        float* __restrict__ dq, int H, int Sq, int Sk, int D,
                        int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int dpad = D + 1;
  float* ks = smem;                   // kBK x (D + 1)
  float* vs = ks + kBK * dpad;        // kBK x (D + 1)
  float* qs = vs + kBK * dpad;        // kBQ x D
  float* dos = qs + kBQ * D;          // kBQ x D
  float* dss = dos + kBQ * D;         // kBQ x kBK
  float* lse_s = dss + kBQ * kBK;     // kBQ
  float* delta_s = lse_s + kBQ;       // kBQ

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  // key tiles starting at or past kstop hold no live key for these rows
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + kBQ);

  load_rows(qs, D, q + qbase, q0, kBQ, Sq, D, tid);
  load_rows(dos, D, dout + qbase, q0, kBQ, Sq, D, tid);
  if (tid < kBQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
  }

  float dq_acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dq_acc[r][c] = 0.f;

  for (int k0 = 0; k0 < kstop; k0 += kBK) {
    __syncthreads();  // the previous key tile is consumed (q is staged)
    load_rows(ks, dpad, k + kbase, k0, kBK, Sk, D, tid);
    load_rows(vs, dpad, v + kbase, k0, kBK, Sk, D, tid);
    __syncthreads();

    float s[kRows], dp[kRows];
    score_tile(qs, dos, ks, vs, D, warp, lane, s, dp);
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      const int qi = q0 + i;
      const bool keep = qi < Sq && kj < kend && (!causal || kj <= qi);
      const float p = keep ? expf(s[r] * sm_scale - lse_s[i]) : 0.f;
      dss[i * kBK + lane] = p * (dp[r] - delta_s[i]) * sm_scale;
    }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j], over the keys of the tile below kend
    const int nj = min(kBK, kend - k0);
    for (int j = 0; j < nj; ++j) {
      const float* krow = ks + j * dpad;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsij = dss[(warp + kWarps * r) * kBK + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          const int d = lane + 32 * c;
          if (d < D) dq_acc[r][c] = fmaf(dsij, krow[d], dq_acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp + kWarps * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[qbase + (size_t)qi * D + d] = dq_acc[r][c];
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DCH>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const int* kv_len, float* dk, float* dv, int B, int H, int Sq,
               int Sk, int D, int causal, float sm_scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * D +
                                       2 * kBQ * kBK + 2 * kBQ);
  cudaError_t err = prepare(flash_bwd_dkv_f32_kernel<DCH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + kBK - 1) / kBK);
  flash_bwd_dkv_f32_kernel<DCH><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dk, dv, H, Sq, Sk, D, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DCH>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const int* kv_len, float* dq, int B, int H, int Sq, int Sk,
              int D, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * D +
                                       kBQ * kBK + 2 * kBQ);
  cudaError_t err = prepare(flash_bwd_dq_f32_kernel<DCH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_bwd_dq_f32_kernel<DCH><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int mxtt_flash_bwd_dkv_f32(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* delta,
                                      const int* kv_len, float* dk,
                                      float* dv, int B, int H, int Sq,
                                      int Sk, int D, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_DKV(DCH)                                                        \
  launch_dkv<DCH>(q, k, v, dout, lse, delta, kv_len, dk, dv, B, H, Sq, Sk, \
                  D, causal, sm_scale, st)
  if (D <= 32) return MXTT_DKV(1);
  if (D <= 64) return MXTT_DKV(2);
  if (D <= 96) return MXTT_DKV(3);
  if (D <= 128) return MXTT_DKV(4);
#undef MXTT_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mxtt_flash_bwd_dq_f32(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     const float* lse, const float* delta,
                                     const int* kv_len, float* dq, int B,
                                     int H, int Sq, int Sk, int D, int causal,
                                     float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_DQ(DCH)                                                         \
  launch_dq<DCH>(q, k, v, dout, lse, delta, kv_len, dq, B, H, Sq, Sk, D,   \
                 causal, sm_scale, st)
  if (D <= 32) return MXTT_DQ(1);
  if (D <= 64) return MXTT_DQ(2);
  if (D <= 96) return MXTT_DQ(3);
  if (D <= 128) return MXTT_DQ(4);
#undef MXTT_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
