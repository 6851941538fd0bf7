// Ragged paged attention (one query per decode slot), fp32, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_rpa_kernel (launched by
// _rpa_pallas), fp pages. Same function: slot s attends with its single
// query over the first lengths[s] positions of its own pages, read through
// page_tables[s]; online softmax in fp32, masked scores at the finite
// -1e30 the JAX package uses, a guarded divide (a slot of length 0 writes
// zeros). Pages past a slot's length are never read, so mixed-length slots
// share one launch.
//
// Layout: q (S, H, dh) contiguous; k_pages / v_pages (P, psize, H, dh) read
// in place through their page / row / head strides (the layer slice of
// the runtime's (L, P, psize, H, dh) pool) — _rpa_pallas transposed the
// whole pool to (H, P, psize, dh) on every launch, which this kernel does
// not need; page_tables (S, npages) int32; lengths (S,) int32; out
// (S, H, dh).
//
// What bounds it on this card: bytes. Each visible K and V row is read
// once (dh * 4 bytes each) and used for 2 * dh flops, so at any length the
// decode step is memory-bound; at the serving shape (8 slots, 8 heads,
// dh = 64, tens to ~160 positions) the live rows are well under 10 MB,
// i.e. a few microseconds at 3.35 TB/s, and the launch itself is of the
// same order.
//
// Design: one warp per (slot, head), four per block, no shared state
// between warps. The block loads its own page ids (in place of the TPU's
// scalar prefetch): lane j scores position t0 + j of each 32-position
// chunk by a float4 dot of its K row with the query (kept in shared
// memory), warp shuffles give the chunk max and sum, and the P.V update
// walks the chunk with p_j broadcast by shuffle while each lane owns dh/32
// output columns, so V rows are read coalesced. int8 pages with per-page
// scales are a later slice: the wrapper refuses them.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;
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

// DCH = ceil(dh / 32): output columns per lane
template <int DCH>
__global__ void __launch_bounds__(kThreads)
rpa_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
               const float* __restrict__ vp,
               const int* __restrict__ page_tables,
               const int* __restrict__ lengths, float* __restrict__ out,
               int S, int H, int dh, int psize, int npages, long long sp,
               long long so, long long sh, float sm_scale) {
  extern __shared__ float qsm[];     // kWarps x dh
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;   // slot * H + head
  if (g >= S * H) return;                     // whole warp leaves together
  const int s = g / H;
  const int h = g - s * H;

  float* qw = qsm + warp * dh;
  for (int d = lane; d < dh; d += 32) qw[d] = q[(size_t)g * dh + d];
  __syncwarp();

  const int len = max(0, min(lengths[s], npages * psize));
  const int* pt = page_tables + (size_t)s * npages;
  const long long hoff = (long long)h * sh;

  float m = kMasked, l = 0.f, acc[DCH];
#pragma unroll
  for (int c = 0; c < DCH; ++c) acc[c] = 0.f;

  for (int t0 = 0; t0 < len; t0 += 32) {
    const int t = t0 + lane;
    float sc = kMasked;
    if (t < len) {
      const float* krow = kp + pt[t / psize] * sp + (t % psize) * so + hoff;
      float dot = 0.f;
      for (int d = 0; d < dh; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
        const float4 qq = *reinterpret_cast<const float4*>(qw + d);
        dot = fmaf(qq.x, kk.x, dot);
        dot = fmaf(qq.y, kk.y, dot);
        dot = fmaf(qq.z, kk.z, dot);
        dot = fmaf(qq.w, kk.w, dot);
      }
      sc = dot * sm_scale;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[c] *= alpha;
    const int nj = min(32, len - t0);   // the same for every lane
    for (int j = 0; j < nj; ++j) {
      const int tj = t0 + j;
      const float pj = __shfl_sync(kFull, p, j);
      const float* vrow = vp + pt[tj / psize] * sp + (tj % psize) * so + hoff;
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) acc[c] = fmaf(pj, vrow[d], acc[c]);
      }
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);   // length 0: l == 0, zeros out
#pragma unroll
  for (int c = 0; c < DCH; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) out[(size_t)g * dh + d] = acc[c] / denom;
  }
}

template <int DCH>
void launch(const float* q, const float* kp, const float* vp, const int* pt,
            const int* lengths, float* out, int S, int H, int dh, int psize,
            int npages, long long sp, long long so, long long sh,
            float sm_scale, cudaStream_t stream) {
  const int blocks = (S * H + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * dh;
  rpa_f32_kernel<DCH><<<blocks, kThreads, smem, stream>>>(
      q, kp, vp, pt, lengths, out, S, H, dh, psize, npages, sp, so, sh,
      sm_scale);
}

}  // namespace

// Strides are in elements. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int mxtt_rpa_f32(const float* q, const float* k_pages,
                            const float* v_pages, const int* page_tables,
                            const int* lengths, float* out, int S, int H,
                            int dh, int psize, int npages,
                            long long stride_page, long long stride_row,
                            long long stride_head, float sm_scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 32) {
    launch<1>(q, k_pages, v_pages, page_tables, lengths, out, S, H, dh, psize,
              npages, stride_page, stride_row, stride_head, sm_scale, st);
  } else if (dh <= 64) {
    launch<2>(q, k_pages, v_pages, page_tables, lengths, out, S, H, dh, psize,
              npages, stride_page, stride_row, stride_head, sm_scale, st);
  } else if (dh <= 96) {
    launch<3>(q, k_pages, v_pages, page_tables, lengths, out, S, H, dh, psize,
              npages, stride_page, stride_row, stride_head, sm_scale, st);
  } else if (dh <= 128) {
    launch<4>(q, k_pages, v_pages, page_tables, lengths, out, S, H, dh, psize,
              npages, stride_page, stride_row, stride_head, sm_scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
