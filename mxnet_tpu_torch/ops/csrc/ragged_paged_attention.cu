// Ragged paged attention for Hopper (sm_90a): the decode step's
// self-attention over the paged KV cache, in four forms of one template.
//
// Replaces, in mxnet_tpu/ops/pallas_kernels.py (launched by _rpa_pallas /
// _rpa_multi_pallas):
//   mxtt_rpa_f32        _rpa_kernel (:872), fp pages, one query per slot
//   mxtt_rpa_i8         _rpa_kernel (:872), quant=True: int8 pages
//   mxtt_rpa_multi_f32  _rpa_multi_kernel (:1014), W query rows per slot
//   mxtt_rpa_multi_i8   _rpa_multi_kernel (:1014), quant=True
// Same function: query row i of slot s attends over the first
// min(lengths[s] + i, npages * psize) positions of the slot's own pages,
// read through page_tables[s] (the 1-wide form is W = 1); online softmax
// in fp32, masked scores at the finite -1e30 the JAX package uses, a
// guarded divide (a row with no visible key writes zeros). Pages past a
// slot's longest row are never read, so mixed-length slots share one
// launch, and rows past a slot's real window (speculative verification's
// unused draft rows) read nothing out of bounds.
//
// int8 pages carry one fp32 scale per (page, head), read in place from
// the (P, H) scale array; each K / V element is dequantized right after
// the load as float(x) * scale, the element-wise form of the JAX
// package's _dequant_gathered. Device memory moves int8 bytes only.
//
// Layout: q and out (S, W, H, dh) contiguous (W = 1 is (S, H, dh));
// k_pages / v_pages (P, psize, H, dh) read in place through their page /
// row / head strides (the layer slice of the runtime's (L, P, psize, H,
// dh) pool); scales (P, H) contiguous; page_tables (S, npages) int32;
// lengths (S,) int32 (keys visible to row 0, its own position included).
// The TPU kernels' Mosaic layouts (the (H, P) bitcast-int32 scales, the
// 8-sublane query padding, the (8, 128) scratch) are not carried over.
//
// What bounds it on this card: bytes. Each visible K and V row is read
// once (dh * 4 bytes, or dh bytes int8) and used for 2 * W * dh flops, so
// at the serving shape (8 slots, 8 heads, dh = 64, W <= 4, a few dozen
// positions) the step is memory- and launch-bound: well under 10 MB, a
// few microseconds at 3.35 TB/s.
//
// Design: one warp per (slot, head), four per block, no shared state
// between warps. The block loads its own page ids (in place of the TPU's
// scalar prefetch). Lane j scores position t0 + j of each 32-position
// chunk against all W query rows (kept in shared memory) with one read of
// its K row, 4 elements at a time (a float4, or a char4 for int8); warp
// shuffles give each row's chunk max and sum. The P.V update walks the
// chunk with each row's p_j broadcast by shuffle while each lane owns
// dh/32 output columns of every row, so V rows are read coalesced and
// once for all W rows. A row skips a chunk in which it sees no key, so
// its running max and sum never see a chunk it does not own.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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

// four / one elements of a K or V row as fp32; int8 dequantized on load
__device__ __forceinline__ float4 load4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const int8_t* p, float s) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
                     static_cast<float>(c.z) * s, static_cast<float>(c.w) * s);
}
__device__ __forceinline__ float load1(const float* p, float) { return *p; }
__device__ __forceinline__ float load1(const int8_t* p, float s) {
  return static_cast<float>(*p) * s;
}

// T: page element type (float, or int8_t with a scale per (page, head));
// WMAX: most query rows a slot may have (W <= WMAX, rows >= W idle);
// DCH = ceil(dh / 32): output columns per lane
template <typename T, int WMAX, int DCH>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const float* __restrict__ q, const T* __restrict__ kp,
           const T* __restrict__ vp, const float* __restrict__ ks,
           const float* __restrict__ vs, const int* __restrict__ page_tables,
           const int* __restrict__ lengths, float* __restrict__ out, int S,
           int W, int H, int dh, int psize, int npages, long long sp,
           long long so, long long sh, float sm_scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  extern __shared__ float qsm[];     // kWarps x W x dh
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;   // slot * H + head
  if (g >= S * H) return;                     // whole warp leaves together
  const int s = g / H;
  const int h = g - s * H;

  // row i of (s, h) sits at ((s * W + i) * H + h) * dh in q and out
  float* qw = qsm + warp * W * dh;
  for (int i = 0; i < W; ++i)
    for (int d = lane; d < dh; d += 32)
      qw[i * dh + d] = q[((size_t)(s * W + i) * H + h) * dh + d];
  __syncwarp();

  const int cap = npages * psize;
  int len[WMAX];
#pragma unroll
  for (int i = 0; i < WMAX; ++i)
    len[i] = i < W ? max(0, min(lengths[s] + i, cap)) : 0;
  const int len_max = max(0, min(lengths[s] + W - 1, cap));
  const int* pt = page_tables + (size_t)s * npages;
  const long long hoff = (long long)h * sh;

  float m[WMAX], l[WMAX], acc[WMAX][DCH];
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < len_max; t0 += 32) {
    const int t = t0 + lane;
    float sc[WMAX];
#pragma unroll
    for (int i = 0; i < WMAX; ++i) sc[i] = kMasked;
    if (t < len_max) {
      const int page = pt[t / psize];
      const float kscale = kQuant ? ks[(size_t)page * H + h] : 1.f;
      const T* krow = kp + page * sp + (t % psize) * so + hoff;
      float dot[WMAX];
#pragma unroll
      for (int i = 0; i < WMAX; ++i) dot[i] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        const float4 kk = load4(krow + d, kscale);
#pragma unroll
        for (int i = 0; i < WMAX; ++i) {
          if (i < W) {
            const float4 qq = *reinterpret_cast<const float4*>(qw + i * dh + d);
            dot[i] = fmaf(qq.x, kk.x, dot[i]);
            dot[i] = fmaf(qq.y, kk.y, dot[i]);
            dot[i] = fmaf(qq.z, kk.z, dot[i]);
            dot[i] = fmaf(qq.w, kk.w, dot[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < WMAX; ++i)
        if (t < len[i]) sc[i] = dot[i] * sm_scale;
    }
    float p[WMAX];
#pragma unroll
    for (int i = 0; i < WMAX; ++i) {
      p[i] = 0.f;
      if (t0 < len[i]) {     // the same for every lane: row i sees a key here
        const float m_new = fmaxf(m[i], warp_max(sc[i]));
        const float alpha = expf(m[i] - m_new);
        p[i] = expf(sc[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(p[i]);
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] *= alpha;
        m[i] = m_new;
      }
    }
    const int nj = min(32, len_max - t0);   // the same for every lane
    for (int j = 0; j < nj; ++j) {
      const int tj = t0 + j;
      const int page = pt[tj / psize];
      const float vscale = kQuant ? vs[(size_t)page * H + h] : 1.f;
      const T* vrow = vp + page * sp + (tj % psize) * so + hoff;
      float pj[WMAX];
#pragma unroll
      for (int i = 0; i < WMAX; ++i) pj[i] = __shfl_sync(kFull, p[i], j);
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          const float v = load1(vrow + d, vscale);
#pragma unroll
          for (int i = 0; i < WMAX; ++i) acc[i][c] = fmaf(pj[i], v, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (i >= W) break;
    const float denom = fmaxf(l[i], 1e-30f);   // no visible key: zeros out
    float* orow = out + ((size_t)(s * W + i) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) orow[d] = acc[i][c] / denom;
    }
  }
}

template <typename T, int WMAX, int DCH>
void launch_one(const float* q, const T* kp, const T* vp, const float* ks,
                const float* vs, const int* pt, const int* lengths,
                float* out, int S, int W, int H, int dh, int psize,
                int npages, long long sp, long long so, long long sh,
                float sm_scale, cudaStream_t stream) {
  const int blocks = (S * H + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * W * dh;
  rpa_kernel<T, WMAX, DCH><<<blocks, kThreads, smem, stream>>>(
      q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh, psize, npages, sp,
      so, sh, sm_scale);
}

template <typename T, int WMAX>
int launch_w(const float* q, const T* kp, const T* vp, const float* ks,
             const float* vs, const int* pt, const int* lengths, float* out,
             int S, int W, int H, int dh, int psize, int npages, long long sp,
             long long so, long long sh, float sm_scale,
             cudaStream_t stream) {
  if (dh <= 32) {
    launch_one<T, WMAX, 1>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                           psize, npages, sp, so, sh, sm_scale, stream);
  } else if (dh <= 64) {
    launch_one<T, WMAX, 2>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                           psize, npages, sp, so, sh, sm_scale, stream);
  } else if (dh <= 128) {
    launch_one<T, WMAX, 4>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                           psize, npages, sp, so, sh, sm_scale, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* q, const T* kp, const T* vp, const float* ks,
           const float* vs, const int* pt, const int* lengths, float* out,
           int S, int W, int H, int dh, int psize, int npages, long long sp,
           long long so, long long sh, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == 1)
    return launch_w<T, 1>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                          psize, npages, sp, so, sh, sm_scale, st);
  if (W >= 2 && W <= 4)
    return launch_w<T, 4>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                          psize, npages, sp, so, sh, sm_scale, st);
  if (W >= 5 && W <= 8)
    return launch_w<T, 8>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,
                          psize, npages, sp, so, sh, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Strides are in elements. Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int mxtt_rpa_f32(const float* q, const float* k_pages,
                            const float* v_pages, const int* page_tables,
                            const int* lengths, float* out, int S, int H,
                            int dh, int psize, int npages,
                            long long stride_page, long long stride_row,
                            long long stride_head, float sm_scale,
                            void* stream) {
  return launch<float>(q, k_pages, v_pages, nullptr, nullptr, page_tables,
                       lengths, out, S, 1, H, dh, psize, npages, stride_page,
                       stride_row, stride_head, sm_scale, stream);
}

extern "C" int mxtt_rpa_i8(const float* q, const int8_t* k_pages,
                           const int8_t* v_pages, const float* k_scales,
                           const float* v_scales, const int* page_tables,
                           const int* lengths, float* out, int S, int H,
                           int dh, int psize, int npages,
                           long long stride_page, long long stride_row,
                           long long stride_head, float sm_scale,
                           void* stream) {
  return launch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, page_tables,
                        lengths, out, S, 1, H, dh, psize, npages, stride_page,
                        stride_row, stride_head, sm_scale, stream);
}

extern "C" int mxtt_rpa_multi_f32(const float* q, const float* k_pages,
                                  const float* v_pages,
                                  const int* page_tables, const int* lengths,
                                  float* out, int S, int W, int H, int dh,
                                  int psize, int npages,
                                  long long stride_page, long long stride_row,
                                  long long stride_head, float sm_scale,
                                  void* stream) {
  return launch<float>(q, k_pages, v_pages, nullptr, nullptr, page_tables,
                       lengths, out, S, W, H, dh, psize, npages, stride_page,
                       stride_row, stride_head, sm_scale, stream);
}

extern "C" int mxtt_rpa_multi_i8(const float* q, const int8_t* k_pages,
                                 const int8_t* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* page_tables, const int* lengths,
                                 float* out, int S, int W, int H, int dh,
                                 int psize, int npages, long long stride_page,
                                 long long stride_row, long long stride_head,
                                 float sm_scale, void* stream) {
  return launch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, page_tables,
                        lengths, out, S, W, H, dh, psize, npages, stride_page,
                        stride_row, stride_head, sm_scale, stream);
}
