// Flash attention for wide heads (128 < D <= 512), forward and backward,
// for Hopper (sm_90a), in fp32, bf16 and fp16 from one template.
//
// Replaces, for head widths the narrow kernels (flash_fwd.cu,
// flash_bwd.cu: D <= 128, one or two 128-byte swizzle atoms) do not take:
//   * mxnet_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (:219): out and
//     the row log-sum-exp, with an optional causal mask (kj <= qi in
//     absolute indices, the top-left mask, for any Sq and Sk) and an
//     optional per-batch key length (kj < kv_len[b]);
//   * _flash_bwd_dkv_kernel (:417): dK and dV;
//   * _flash_bwd_dq_kernel (:484): dQ.
// The Pallas kernels take any head width (`_use_pallas` gates on the
// sequence length only), so these keep the port's flash_attention whole.
//
// Semantics kept from the JAX kernels: fp32 softmax and accumulation for
// every input dtype; a row with no visible key writes zeros (out) and
// gets zero gradients (p is masked itself, not left to underflow); lse =
// m + log(max(l, 1e-30)); the backward takes delta = rowsum(dO * O) in
// fp32 from its caller (kernels.py computes it as for the narrow
// kernels). In bf16 / fp16 the rounding points are the plain versions'
// (kernels.py:_flash_plain, _flash_bwd_plain): the forward rounds p =
// exp(s - m) to the input type before P V, l sums the unrounded p and
// out is rounded once; dV takes r(p), dK takes r(r(p) (dP - delta)
// scale), dQ takes r(p (dP - delta) scale), each gradient rounded once.
//
// Design (a simple kernel that is right, not a fast one):
// * A warp owns one row: a query row in the forward and the dQ kernel, a
//   key row in the dK/dV kernel. Each lane holds the row's columns lane,
//   lane + 32, ... (NJ = 8 of them up to D = 256, 16 up to 512) and its
//   accumulators, in fp32.
// * A block is kWarps rows of one (b, h). The other side's rows (K and V
//   for a query row, Q and dO for a key row) stream through shared memory
//   in tiles of kTile rows, converted to fp32 on load; each dot product
//   is the lanes' partial sums reduced by five shuffles.
// * The forward walks the keys twice: the first finds the row's max m,
//   the second sums l = sum exp(s - m) (compensated, since lse = m +
//   log(l) feeds the backward) and exp(s - m) V, so p is rounded (16-bit
//   forms) relative to the same max as in the plain version.
// * Keys at or past min(Sk, kv_len[b]) and, when causal, past the block's
//   last query row are never loaded; the dK/dV kernel starts its query
//   walk at the block's first key when causal.
//
// Layout: q (B, H, Sq, D), k / v (B, H, Sk, D), out / dq (like q), dk /
// dv (like k), all contiguous in one type; lse / delta (B*H, Sq) fp32;
// kv_len (B,) int32 or NULL. Each entry returns cudaGetLastError() after
// its launch (0 = launched), or cudaErrorInvalidValue for D outside
// (0, 512].

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float kMasked = -1e30f;  // the JAX package's mask
constexpr int kWarps = 8;          // rows a block
constexpr int kTile = 16;          // rows of a shared-memory tile
constexpr int kMaxD = 512;

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load<__half>(const __half* p) {
  return __half2float(*p);
}

template <typename T>
__device__ __forceinline__ T to_type(float x);
template <>
__device__ __forceinline__ float to_type<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half to_type<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back (the identity in fp32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  const T t = to_type<T>(x);
  return load<T>(&t);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + kTile) of the (rows, D) matrix at src into dst (fp32,
// kTile x D), zeros past `rows`
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int D) {
  const int n = kTile * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i / D;
    dst[i] = r < rows ? load<T>(src + (size_t)r0 * D + i) : 0.f;
  }
}

// the warp's dot of its row (registers, NJ columns a lane) with row r of
// a shared tile
template <int NJ>
__device__ __forceinline__ float dot_row(const float (&x)[NJ],
                                         const float* tile, int r, int D,
                                         int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) s = fmaf(x[j], tile[r * D + c], s);
  }
  return warp_sum(s);
}

template <typename T, int NJ>
__device__ __forceinline__ void load_row(float (&x)[NJ], const T* row,
                                         bool ok, int D, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    x[j] = ok && c < D ? load<T>(row + c) : 0.f;
  }
}

// keys a block of query rows [q0, q0 + kWarps) reads: below min(Sk,
// kv_len[b]) and, when causal, at most its last row
__device__ __forceinline__ int key_end(const int* kv_len, int b, int Sq,
                                       int Sk, int causal, int q0) {
  int kend = Sk;
  if (kv_len != nullptr) kend = min(kend, max(kv_len[b], 0));
  if (causal) kend = min(kend, min(Sq, q0 + kWarps));
  return kend;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(32 * kWarps)
    wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ lse, int H,
                    int Sq, int Sk, int D, int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kTile * D;
  const int bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kWarps, qi = q0 + warp;
  const bool row_ok = qi < Sq;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int kend = key_end(kv_len, b, Sq, Sk, causal, q0);

  float qr[NJ];
  load_row<T, NJ>(qr, q + ((size_t)bh * Sq + qi) * D, row_ok, D, lane);

  // walk 1: the row's max
  float m = kMasked;
  for (int t0 = 0; t0 < kend; t0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, kb, t0, kend, D);
    __syncthreads();
    if (!row_ok) continue;
    const int n = min(kTile, kend - t0);
    for (int r = 0; r < n; ++r) {
      if (causal && t0 + r > qi) break;
      m = fmaxf(m, dot_row<NJ>(qr, ks, r, D, lane) * sm_scale);
    }
  }

  // walk 2: p = exp(s - m) with the final max; l sums the unrounded p
  // (compensated: it feeds lse, which the backward reads), P V the
  // rounded one
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float l = 0.f, lc = 0.f;
  for (int t0 = 0; t0 < kend; t0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, kb, t0, kend, D);
    load_tile<T>(vs, vb, t0, kend, D);
    __syncthreads();
    if (!row_ok) continue;
    const int n = min(kTile, kend - t0);
    for (int r = 0; r < n; ++r) {
      if (causal && t0 + r > qi) break;
      const float s = dot_row<NJ>(qr, ks, r, D, lane) * sm_scale;
      const float e = expf(s - m);
      const float y = e - lc;
      const float t = l + y;
      lc = (t - l) - y;
      l = t;
      const float p = rnd<T>(e);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) acc[j] = fmaf(p, vs[r * D + c], acc[j]);
      }
    }
  }
  if (!row_ok) return;
  // a row with every key masked has l == 0: it writes zeros
  const float den = fmaxf(l - lc, 1e-30f);
  T* orow = out + ((size_t)bh * Sq + qi) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) orow[c] = to_type<T>(acc[j] / den);
  }
  if (lane == 0) lse[(size_t)bh * Sq + qi] = m + logf(den);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(32 * kWarps)
    wide_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_len, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Sq, int Sk, int D,
                        int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = smem + kTile * D;
  float* ls = smem + 2 * kTile * D;
  float* ds_ = ls + kTile;
  const int bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kWarps, kj = k0 + warp;
  int kv = Sk;
  if (kv_len != nullptr) kv = min(kv, max(kv_len[b], 0));
  const bool live = kj < kv;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* db = dout + (size_t)bh * Sq * D;

  float kr[NJ], vr[NJ], gk[NJ], gv[NJ];
  load_row<T, NJ>(kr, k + ((size_t)bh * Sk + kj) * D, live, D, lane);
  load_row<T, NJ>(vr, v + ((size_t)bh * Sk + kj) * D, live, D, lane);
#pragma unroll
  for (int j = 0; j < NJ; ++j) gk[j] = gv[j] = 0.f;

  // no live key in the block: its rows are zeros; when causal, queries
  // before the block's first key see none of its keys
  const int qstart = k0 >= kv ? Sq : (causal ? min(k0, Sq) : 0);
  for (int t0 = qstart; t0 < Sq; t0 += kTile) {
    __syncthreads();
    load_tile<T>(qs, qb, t0, Sq, D);
    load_tile<T>(dos, db, t0, Sq, D);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = t0 + i < Sq;
      ls[i] = in ? lse[(size_t)bh * Sq + t0 + i] : 0.f;
      ds_[i] = in ? delta[(size_t)bh * Sq + t0 + i] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTile, Sq - t0);
    for (int r = 0; r < n; ++r) {
      if (causal && kj > t0 + r) continue;
      const float s = dot_row<NJ>(kr, qs, r, D, lane) * sm_scale;
      const float p = rnd<T>(expf(s - ls[r]));
      const float dp = dot_row<NJ>(vr, dos, r, D, lane) - ds_[r];
      const float dsr = rnd<T>(p * dp * sm_scale);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          gv[j] = fmaf(p, dos[r * D + c], gv[j]);
          gk[j] = fmaf(dsr, qs[r * D + c], gk[j]);
        }
      }
    }
  }
  if (kj >= Sk) return;
  T* dkr = dk + ((size_t)bh * Sk + kj) * D;
  T* dvr = dv + ((size_t)bh * Sk + kj) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      dkr[c] = to_type<T>(gk[j]);
      dvr[c] = to_type<T>(gv[j]);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(32 * kWarps)
    wide_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ kv_len, T* __restrict__ dq,
                       int H, int Sq, int Sk, int D, int causal,
                       float sm_scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kTile * D;
  const int bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kWarps, qi = q0 + warp;
  const bool row_ok = qi < Sq;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int kend = key_end(kv_len, b, Sq, Sk, causal, q0);

  float qr[NJ], dor[NJ], g[NJ];
  load_row<T, NJ>(qr, q + ((size_t)bh * Sq + qi) * D, row_ok, D, lane);
  load_row<T, NJ>(dor, dout + ((size_t)bh * Sq + qi) * D, row_ok, D, lane);
#pragma unroll
  for (int j = 0; j < NJ; ++j) g[j] = 0.f;
  const float lr = row_ok ? lse[(size_t)bh * Sq + qi] : 0.f;
  const float dr = row_ok ? delta[(size_t)bh * Sq + qi] : 0.f;

  for (int t0 = 0; t0 < kend; t0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, kb, t0, kend, D);
    load_tile<T>(vs, vb, t0, kend, D);
    __syncthreads();
    if (!row_ok) continue;
    const int n = min(kTile, kend - t0);
    for (int r = 0; r < n; ++r) {
      if (causal && t0 + r > qi) break;
      const float s = dot_row<NJ>(qr, ks, r, D, lane) * sm_scale;
      const float p = expf(s - lr);
      const float dp = dot_row<NJ>(dor, vs, r, D, lane) - dr;
      const float dsr = rnd<T>(p * dp * sm_scale);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) g[j] = fmaf(dsr, ks[r * D + c], g[j]);
      }
    }
  }
  if (!row_ok) return;
  T* row = dq + ((size_t)bh * Sq + qi) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) row[c] = to_type<T>(g[j]);
  }
}

// the dynamic shared bytes a kernel takes above the default 48 KiB are
// granted once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<bool>& ready) {
  if (ready.load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (2 * kTile * kMaxD + 2 * kTile) * (int)sizeof(float));
  if (err == cudaSuccess) ready.store(true, std::memory_order_release);
  return err;
}

template <typename T, int NJ>
int launch_fwd(const void* q, const void* k, const void* v,
               const int* kv_len, void* out, float* lse, int B, int H,
               int Sq, int Sk, int D, int causal, float sm_scale,
               cudaStream_t st) {
  static std::atomic<bool> ready{false};
  cudaError_t err = allow_smem(wide_fwd_kernel<T, NJ>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kWarps - 1) / kWarps, B * H);
  const size_t smem = sizeof(float) * 2 * kTile * D;
  wide_fwd_kernel<T, NJ><<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), lse, H, Sq,
      Sk, D, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* kv_len,
               void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               int causal, float sm_scale, cudaStream_t st) {
  static std::atomic<bool> ready{false};
  cudaError_t err = allow_smem(wide_bwd_dkv_kernel<T, NJ>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kWarps - 1) / kWarps, B * H);
  const size_t smem = sizeof(float) * (2 * kTile * D + 2 * kTile);
  wide_bwd_dkv_kernel<T, NJ><<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_len, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* kv_len,
              void* dq, int B, int H, int Sq, int Sk, int D, int causal,
              float sm_scale, cudaStream_t st) {
  static std::atomic<bool> ready{false};
  cudaError_t err = allow_smem(wide_bwd_dq_kernel<T, NJ>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kWarps - 1) / kWarps, B * H);
  const size_t smem = sizeof(float) * 2 * kTile * D;
  wide_bwd_dq_kernel<T, NJ><<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_len, static_cast<T*>(dq), H, Sq, Sk, D, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// NJ columns a lane: 4 to D = 128, 8 to 256, 16 to 512
#define MXTT_WIDE(LAUNCH, T, ...)                                   \
  (D <= 0 || D > kMaxD)                                             \
      ? static_cast<int>(cudaErrorInvalidValue)                     \
      : D <= 128 ? LAUNCH<T, 4>(__VA_ARGS__)                        \
                 : D <= 256 ? LAUNCH<T, 8>(__VA_ARGS__)             \
                            : LAUNCH<T, 16>(__VA_ARGS__)

template <typename T>
int wide_fwd(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, float* lse, int B, int H, int Sq, int Sk, int D,
             int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return MXTT_WIDE(launch_fwd, T, q, k, v, kv_len, out, lse, B, H, Sq, Sk,
                   D, causal, sm_scale, st);
}

template <typename T>
int wide_dkv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const int* kv_len,
             void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
             int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return MXTT_WIDE(launch_dkv, T, q, k, v, dout, lse, delta, kv_len, dk, dv,
                   B, H, Sq, Sk, D, causal, sm_scale, st);
}

template <typename T>
int wide_dq(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const int* kv_len,
            void* dq, int B, int H, int Sq, int Sk, int D, int causal,
            float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return MXTT_WIDE(launch_dq, T, q, k, v, dout, lse, delta, kv_len, dq, B,
                   H, Sq, Sk, D, causal, sm_scale, st);
}

#undef MXTT_WIDE

}  // namespace

#define MXTT_WIDE_ENTRIES(SFX, T)                                            \
  extern "C" int mxtt_flash_wide_fwd##SFX(                                   \
      const void* q, const void* k, const void* v, const int* kv_len,       \
      void* out, float* lse, int B, int H, int Sq, int Sk, int D,           \
      int causal, float sm_scale, void* stream) {                            \
    return wide_fwd<T>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal,  \
                       sm_scale, stream);                                    \
  }                                                                          \
  extern "C" int mxtt_flash_wide_bwd_dkv##SFX(                               \
      const void* q, const void* k, const void* v, const void* dout,        \
      const float* lse, const float* delta, const int* kv_len, void* dk,    \
      void* dv, int B, int H, int Sq, int Sk, int D, int causal,            \
      float sm_scale, void* stream) {                                        \
    return wide_dkv<T>(q, k, v, dout, lse, delta, kv_len, dk, dv, B, H, Sq, \
                       Sk, D, causal, sm_scale, stream);                     \
  }                                                                          \
  extern "C" int mxtt_flash_wide_bwd_dq##SFX(                                \
      const void* q, const void* k, const void* v, const void* dout,        \
      const float* lse, const float* delta, const int* kv_len, void* dq,    \
      int B, int H, int Sq, int Sk, int D, int causal, float sm_scale,      \
      void* stream) {                                                        \
    return wide_dq<T>(q, k, v, dout, lse, delta, kv_len, dq, B, H, Sq, Sk,  \
                      D, causal, sm_scale, stream);                          \
  }

MXTT_WIDE_ENTRIES(_f32, float)
MXTT_WIDE_ENTRIES(_bf16, __nv_bfloat16)
MXTT_WIDE_ENTRIES(_f16, __half)

#undef MXTT_WIDE_ENTRIES
