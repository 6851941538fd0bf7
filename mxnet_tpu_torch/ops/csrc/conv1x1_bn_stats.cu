// 1x1 convolution as a matrix product with BatchNorm's batch statistics
// in its epilogue, for Hopper (sm_90a), on the tensor cores (wgmma) in
// both dtypes.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_conv1x1_stats_kernel
// (launched by conv1x1_bn_stats) and the probe kernel of
// tools/probe_fused_convbn.py (_kernel, via fused_conv1x1_stats), which
// compute the same function:
//   y = x @ w              (M, N) in x's dtype, from an fp32 accumulator
//   mean[n]   = sum_m y[m, n] / M      fp32, from the fp32 accumulator
//   meansq[n] = sum_m y[m, n]^2 / M    (before y is cast)
// x (M, K) and w (K, N) row-major, both fp32 or both bf16, any M, K, N.
// A 1x1 NHWC convolution is exactly this product with M = B*H*W, K = Cin,
// N = Cout.
//
// What bounds it on this card. Each of ResNet-50's four probe shapes
// (batch 128) is a product of 13.15 GFLOP (each, not the four together).
// With x and w read once and y written once (3.35 TB/s), against 989
// TFLOP/s bf16 and 165 TFLOP/s for fp32 in split TF32 (the dense TF32
// rate over its three passes):
//   (M, K, N)            bf16 bytes / bound      fp32 bytes / bound
//   (401408, 64, 256)    257 MB  0.077 ms bytes  514 MB  0.153 ms bytes
//   (100352, 512, 128)   129 MB  0.038 ms bytes  0.080 ms operations
//   (25088, 1024, 256)    65 MB  0.019 ms bytes  0.080 ms operations
//   (6272, 512, 2048)     33 MB  0.013 ms ops    0.080 ms operations
// In bf16 three shapes are bound by bytes (K*N / (K + N) is 51-205 FLOP a
// byte, the card's balance about 295), so the design's first job is to
// move x in once and y out once; in fp32 the split products bound all but
// the first. The statistics add three FLOP and no byte an output: they
// are taken from the accumulators in registers, which saves the pass that
// would re-read y. Measured on an H100 (chip_smoke.py phase 2b; PERF.md),
// what holds both forms back is the traffic from L2 into shared memory,
// not the tensor cores: w is re-read for every 128-row tile and x for
// every 128-column block, and fp32 also splits its operands in shared
// memory for every chunk.
//
// Design:
// * Tiles. A block is 8 warps as two warpgroups; each warpgroup owns 64
//   rows x BN columns of y (BN = 64 for N <= 64, else 128), so a block
//   covers 128 rows, x is read ceil(N / 128) times (the blocks of a row
//   tile run side by side and share it through L2) and w once a row
//   tile. The plan (kernels.py conv1x1_plan) is a function of (M, K, N,
//   dtype) only: grid (grid_m, ceil(N / BN)) with at most 132 blocks, one
//   an SM, and block (bx, by) walks the row tiles bx, bx + grid_m, ...
// * Copies. x and w tiles (K chunks of one 128-byte row) go through a
//   ring of shared-memory stages by cp.async, 16 bytes a copy, and the
//   ring runs on across row tiles, so the next tile's loads overlap this
//   tile's products and epilogue. Rows past M and columns past K or N are
//   zero-filled. When K or N is not a multiple of 16 bytes' worth of
//   elements (or a base is misaligned) the same kernel copies and stores
//   element by element (VEC = false); the wrapper never pads and never
//   takes the plain version.
// * bf16: wgmma.m64nBNk16 with both operands in shared memory in the 128-
//   byte swizzle (x K-major; w N-major, in 64-column blocks), 5 stages;
//   where K fits one chunk (K <= 64) each stage keeps its w tile and only
//   x streams.
// * fp32: split TF32 (tf32_mma.cuh's split and tile_add: lo*hi + hi*lo +
//   hi*hi, the small terms first) through wgmma.m64nBNk8.tf32, which takes
//   both operands K-major. Raw x and w tiles come through a 3-stage ring;
//   at each chunk the block splits every element once into hi / lo
//   planes in the swizzled layout, w transposed on the way.
// * Sums. A row tile's first K chunk goes straight into the accumulators;
//   each later chunk into zeroed ones, added by fp32 fma (tile_add): the
//   tensor cores' own accumulation over a long walk (K = 2048 is 128 bf16
//   or 256 tf32 k steps) drifts from float64 far more than fp32 adds do.
// * Statistics and y. After each row tile a lane adds its rows (rows past
//   M excluded) to its columns' sums, kept in registers over all of the
//   block's row tiles; at the end the 8 lanes of each column are reduced
//   by xor shuffles (4, 8, 16) and the block's 8 warps in warp order. y
//   leaves through a per-warp shared buffer, 8 rows at a time, in 16-byte
//   stores along its rows.
// * Across blocks: no atomics. Block (bx, by) writes its column sums to
//   row bx of a (grid_m, N) fp32 scratch, and a second kernel sums the
//   rows in a fixed order and scales by 1 / M, so the same inputs give
//   bit-identical mean and meansq from run to run.
// Offsets are 64-bit (M * N reaches 1.03e8 at batch 128). Each launch
// recomputes the plan's shared bytes and refuses a plan that disagrees.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mxtt;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFinalCols = 32;      // finalize: columns per block
constexpr int kFinalGroups = 8;     // finalize: row groups per block
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block
// Both forms: two warpgroups, each owning 64 rows x BN (64 or 128)
// columns of y, on wgmma (warp w takes rows 16 w .. 16 w + 15 of the
// block's tile); K chunks of one 128-byte swizzled row.
constexpr int kBM = 128;
static_assert(kBM == 64 * kWarps / 4, "a warpgroup each 64 rows");
// fp32 (split TF32): K chunk, ring stages of raw tiles, and the padding of
// a raw x row (BK + 4) and w row (BN + 8) in floats
constexpr int kF32BK = 32;
constexpr int kF32Stages = 3;
constexpr int kF32PadA = 4;
constexpr int kF32PadB = 8;
// bf16: K chunk, ring stages
constexpr int kBF16BK = 64;
constexpr int kBF16Stages = 5;

// the plans' shared bytes: 1024 to align the swizzled tiles; then fp32:
// S ring stages of raw x (BM rows of BK + 4) and w (BK rows of BN + 8)
// tiles, and the split planes (x hi, x lo, w^T hi, w^T lo: BM or BN rows
// of 128 bytes); bf16: S stages of swizzled x (BM rows of 128 bytes) and w
// (BN / 64 blocks of 64 rows of 128 bytes); both: the y staging (8 rows of
// BN + 8 a warp) and the warps' column sums (a row a 16-row warp)
__host__ __device__ constexpr int conv_smem(int bf, int bn) {
  const int raw = kBM * (kF32BK + kF32PadA) + kF32BK * (bn + kF32PadB);
  return 1024 +
         (bf ? kBF16Stages * (kBM + bn) * 128
             : 4 * kF32Stages * raw + 2 * (kBM + bn) * 128) +
         (bf ? 2 : 4) * kWarps * 8 * (bn + 8) + 2 * (kBM / 16) * bn * 4;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// copies into shared memory
// ---------------------------------------------------------------------------
// rows [0, R) x columns [c0, c0 + C) of a row-major (rows, cols) matrix
// `src` (its row r0 at the tile's row 0) into shared memory at `dst`;
// elements past `rows` or `cols` are zeros. Element (r, c) goes to
// element off(r, c) of `dst`. VEC: 16-byte cp.async copies (cols and c0
// multiples of 16 bytes' worth, base aligned); else element by element,
// loaded and stored by the thread.
template <typename T, int R, int C, bool VEC, typename Off>
__device__ __forceinline__ void load_tile(T* dst, Off off, const T* src,
                                          long long r0, long long rows,
                                          int c0, int cols, int tid) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int P = C / E;
#pragma unroll
    for (int i = 0; i < (R * P + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (R * P % kThreads != 0 && idx >= R * P) break;
      const int r = idx / P, c = (idx % P) * E;
      const bool ok = r0 + r < rows && c0 + c < cols;
      const T* s = ok ? src + (r0 + r) * cols + c0 + c : src;
      cp_async16(reinterpret_cast<float*>(dst + off(r, c)),
                 reinterpret_cast<const float*>(s), ok);
    }
  } else {
    for (int idx = tid; idx < R * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      const bool ok = r0 + r < rows && c0 + c < cols;
      dst[off(r, c)] = ok ? src[(r0 + r) * cols + c0 + c] : T(0.f);
    }
  }
}

// rows of `pitch` elements
struct Pitched {
  int pitch;
  __device__ int operator()(int r, int c) const { return r * pitch + c; }
};
// 128-byte swizzled rows of W = 128 / sizeof(T) elements, columns past W
// in further blocks of ROWS such rows: the 16-byte piece q of row r sits
// at piece q ^ (r % 8)
template <typename T, int ROWS>
struct Swizzled {
  static constexpr int W = 128 / sizeof(T), E = 16 / sizeof(T);
  __device__ int operator()(int r, int c) const {
    return (c / W) * ROWS * W + r * W + ((((c % W) / E) ^ (r & 7)) * E) +
           c % E;
  }
};

// split a raw K chunk into the planes the products read, each element
// once a block: x (BM rows of `pa` floats) into xh / xl, and w (BK rows of
// `pb`) transposed into wth / wtl (BN rows), all K-major and swizzled.
// x: a thread takes 16-byte pieces; w: lane = k, a warp 4 columns a step
template <int BN>
__device__ __forceinline__ void split_chunk(const float* x, int pa,
                                            const float* w, int pb,
                                            float* xh, float* xl, float* wth,
                                            float* wtl, int tid) {
  static_assert(kF32BK == 32, "a lane a k");
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 3, k = (idx & 7) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + r * pa + k);
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    const int o = Swizzled<float, kBM>{}(r, k);
    *reinterpret_cast<uint4*>(xh + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(xl + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < BN / 4 / kWarps; ++i) {
    const int n = 4 * (warp + i * kWarps);
    const float4 v = *reinterpret_cast<const float4*>(w + lane * pb + n);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t h, l;
      split(e[c], h, l);
      const int o = Swizzled<float, BN>{}(n + c, lane);
      wth[o] = __uint_as_float(h);
      wtl[o] = __uint_as_float(l);
    }
  }
}

// d = x * w over one K chunk in split TF32 (lo*hi + hi*lo + hi*hi, the
// small terms first, 3 wgmma a k step of 8): a warpgroup's 64 x BN tile
// from its 64 rows of the x planes and the w^T planes
template <int BN>
__device__ __forceinline__ void chunk_f32(float (*d)[4], const float* xh,
                                          const float* xl, const float* wth,
                                          const float* wtl) {
  wg_fence();
  pin<BN / 8>(d);
#pragma unroll
  for (int kk = 0; kk < kF32BK; kk += 8) {
    const uint64_t ah = sw128_desc(xh + kk, 16, 1024);
    const uint64_t al = sw128_desc(xl + kk, 16, 1024);
    const uint64_t bh = sw128_desc(wth + kk, 16, 1024);
    const uint64_t bl = sw128_desc(wtl + kk, 16, 1024);
    if constexpr (BN == 128) {
      wgmma_tf32_n128(d, al, bh, kk);
      wgmma_tf32_n128(d, ah, bl, 1);
      wgmma_tf32_n128(d, ah, bh, 1);
    } else {
      wgmma_tf32_n64(d, al, bh, kk);
      wgmma_tf32_n64(d, ah, bl, 1);
      wgmma_tf32_n64(d, ah, bh, 1);
    }
  }
  wg_commit_wait();
  pin<BN / 8>(d);
}

// ---------------------------------------------------------------------------
// the epilogue of a warp's 16 rows of a row tile: its accumulators are NJ
// 8-column tiles in mma.sync's C layout, rows from r0 and columns from c0
// of y
// ---------------------------------------------------------------------------
// statistics: a lane adds its rows (those past M excluded) to its
// columns' running sums, kept in registers over the block's row tiles
template <int NJ>
__device__ __forceinline__ void lane_stats(float (*acc)[4], long long M,
                                           long long r0, float (*s)[2],
                                           float (*q)[2], int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h + g >= M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = acc[j][2 * h + c];
        s[j][c] += v;
        q[j][c] = fmaf(v, v, q[j][c]);
      }
    }
  }
}

// at the end: the 8 lanes of each column by xor shuffles (4, 8, 16) into
// ws / wq (the warp's row of the block's column sums, at its first column)
template <int NJ>
__device__ __forceinline__ void warp_stats(float (*s)[2], float (*q)[2],
                                           float* ws, float* wq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float a = s[j][c], b = q[j][c];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (g == 0) {
        ws[8 * j + 2 * t + c] = a;
        wq[8 * j + 2 * t + c] = b;
      }
    }
  }
}

// y: 8 rows at a time through the warp's buffer `ob` (rows of OP
// elements), 16-byte stores along the rows (element by element unless VEC)
template <typename T, bool VEC, int NJ, int OP>
__device__ __forceinline__ void warp_store(float (*acc)[4], T* y, long long M,
                                           int N, long long r0, int c0, T* ob,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int E = 16 / sizeof(T);
  constexpr int P = 8 * NJ / E;   // pieces a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store_pair(ob + g * OP + 8 * j + 2 * t, acc[j][2 * h],
                 acc[j][2 * h + 1]);
    __syncwarp();
#pragma unroll
    for (int p = lane; p < 8 * P; p += 32) {
      const int r = p / P, c = (p % P) * E;
      const long long gm = r0 + 8 * h + r;
      const int gn = c0 + c;
      if (gm >= M) continue;
      if constexpr (VEC) {
        if (gn < N)
          *reinterpret_cast<uint4*>(y + gm * N + gn) =
              *reinterpret_cast<const uint4*>(ob + r * OP + c);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (gn + e < N) y[gm * N + gn + e] = ob[r * OP + c + e];
      }
    }
    __syncwarp();
  }
}

// the block's column sums: the WR warps of each column in order, into row
// bx of the (grid_m, N) scratch (thread `tid` takes column n0 + tid)
template <int WR, int BN>
__device__ __forceinline__ void block_sums(const float* ws, const float* wq,
                                           float* part_s, float* part_q,
                                           int n0, int N, int tid) {
  if (tid < BN && n0 + tid < N) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      s += ws[r * BN + tid];
      q += wq[r * BN + tid];
    }
    const long long o = static_cast<long long>(blockIdx.x) * N + n0 + tid;
    part_s[o] = s;
    part_q[o] = q;
  }
}

// ---------------------------------------------------------------------------
// fp32: split TF32 on wgmma
// ---------------------------------------------------------------------------
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, float* __restrict__ part_s,
                   float* __restrict__ part_q, long long M, int K, int N,
                   int tiles_m) {
  constexpr int NJ = BN / 8;
  constexpr int BM = kBM, BK = kF32BK, S = kF32Stages;
  constexpr int PA = BK + kF32PadA, PB = BN + kF32PadB;
  constexpr int STAGE = BM * PA + BK * PB;   // floats
  constexpr int OP = BN + 8;                 // y staging row, floats

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the planes to it
  float* xh = reinterpret_cast<float*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024));
  float* xl = xh + BM * 32;
  float* wth = xl + BM * 32;
  float* wtl = wth + BN * 32;
  float* ring = wtl + BN * 32;
  float* outbuf = ring + S * STAGE;
  float* wsum = outbuf + kWarps * 8 * OP;
  float* wsq = wsum + (BM / 16) * BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int ntiles = (tiles_m - 1 - static_cast<int>(blockIdx.x)) /
                         static_cast<int>(gridDim.x) + 1;
  const int total = ntiles * nk;

  auto load_chunk = [&](int it) {
    float* st = ring + (it % S) * STAGE;
    const int tm = blockIdx.x + (it / nk) * gridDim.x;
    const int k0 = (it % nk) * BK;
    load_tile<float, BM, BK, VEC>(st, Pitched{PA}, x,
                                  static_cast<long long>(tm) * BM, M, k0, K,
                                  tid);
    load_tile<float, BK, BN, VEC>(st + BM * PA, Pitched{PB}, w, k0, K, n0,
                                  N, tid);
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_commit();
  }

  float acc[NJ][4];
  float cs[NJ][2] = {}, cq[NJ][2] = {};   // this lane's columns' sums
  const int xo = (warp >> 2) * 64 * 32;   // its warpgroup's x rows
  for (int it = 0; it < total; ++it) {
    cp_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < total) load_chunk(it + S - 1);
    cp_commit();
    const float* st = ring + (it % S) * STAGE;
    split_chunk<BN>(st, PA, st + BM * PA, PB, xh, xl, wth, wtl, tid);
    fence_async_smem();
    __syncthreads();

    // a row tile's first chunk straight into the accumulators, each later
    // one into zeroed ones added by fp32 fma
    const int kc = it % nk;
    if (kc == 0) {
      chunk_f32<BN>(acc, xh + xo, xl + xo, wth, wtl);
    } else {
      float part[NJ][4];
      chunk_f32<BN>(part, xh + xo, xl + xo, wth, wtl);
      tile_add<NJ>(acc, part, 1.f, 1.f);
    }
    if (kc != nk - 1) continue;

    // epilogue of row tile tm
    const int tm = blockIdx.x + (it / nk) * gridDim.x;
    const long long r0 = static_cast<long long>(tm) * BM + 16 * warp;
    lane_stats<NJ>(acc, M, r0, cs, cq, lane);
    warp_store<float, VEC, NJ, OP>(acc, y, M, N, r0, n0,
                                   outbuf + warp * 8 * OP, lane);
  }
  cp_wait<0>();
  warp_stats<NJ>(cs, cq, wsum + warp * BN, wsq + warp * BN, lane);
  __syncthreads();
  block_sums<BM / 16, BN>(wsum, wsq, part_s, part_q, n0, N, tid);
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------
// d = a * b over one K chunk (4 k steps of 16): a warpgroup's 64 x WGN
// tile from its 64 swizzled x rows `a` and w blocks `b`
template <int WGN>
__device__ __forceinline__ void chunk_bf16(float (*d)[4], const bf16* a,
                                           const bf16* b) {
  wg_fence();
  pin<WGN / 8>(d);
#pragma unroll
  for (int kk = 0; kk < kBF16BK / 16; ++kk) {
    const uint64_t da = sw128_desc(a + 16 * kk, 16, 1024);
    const uint64_t db = sw128_desc(b + 16 * kk * 64, kBF16BK * 128, 1024);
    if constexpr (WGN == 128)
      wgmma_n128(d, da, db, kk);
    else
      wgmma_n64(d, da, db, kk);
  }
  wg_commit_wait();
  pin<WGN / 8>(d);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, float* __restrict__ part_s,
                    float* __restrict__ part_q, long long M, int K, int N,
                    int tiles_m) {
  constexpr int NJ = BN / 8;
  constexpr int BM = kBM, BK = kBF16BK, S = kBF16Stages;
  constexpr int A_ELEMS = BM * 64, STAGE = (BM + BN) * 64;   // elements
  constexpr int OP = BN + 8;                 // y staging row, elements

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  bf16* ring = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024));
  bf16* outbuf = ring + S * STAGE;
  float* wsum = reinterpret_cast<float*>(outbuf + kWarps * 8 * OP);
  float* wsq = wsum + (BM / 16) * BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int ntiles = (tiles_m - 1 - static_cast<int>(blockIdx.x)) /
                         static_cast<int>(gridDim.x) + 1;
  const int total = ntiles * nk;
  // K in one chunk: each stage keeps the w tile it got first
  const bool w_fixed = nk == 1;

  auto load_chunk = [&](int it) {
    bf16* st = ring + (it % S) * STAGE;
    const int tm = blockIdx.x + (it / nk) * gridDim.x;
    const int k0 = (it % nk) * BK;
    load_tile<bf16, BM, BK, VEC>(st, Swizzled<bf16, BM>{}, x,
                                 static_cast<long long>(tm) * BM, M, k0, K,
                                 tid);
    if (!w_fixed || it < S)
      load_tile<bf16, BK, BN, VEC>(st + A_ELEMS, Swizzled<bf16, BK>{}, w, k0,
                                   K, n0, N, tid);
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_commit();
  }

  float acc[NJ][4];
  float cs[NJ][2] = {}, cq[NJ][2] = {};   // this lane's columns' sums
  for (int it = 0; it < total; ++it) {
    cp_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    if (it + S - 1 < total) load_chunk(it + S - 1);
    cp_commit();
    const bf16* st = ring + (it % S) * STAGE;
    const int kc = it % nk;

    // a row tile's first chunk straight into the accumulators, each later
    // one into zeroed ones (scale_d = 0 at its first k step) added by fp32
    // fma
    const bf16* a = st + (warp >> 2) * 64 * 64;
    const bf16* b = st + A_ELEMS;
    if (kc == 0) {
      chunk_bf16<BN>(acc, a, b);
    } else {
      float part[NJ][4];
      chunk_bf16<BN>(part, a, b);
      tile_add<NJ>(acc, part, 1.f, 1.f);
    }
    if (kc != nk - 1) continue;

    // epilogue of row tile tm
    const int tm = blockIdx.x + (it / nk) * gridDim.x;
    const long long r0 = static_cast<long long>(tm) * BM + 16 * warp;
    lane_stats<NJ>(acc, M, r0, cs, cq, lane);
    warp_store<bf16, VEC, NJ, OP>(acc, y, M, N, r0, n0,
                                  outbuf + warp * 8 * OP, lane);
  }
  cp_wait<0>();
  warp_stats<NJ>(cs, cq, wsum + warp * BN, wsq + warp * BN, lane);
  __syncthreads();
  block_sums<BM / 16, BN>(wsum, wsq, part_s, part_q, n0, N, tid);
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

template <bool BF, int BN, bool VEC>
int launch_bn(const void* x, const void* w, void* y, float* part_s,
              float* part_q, long long M, int K, int N, int grid_m,
              long long smem, cudaStream_t st) {
  constexpr int BM = kBM;
  constexpr int need = conv_smem(BF, BN);
  static_assert(need <= kSmemLimit, "plan exceeds shared memory");
  const long long tiles_m = (M + BM - 1) / BM;
  if (smem != need || grid_m < 1 || grid_m > tiles_m ||
      tiles_m > 0x7fffffffLL || (N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  const dim3 grid(grid_m, (N + BN - 1) / BN);
  cudaError_t err;
  if constexpr (BF) {
    err = prepare(conv1x1_bf16_kernel<BN, VEC>, need, ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv1x1_bf16_kernel<BN, VEC><<<grid, kThreads, need, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), part_s, part_q, M, K, N,
        static_cast<int>(tiles_m));
  } else {
    err = prepare(conv1x1_f32_kernel<BN, VEC>, need, ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv1x1_f32_kernel<BN, VEC><<<grid, kThreads, need, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), part_s, part_q, M, K, N,
        static_cast<int>(tiles_m));
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool BF>
int launch(const void* x, const void* w, void* y, float* part_s,
           float* part_q, float* mean, float* meansq, long long M, int K,
           int N, int bn, int grid_m, int vec, long long smem,
           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
#define MXTT_C1(B)                                                          \
  (vec ? launch_bn<BF, B, true>(x, w, y, part_s, part_q, M, K, N, grid_m,  \
                                smem, st)                                   \
       : launch_bn<BF, B, false>(x, w, y, part_s, part_q, M, K, N, grid_m, \
                                 smem, st))
  if (bn == 64) {
    rc = MXTT_C1(64);
  } else if (bn == 128) {
    rc = MXTT_C1(128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXTT_C1
  if (rc != 0) return rc;
  conv1x1_stats_finalize<<<(N + kFinalCols - 1) / kFinalCols,
                           kFinalCols * kFinalGroups, 0, st>>>(
      part_s, part_q, mean, meansq, grid_m, N,
      static_cast<float>(1.0 / static_cast<double>(M)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x @ w with the per-column mean and mean square of y, on the plan of
// kernels.py conv1x1_plan: bn columns a block (64, 128 or 256), grid_m
// row-tile groups (1 <= grid_m <= the row tiles), vec (16-byte
// copies and stores: K and N multiples of 16 bytes' worth, bases
// aligned), smem the plan's shared bytes. part_s and part_q are
// (grid_m, N) fp32 scratch that the caller allocates. Returns
// cudaGetLastError() after the two launches (0 = launched), or
// cudaErrorInvalidValue without launching for a plan this file would not
// have made.
extern "C" int mxtt_conv1x1_stats_f32(const void* x, const void* w, void* y,
                                      float* part_s, float* part_q,
                                      float* mean, float* meansq,
                                      long long M, int K, int N, int bn,
                                      int grid_m, int vec, long long smem,
                                      void* stream) {
  return launch<false>(x, w, y, part_s, part_q, mean, meansq, M, K, N, bn,
                       grid_m, vec, smem, stream);
}

extern "C" int mxtt_conv1x1_stats_bf16(const void* x, const void* w, void* y,
                                       float* part_s, float* part_q,
                                       float* mean, float* meansq,
                                       long long M, int K, int N, int bn,
                                       int grid_m, int vec, long long smem,
                                       void* stream) {
  return launch<true>(x, w, y, part_s, part_q, mean, meansq, M, K, N, bn,
                      grid_m, vec, smem, stream);
}
