// Ragged paged attention for Hopper (sm_90a): the decode step's
// self-attention over the paged KV cache.
//
// Replaces, in mxnet_tpu/ops/pallas_kernels.py (launched by _rpa_pallas /
// _rpa_multi_pallas):
//   mxtt_rpa_f32        _rpa_kernel (:872), fp pages, one query per slot
//   mxtt_rpa_i8         _rpa_kernel (:872), quant=True: int8 pages
//   mxtt_rpa_multi_f32  _rpa_multi_kernel (:1014), W query rows per slot
//   mxtt_rpa_multi_i8   _rpa_multi_kernel (:1014), quant=True
// Same function: query row i of slot s attends over the first
// min(lengths[s] + i, npages * psize) positions of the slot's own pages,
// read through page_tables[s] (the 1-wide form is W = 1: the wrapper
// sends every one-row window to the 1-wide entries, and the widened ones
// take any W >= 2); online softmax
// in fp32, masked scores at the finite -1e30 the JAX package uses, a
// guarded divide (a row with no visible key writes zeros). Pages past a
// slot's longest row are never read, so mixed-length slots share one
// launch, and rows past a slot's real window (speculative verification's
// unused draft rows) read nothing out of bounds.
//
// int8 pages carry one fp32 scale per (page, head), read in place from
// the (P, H) scale array; each K / V element is dequantized after the
// load as float(x) * scale, the element-wise form of the JAX package's
// _dequant_gathered. Device memory moves int8 bytes only.
//
// Layout: q and out (S, W, H, dh) contiguous (W = 1 is (S, H, dh));
// k_pages / v_pages (P, psize, H, dh) read in place through their page /
// row / head strides (the layer slice of the runtime's (L, P, psize, H,
// dh) pool); scales (P, H) contiguous; page_tables (S, npages) int32;
// lengths (S,) int32 (keys visible to row 0, its own position included).
// The TPU kernels' Mosaic layouts (the (H, P) bitcast-int32 scales, the
// 8-sublane query padding, the (8, 128) scratch) are not carried over.
//
// What bounds the 1-wide entries at the serving shape (8 slots, 8 heads,
// dh = 64, psize 16, at most 32 positions a slot): neither bytes (about
// 0.47 MB fp32, 0.14 us at 3.35 TB/s) nor operations, but memory round
// trips taken one after another, and under them the launch itself (an
// empty kernel's graph-replay time, which chip_smoke.py logs beside
// them). The first design of all four entries ran one warp per (slot,
// head), 16 blocks on 132 SMs, and each warp read its length, then a page
// id, then a K row, then, position after position, a page id (and an
// int8 V scale) and a V slice: a few dozen dependent loads, so its time
// grew with the longest slot.
//
// 1-wide design (rpa1_kernel): one block per (slot, head), `warps` warps
// (kernels.rpa_plan: up to 8, as many as the table's positions need at
// kWarpPositions a warp); a chunk is kWarpPositions x warps positions,
// and warp w takes positions w * kWarpPositions.. of every chunk. Round
// trip 1: the slot's length, q and the page ids of the lane's positions
// in chunks 0 and 1, all issued together. Round trip 2: the lane's K
// pieces and V columns of chunk 0 (and int8 scales), loaded straight into
// registers, raw (int8 stays int8 until the compute). While a warp
// computes chunk c, the loads of chunk c + 1 and the page ids of chunk
// c + 2 are in flight. kPosLanes lanes score one position (float4 /
// char4 pieces, shuffles); each warp keeps its own (m, l, acc), lanes
// owning dh / 32 consecutive output columns of P.V. No barrier until the
// end, where the warps' states merge through shared memory in warp
// order, so two calls give the same bits, with no atomics and no second
// launch. At serving lengths a call is one chunk: two dependent round
// trips, the compute, the merge and the store. (Copying the chunk's rows
// into shared memory with cp.async first, double-buffered, read slower
// at every timed shape: the copies' wait and the block barriers around
// them cost more than they hid.)
//
// Widened design (rpa_multi_kernel, any W >= 2): the 1-wide design over
// groups of kGroupRows query rows. One block per (slot, head, group)
// (kernels.rpa_multi_plan: the 1-wide plan's warps, the groups on the
// grid's y axis), the same chunks, lanes and loader (load_chunk). A
// position's K row is read once and scored against every row of the
// group (its pieces dequantized once, then one dot a row), and its V
// columns feed every row's accumulator. Each warp keeps (m, l, acc) per
// row, row i masking positions at and past min(lengths[s] + i, npages *
// psize); the group reads up to its last row's. A position a row cannot
// see leaves that row's state as it was (alpha = 1, p = 0), so row i
// sums as the 1-wide kernel does at lengths + i (the same bits), in
// short chains: dh / 8 terms a lane, then shuffles, and P.V chains of
// positions / warps terms before the fixed-order merge. (The first
// design's dh-term and all-position serial fp32 sums were what put its
// int8 form beyond RPA_TOL from float64.) The rows of a chunk run with
// no branch, selects only, so that their shuffle and exponential chains
// interleave (a branch a row ran them one after another); a row past the
// window scores nothing. The merge takes one barrier: each warp stores
// its (m, l, acc) per row to shared memory (warps x kGroupRows x (2 +
// dh) floats), then each output element rescales the warps' states to
// their largest m and sums them in warp order, with the 1-wide form's
// rounded products; no atomics. kGroupRows = 4 is the register budget:
// at dh = 128, four rows of q in float4 pieces take 64 registers a lane,
// two chunks of raw fp32 rows 64 more, besides the accumulators; and it
// is the fast path's window (speculative_k = 3). Groups go on the grid's
// y axis: a loop over them in one block paid the round trips again for
// each group and read about twice as slow at W = 9 (PERF.md). What
// bounds it at the fast-path shape (8 slots, W = 4, 8 heads, dh = 64,
// psize 16): neither bytes (about 0.65 MB fp32, 0.19 us) nor
// operations, but, as for the 1-wide form, the launch and two dependent
// round trips, then the four rows' shuffle chains and the merge; at long
// tables a chunk of 32 positions after another.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kPosLanes = 8;                     // lanes scoring one position
constexpr int kWarpPositions = 32 / kPosLanes;   // positions a warp a chunk
constexpr int kMaxBlockWarps = 8;
constexpr int kStages = 2;                       // chunks held in registers
constexpr int kSmemDefault = 49152;              // dynamic shared, no opt-in
constexpr int kGroupRows = 4;                    // widened: rows a block

// shared bytes of a plan: the warps' (m, l) and accumulators, for the merge
__host__ __device__ constexpr size_t rpa1_smem(int warps, int dh) {
  return sizeof(float) * warps * (2 + dh);
}
static_assert(rpa1_smem(kMaxBlockWarps, 128) <= kSmemDefault,
              "the widest 1-wide plan fits a block without an opt-in");
// and of a widened plan: the same for each of a group's rows
__host__ __device__ constexpr size_t rpa_multi_smem(int warps, int dh) {
  return sizeof(float) * warps * kGroupRows * (2 + dh);
}
static_assert(rpa_multi_smem(kMaxBlockWarps, 128) <= kSmemDefault,
              "the widest widened plan fits a block without an opt-in");

// N consecutive elements of a K or V row, raw (int8 stays int8 until the
// compute): one vector load where N elements make 4, 8 or 16 bytes
template <typename T, int N>
__device__ __forceinline__ void load_raw(const T* p, T (&dst)[N]) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes == 16) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(p);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(p);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<float*>(dst) = *reinterpret_cast<const float*>(p);
  } else if constexpr (kBytes == 2) {
    *reinterpret_cast<short*>(dst) = *reinterpret_cast<const short*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = p[e];
  }
}

// a lane's raw rows of one chunk: the K pieces r, r + 8, ... of its own
// position and the V columns d0.. of its warp's kWarpPositions positions
// (and int8 scales)
template <typename T, int DCH>
struct ChunkRegs {
  T k[DCH][4];
  T v[kWarpPositions][DCH];
  float kscale, vscale[kWarpPositions];
};

// a chunk's rows into R, for positions below `len`: `first` is the warp's
// first position of the chunk, lane (j, r) scores position first + j, and
// `off` and `page` are that position's element offset and page
template <typename T, int DCH>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ kp, const T* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, int H, int h,
    int dh, int first, int len, int j, int r, int d0, long long off,
    int page, ChunkRegs<T, DCH>& R) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  if (first + j < len) {
#pragma unroll
    for (int i = 0; i < DCH; ++i) {
      const int g = r + kPosLanes * i;
      if (4 * g < dh) load_raw<T, 4>(kp + off + 4 * g, R.k[i]);
    }
    if (kQuant) R.kscale = ks[(size_t)page * H + h];
  }
#pragma unroll
  for (int jj = 0; jj < kWarpPositions; ++jj) {
    const long long o = __shfl_sync(kFull, off, jj * kPosLanes);
    const int pg = __shfl_sync(kFull, page, jj * kPosLanes);
    if (first + jj < len) {
      if (d0 < dh) load_raw<T, DCH>(vp + o + d0, R.v[jj]);
      if (kQuant) R.vscale[jj] = vs[(size_t)pg * H + h];
    }
  }
}

// ---------------------------------------------------------------------------
// 1-wide: one block per (slot, head)
// ---------------------------------------------------------------------------
// T: page element type (float, or int8_t with a scale per (page, head));
// DCH: 1, 2 or 4 for dh up to 32, 64, 128: a lane's output columns, and
// its float4 / char4 pieces of a K row
template <typename T, int DCH>
__global__ void __launch_bounds__(kMaxBlockWarps * 32)
rpa1_kernel(const float* __restrict__ q, const T* __restrict__ kp,
            const T* __restrict__ vp, const float* __restrict__ ks,
            const float* __restrict__ vs,
            const int* __restrict__ page_tables,
            const int* __restrict__ lengths, float* __restrict__ out, int H,
            int dh, int psize, int npages, long long sp, long long so,
            long long sh, float sm_scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  extern __shared__ float merge[];         // the warps' m, l and acc
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.x / H;
  const int h = blockIdx.x - s * H;
  const int chunk = kWarpPositions * warps;
  const int cap = npages * psize;
  const int* pt = page_tables + (size_t)s * npages;
  const long long hoff = (long long)h * sh;
  const int j = lane / kPosLanes;
  const int r = lane % kPosLanes;
  const int base = warp * kWarpPositions;   // this warp's first position
  const int d0 = lane * DCH;                // this lane's output columns

  using Regs = ChunkRegs<T, DCH>;
  // chunk c's raw K pieces of this lane's position and V columns of the
  // warp's positions (and int8 scales)
  auto load = [&](int c, int len, long long off, int page, Regs& R) {
    load_chunk<T, DCH>(kp, vp, ks, vs, H, h, dh, c * chunk + base, len, j,
                       r, d0, off, page, R);
  };
  auto page_of = [&](int t) { return pt[t / psize]; };
  auto offset_of = [&](int t, int page) -> long long {
    return page * sp + (t - (t / psize) * psize) * so + hoff;
  };

  // round trip 1: the length, q, this lane's positions of chunks 0 and 1
  // (table entries within bounds; their pages are read only below len)
  const int t0 = base + j, t1 = chunk + base + j;
  const int page0 = t0 < cap ? page_of(t0) : 0;
  int page1 = t1 < cap ? page_of(t1) : 0;
  const float* qrow = q + ((size_t)s * H + h) * dh;
  float4 qv[DCH];
#pragma unroll
  for (int i = 0; i < DCH; ++i) {
    const int g = r + kPosLanes * i;
    qv[i] = 4 * g < dh ? make_float4(qrow[4 * g], qrow[4 * g + 1],
                                     qrow[4 * g + 2], qrow[4 * g + 3])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int len = max(0, min(lengths[s], cap));
  long long off1 = offset_of(t1, page1);

  float m = kMasked, l = 0.f, acc[DCH];
#pragma unroll
  for (int cc = 0; cc < DCH; ++cc) acc[cc] = 0.f;
  static_assert(kStages == 2, "a warp holds the chunk it computes and "
                               "the next one");
  Regs cur, nxt;
  // round trip 2: chunk 0's rows
  load(0, len, offset_of(t0, page0), page0, cur);
  for (int c = 0; c * chunk + base < len; ++c) {   // the same for the warp
    // chunk c + 1's rows and chunk c + 2's page ids in flight while
    // chunk c computes
    load(c + 1, len, off1, page1, nxt);
    const int t2 = (c + 2) * chunk + base + j;
    if (t2 < len) page1 = page_of(t2);
    const int first = c * chunk + base;
    const bool valid = first + j < len;
    float dot = 0.f;
    if (valid) {
      const float kscale = kQuant ? cur.kscale : 1.f;
#pragma unroll
      for (int i = 0; i < DCH; ++i) {
        const int g = r + kPosLanes * i;
        if (4 * g < dh) {
          dot = fmaf(qv[i].x, static_cast<float>(cur.k[i][0]) * kscale, dot);
          dot = fmaf(qv[i].y, static_cast<float>(cur.k[i][1]) * kscale, dot);
          dot = fmaf(qv[i].z, static_cast<float>(cur.k[i][2]) * kscale, dot);
          dot = fmaf(qv[i].w, static_cast<float>(cur.k[i][3]) * kscale, dot);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < kPosLanes; o <<= 1)
      dot += __shfl_xor_sync(kFull, dot, o);
    const float sc = valid ? dot * sm_scale : kMasked;
    float mc = sc;
#pragma unroll
    for (int o = kPosLanes; o < 32; o <<= 1)
      mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
    const float m_new = fmaxf(m, mc);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(sc - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = kPosLanes; o < 32; o <<= 1)
      psum += __shfl_xor_sync(kFull, psum, o);
    l = alpha * l + psum;
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) acc[cc] *= alpha;
    m = m_new;
    const int nv = min(kWarpPositions, len - first);
#pragma unroll
    for (int jj = 0; jj < kWarpPositions; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj * kPosLanes);
      if (jj < nv && d0 < dh) {
        const float vscale = kQuant ? cur.vscale[jj] : 1.f;
#pragma unroll
        for (int cc = 0; cc < DCH; ++cc)
          acc[cc] = fmaf(pj, static_cast<float>(cur.v[jj][cc]) * vscale,
                         acc[cc]);
      }
    }
    cur = nxt;
    off1 = offset_of(t2, page1);
  }

  // the warps' states, merged in warp order: each warp rescales its own
  // (l, acc) to the block's largest m, then a fixed-order sum
  float* mw = merge;
  float* lw = merge + warps;
  float* aw = merge + 2 * warps;
  if (lane == 0) mw[warp] = m;
  __syncthreads();
  float top = kMasked;
  for (int w = 0; w < warps; ++w) top = fmaxf(top, mw[w]);
  const float e = expf(m - top);           // 0 for a warp that saw no key
  if (lane == 0) lw[warp] = e * l;
  if (d0 < dh)
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) aw[warp * dh + d0 + cc] = e * acc[cc];
  __syncthreads();
  float lsum = 0.f;
  for (int w = 0; w < warps; ++w) lsum += lw[w];
  float* orow = out + ((size_t)s * H + h) * dh;
  for (int d = tid; d < dh; d += nthreads) {
    float o = 0.f;
    for (int w = 0; w < warps; ++w) o += aw[w * dh + d];
    orow[d] = o / fmaxf(lsum, 1e-30f);     // no visible key: zeros out
  }
}

__global__ void launch_floor_kernel() {}

template <typename T, int DCH>
int launch1(const float* q, const T* kp, const T* vp, const float* ks,
            const float* vs, const int* pt, const int* lengths, float* out,
            int S, int H, int dh, int psize, int npages, long long sp,
            long long so, long long sh, float sm_scale, int warps,
            long long smem, cudaStream_t stream) {
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      smem != static_cast<long long>(rpa1_smem(warps, dh)))
    return static_cast<int>(cudaErrorInvalidValue);
  rpa1_kernel<T, DCH><<<S * H, 32 * warps, smem, stream>>>(
      q, kp, vp, ks, vs, pt, lengths, out, H, dh, psize, npages, sp, so, sh,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_1wide(const float* q, const T* kp, const T* vp, const float* ks,
                 const float* vs, const int* pt, const int* lengths,
                 float* out, int S, int H, int dh, int psize, int npages,
                 long long sp, long long so, long long sh, float sm_scale,
                 int warps, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || H <= 0 || dh <= 0 || dh % 4 != 0 || psize <= 0 ||
      npages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define MXTT_RPA1(DCH)                                                      \
  launch1<T, DCH>(q, kp, vp, ks, vs, pt, lengths, out, S, H, dh, psize,    \
                  npages, sp, so, sh, sm_scale, warps, smem, st)
  if (dh <= 32) return MXTT_RPA1(1);
  if (dh <= 64) return MXTT_RPA1(2);
  if (dh <= 128) return MXTT_RPA1(4);
  return static_cast<int>(cudaErrorInvalidValue);
#undef MXTT_RPA1
}

// ---------------------------------------------------------------------------
// widened (W >= 2 query rows a slot): one block per (slot, head, group of
// kGroupRows rows), the groups on the grid's y axis
// ---------------------------------------------------------------------------
template <typename T, int DCH>
__global__ void __launch_bounds__(kMaxBlockWarps * 32)
rpa_multi_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const float* __restrict__ ks,
                 const float* __restrict__ vs,
                 const int* __restrict__ page_tables,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 int W, int H, int dh, int psize, int npages, long long sp,
                 long long so, long long sh, float sm_scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int G = kGroupRows;
  extern __shared__ float merge[];   // the warps' m, l and acc of G rows
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.x / H;
  const int h = blockIdx.x - s * H;
  const int chunk = kWarpPositions * warps;
  const int cap = npages * psize;
  const int* pt = page_tables + (size_t)s * npages;
  const long long hoff = (long long)h * sh;
  const int j = lane / kPosLanes;
  const int r = lane % kPosLanes;
  const int base = warp * kWarpPositions;   // this warp's first position
  const int d0 = lane * DCH;                // this lane's output columns
  float* mw = merge;                        // [warp][row]
  float* lw = merge + warps * G;            // [warp][row]
  float* aw = merge + 2 * warps * G;        // [warp][row][dh]

  using Regs = ChunkRegs<T, DCH>;
  auto load = [&](int c, int len, long long off, int page, Regs& R) {
    load_chunk<T, DCH>(kp, vp, ks, vs, H, h, dh, c * chunk + base, len, j,
                       r, d0, off, page, R);
  };
  auto page_of = [&](int t) { return pt[t / psize]; };
  auto offset_of = [&](int t, int page) -> long long {
    return page * sp + (t - (t / psize) * psize) * so + hoff;
  };

  // round trip 1: the length, this lane's positions of chunks 0 and 1 and
  // (below) the group's q rows, all independent of each other
  const int t0 = base + j, t1 = chunk + base + j;
  const int page0 = t0 < cap ? page_of(t0) : 0;
  int page1 = t1 < cap ? page_of(t1) : 0;
  const int len0 = lengths[s];
  const bool qvec = (reinterpret_cast<uintptr_t>(q) & 15) == 0;

  const int g0 = blockIdx.y * G;          // the block's first row
  const int rows = min(G, W - g0);        // the group's live rows
  int vis[G];                             // keys row g0 + k sees
#pragma unroll
  for (int k = 0; k < G; ++k)
    vis[k] = k < rows ? max(0, min(len0 + g0 + k, cap)) : 0;
  const int glen = max(0, min(len0 + g0 + rows - 1, cap));
  // the group's q rows in float4 pieces: one 16-byte load a piece where
  // q is 16-byte aligned (its rows then are: dh % 4 == 0)
  float4 qv[G][DCH];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float* qrow = q + (((size_t)s * W + g0 + k) * H + h) * dh;
#pragma unroll
    for (int i = 0; i < DCH; ++i) {
      const int g = r + kPosLanes * i;
      qv[k][i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < rows && 4 * g < dh)
        qv[k][i] = qvec ? *reinterpret_cast<const float4*>(qrow + 4 * g)
                        : make_float4(qrow[4 * g], qrow[4 * g + 1],
                                      qrow[4 * g + 2], qrow[4 * g + 3]);
    }
  }

  float m[G], l[G], acc[G][DCH];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    m[k] = kMasked;
    l[k] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) acc[k][cc] = 0.f;
  }
  long long off1 = offset_of(t1, page1);
  Regs cur, nxt;
  // round trip 2: chunk 0's rows
  load(0, glen, offset_of(t0, page0), page0, cur);
  for (int c = 0; c * chunk + base < glen; ++c) {   // the same for the warp
    load(c + 1, glen, off1, page1, nxt);
    const int t2 = (c + 2) * chunk + base + j;
    if (t2 < glen) page1 = page_of(t2);
    const int first = c * chunk + base;
    const int t = first + j;                // this lane's position
    // its K pieces, dequantized once for every row (zeros where
    // nothing was loaded, so that the rows below need no branch: a
    // branch a row would run the rows' shuffle chains one after
    // another; a row past the window has vis = 0 and gets p = 0)
    float kf[DCH][4];
    const float kscale = kQuant ? cur.kscale : 1.f;
#pragma unroll
    for (int i = 0; i < DCH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kf[i][e] = t < glen && 4 * (r + kPosLanes * i) < dh
                       ? static_cast<float>(cur.k[i][e]) * kscale
                       : 0.f;
    float p[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const bool valid = t < vis[k];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DCH; ++i) {
        dot = fmaf(qv[k][i].x, kf[i][0], dot);
        dot = fmaf(qv[k][i].y, kf[i][1], dot);
        dot = fmaf(qv[k][i].z, kf[i][2], dot);
        dot = fmaf(qv[k][i].w, kf[i][3], dot);
      }
#pragma unroll
      for (int o = 1; o < kPosLanes; o <<= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      const float sc = valid ? dot * sm_scale : kMasked;
      float mc = sc;
#pragma unroll
      for (int o = kPosLanes; o < 32; o <<= 1)
        mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
      const float m_new = fmaxf(m[k], mc);
      const float alpha = expf(m[k] - m_new);
      p[k] = valid ? expf(sc - m_new) : 0.f;
      float psum = p[k];
#pragma unroll
      for (int o = kPosLanes; o < 32; o <<= 1)
        psum += __shfl_xor_sync(kFull, psum, o);
      l[k] = alpha * l[k] + psum;
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc) acc[k][cc] *= alpha;
      m[k] = m_new;
    }
    const int nv = min(kWarpPositions, glen - first);
#pragma unroll
    for (int jj = 0; jj < kWarpPositions; ++jj) {
      float pj[G];
#pragma unroll
      for (int k = 0; k < G; ++k)
        pj[k] = __shfl_sync(kFull, p[k], jj * kPosLanes);
      if (jj < nv && d0 < dh) {
        const float vscale = kQuant ? cur.vscale[jj] : 1.f;
#pragma unroll
        for (int cc = 0; cc < DCH; ++cc) {
          const float v = static_cast<float>(cur.v[jj][cc]) * vscale;
#pragma unroll
          for (int k = 0; k < G; ++k)
            acc[k][cc] = fmaf(pj[k], v, acc[k][cc]);
        }
      }
    }
    cur = nxt;
    off1 = offset_of(t2, page1);
  }

  // each row's warp states, merged in warp order: one barrier, then each
  // output element rescales the warps' (l, acc) to their largest m
  // (rounded products, as the 1-wide form) and sums them in order
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < G; ++k) {
      mw[warp * G + k] = m[k];
      lw[warp * G + k] = l[k];
    }
  if (d0 < dh)
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc)
        aw[(warp * G + k) * dh + d0 + cc] = acc[k][cc];
  __syncthreads();
  for (int x = tid; x < rows * dh; x += nthreads) {
    const int k = x / dh;
    const int d = x - k * dh;
    float top = kMasked;
    for (int w = 0; w < warps; ++w) top = fmaxf(top, mw[w * G + k]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float e = expf(mw[w * G + k] - top);  // 0: a warp saw no key
      lsum += __fmul_rn(e, lw[w * G + k]);
      o += __fmul_rn(e, aw[(w * G + k) * dh + d]);
    }
    out[(((size_t)s * W + g0 + k) * H + h) * dh + d] =
        o / fmaxf(lsum, 1e-30f);           // no visible key: zeros out
  }
}

template <typename T, int DCH>
int launch_multi1(const float* q, const T* kp, const T* vp, const float* ks,
                  const float* vs, const int* pt, const int* lengths,
                  float* out, int S, int W, int H, int dh, int psize,
                  int npages, long long sp, long long so, long long sh,
                  float sm_scale, int warps, long long smem,
                  cudaStream_t stream) {
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      smem != static_cast<long long>(rpa_multi_smem(warps, dh)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (W + kGroupRows - 1) / kGroupRows;
  rpa_multi_kernel<T, DCH>
      <<<dim3(S * H, groups), 32 * warps, smem, stream>>>(
          q, kp, vp, ks, vs, pt, lengths, out, W, H, dh, psize, npages, sp,
          so, sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_multi(const float* q, const T* kp, const T* vp, const float* ks,
                 const float* vs, const int* pt, const int* lengths,
                 float* out, int S, int W, int H, int dh, int psize,
                 int npages, long long sp, long long so, long long sh,
                 float sm_scale, int warps, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || W < 2 || H <= 0 || dh <= 0 || dh % 4 != 0 || psize <= 0 ||
      npages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define MXTT_RPA_MULTI(DCH)                                                 \
  launch_multi1<T, DCH>(q, kp, vp, ks, vs, pt, lengths, out, S, W, H, dh,  \
                        psize, npages, sp, so, sh, sm_scale, warps, smem,  \
                        st)
  if (dh <= 32) return MXTT_RPA_MULTI(1);
  if (dh <= 64) return MXTT_RPA_MULTI(2);
  if (dh <= 128) return MXTT_RPA_MULTI(4);
  return static_cast<int>(cudaErrorInvalidValue);
#undef MXTT_RPA_MULTI
}

}  // namespace

// Strides are in elements. Each returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a plan this file
// would not have made. The 1-wide entries take kernels.rpa_plan's warps
// (1, 2, 4 or 8) and shared bytes (rpa1_smem); the widened ones take
// kernels.rpa_multi_plan's warps and shared bytes (rpa_multi_smem),
// launch a block per (slot, head, group of kGroupRows rows), and refuse
// W = 1, which the 1-wide entries compute.
extern "C" int mxtt_rpa_f32(const float* q, const float* k_pages,
                            const float* v_pages, const int* page_tables,
                            const int* lengths, float* out, int S, int H,
                            int dh, int psize, int npages,
                            long long stride_page, long long stride_row,
                            long long stride_head, float sm_scale, int warps,
                            long long smem, void* stream) {
  return launch_1wide<float>(q, k_pages, v_pages, nullptr, nullptr,
                             page_tables, lengths, out, S, H, dh, psize,
                             npages, stride_page, stride_row, stride_head,
                             sm_scale, warps, smem, stream);
}

extern "C" int mxtt_rpa_i8(const float* q, const int8_t* k_pages,
                           const int8_t* v_pages, const float* k_scales,
                           const float* v_scales, const int* page_tables,
                           const int* lengths, float* out, int S, int H,
                           int dh, int psize, int npages,
                           long long stride_page, long long stride_row,
                           long long stride_head, float sm_scale, int warps,
                           long long smem, void* stream) {
  return launch_1wide<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                              page_tables, lengths, out, S, H, dh, psize,
                              npages, stride_page, stride_row, stride_head,
                              sm_scale, warps, smem, stream);
}

// An empty kernel of `blocks` x `threads`: the floor under any one-launch
// kernel of that grid (chip_smoke.py times it beside the paged kernels).
extern "C" int mxtt_launch_floor(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxtt_rpa_multi_f32(const float* q, const float* k_pages,
                                  const float* v_pages,
                                  const int* page_tables, const int* lengths,
                                  float* out, int S, int W, int H, int dh,
                                  int psize, int npages,
                                  long long stride_page, long long stride_row,
                                  long long stride_head, float sm_scale,
                                  int warps, long long smem, void* stream) {
  return launch_multi<float>(q, k_pages, v_pages, nullptr, nullptr,
                             page_tables, lengths, out, S, W, H, dh, psize,
                             npages, stride_page, stride_row, stride_head,
                             sm_scale, warps, smem, stream);
}

extern "C" int mxtt_rpa_multi_i8(const float* q, const int8_t* k_pages,
                                 const int8_t* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* page_tables, const int* lengths,
                                 float* out, int S, int W, int H, int dh,
                                 int psize, int npages, long long stride_page,
                                 long long stride_row, long long stride_head,
                                 float sm_scale, int warps, long long smem,
                                 void* stream) {
  return launch_multi<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                              page_tables, lengths, out, S, W, H, dh, psize,
                              npages, stride_page, stride_row, stride_head,
                              sm_scale, warps, smem, stream);
}
