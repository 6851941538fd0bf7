// Flash-attention forward, fp32, for Hopper (sm_90a), on the tensor cores
// in split TF32.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (:219,
// launched by _flash_fwd_pallas). Same function: online-softmax attention
// with fp32 m / l / acc, an optional causal mask (kj <= qi in absolute
// indices: the top-left mask of attention_reference, for any Sq and Sk),
// an optional per-batch key-length mask (kj < kv_len[b]), masked scores
// at the finite -1e30 the JAX package uses, a guarded divide so a row
// with no visible key writes zeros, and the per-row log-sum-exp
// m + log(max(l, 1e-30)).
//
// Layout: q (B, H, Sq, D), k / v (B, H, Sk, D), out (B, H, Sq, D), all
// contiguous fp32, any Sq and Sk, D <= 128; kv_len (B,) int32 or NULL;
// lse (B*H, Sq) fp32 — compact: the 128-lane broadcast of the TPU
// version is a Mosaic tiling constraint and is not copied.
//
// What bounds it on this card. chip_smoke.py counts the live (q, k) pairs
// (a key tile at or past kv_len is never loaded): 4 * pairs * D FLOP (S =
// QK^T and O = PV) against q, the live K / V rows, out, lse and kv_len
// moved once. At BERT's shape (B=16, H=12, S=512, D=64, lengths
// 256-512) that is 9.4 GFLOP: 0.057 ms at the split-TF32 rate (the H100's
// dense TF32 tensor-core peak, 495 TFLOP/s, over the 3 passes) against
// 0.026 ms of bytes, so operations bound it. At the serving prefill (B=1,
// H=8, S=128, D=64, kv_len 77) the bytes do (0.25 us), and what is left
// is latency: the launch, the loads and the walk over the key tiles. The
// SIMT kernel this file replaced ran one warp a query row in fp32 FMAs at
// 6.3 TFLOP/s (26x its bound at BERT's shape).
//
// Design:
// * A warp owns 16 query rows and walks 32-key tiles; a block holds 4
//   such warps (64 rows) of one (b, h). The TPU's sequential kv grid axis
//   becomes that walk, because Hopper blocks run in no order. Where 64
//   rows a block would leave SMs of the card idle (the serving prefill:
//   B*H = 8, S = 128, 16 blocks), a block takes 32 or 16 rows and up to 8
//   warps split each row group's keys in 16-key tiles: warp w takes tiles
//   w, w + ks, ..., and the ks warps merge their (m, l, O) through shared
//   memory at the end: each warp's walk is short where the latency of
//   its products, not the card's throughput, sets the time
//   (kernels.py:flash_fwd_plan chooses rw row warps, ks key warps and
//   the tile).
// * K and V tiles (ks of them a step) are double-buffered in shared
//   memory with cp.async, so the next step loads while the current one
//   is computed; the first step is requested before kv_len is read.
// * S = QK^T and O += PV on mma.sync.m16n8k8 in split TF32 (tf32_mma.cuh,
//   the arithmetic of flash_bwd.cu); each tile's PV goes to zeroed
//   accumulators and into O by fp32 fma (tile_add), so O's error does
//   not grow with the walk. At DP <= 64 the warp splits its Q
//   rows into hi / lo A fragments once and keeps them in registers; wider
//   rows are read from shared memory at each k-step.
// * The online softmax runs on the C fragments: a row's values sit in one
//   quad of lanes, so its max takes two shuffles a tile and its sum is
//   kept per lane and reduced once at the end. Only tiles that straddle
//   kv_len or the diagonal are masked, and there a masked p is set to 0
//   (so a row may meet its first visible key in any tile). Tiles at or
//   past min(Sk, kv_len[b]) and, when causal, past the block's last row
//   are never loaded (the TPU's pl.when skip), and a warp skips the
//   8-key columns and tiles where all of its p are 0.
// * P feeds PV from registers: the C fragment of an 8-key score tile
//   (columns 2t, 2t + 1) is the A fragment of the product with the
//   contraction over the tile's keys permuted (k = t, t + 4), and V's rows
//   are read in that order (c_as_a, load_b_perm). O stays in registers
//   (DP / 8 tiles of 4) and is divided by max(l, 1e-30) at the end.
// * Ragged edges: D is zero-padded to DP = 32, 64, 96 or 128 in shared
//   memory, rows past Sq or Sk are zero-filled by cp.async and masked, so
//   any D <= 128 and any Sq, Sk launch; rows go in 16-byte pieces only
//   when D % 4 == 0 and the bases are aligned (`vec`).
// Each launch recomputes the plan's shared bytes here and refuses a plan
// that disagrees.
//
// bfloat16 and float16 forms (mxtt_flash_fwd_bf16, mxtt_flash_fwd_f16),
// for Hopper on wgmma: one kernel template on the element type, the same
// function and masks on bf16 or f16 q / k / v, with the JAX kernel's
// rounding points (pallas_kernels.py:245-291, which reads the input dtype
// either way): S = Q K^T in fp32, the online softmax in fp32, P rounded to
// the input type for P V (fp32 sums; l sums the unrounded p), out divided
// by max(l, 1e-30) and rounded once, lse fp32. The float16 form is the
// bf16 one instantiated for __half (.f32.f16.f16 products, f16 tensor
// maps, __floats2half2_rn): fp16 runs at the bf16 tensor-core rate and
// both types are 2 bytes, so the tiles, the plan and the bounds below are
// the same; fp16 keeps 3 more bits of P (unit roundoff 2^-11) over a
// narrower range (p below 2^-24 rounds to 0, as in the JAX kernel).
//
// What bounds it on this card. At BERT's shape (B*H = 192, S = 512, D =
// 64, lengths 256-512, 37.7 M live (q, k) pairs) its 4 * pairs * D = 9.7
// GFLOP take 0.0098 ms at the bf16 tensor-core peak (989 TFLOP/s), and
// its bytes (bf16 q and out, the live K / V rows, fp32 lse) 0.0131 ms at
// 3.35 TB/s. At D = 64 the softmax's exp2 on the MUFU unit (16 a clock
// an SM) takes about as long as the products, so the two have to
// overlap. The mma.sync form this replaced (0.1228 ms there, 9.3x the
// bound) gave each warp 16 rows, so every warp reloaded each K and V
// fragment from shared memory for its own small products, met the block
// at two barriers a 32-key step and ran its exp2 and products as one
// chain.
//
// Design:
// * A consumer warpgroup owns 64 query rows of one (b, h); a block holds
//   two (an item of 128 rows) and a producer warpgroup, whose registers go
//   to the consumers (setmaxnreg: 24 a thread, 240 a consumer thread). One
//   producer thread issues TMA: each item's Q into one of two buffers,
//   with a full and an empty mbarrier each, then its K and V tiles of BK
//   keys (128 at DP = 64, 64 at DP = 128) into a ring of three stages
//   with a full mbarrier (the bytes counted) and an empty one (each
//   consumer warp arrives when done) a stage; no block-wide barrier in
//   the walk. Tiles live in the 128-byte swizzle; D is zero-padded to DP
//   = 64 or 128 (one or two swizzle atoms), rows past Sq or Sk and
//   columns past D arrive as zeros.
// * Persistent blocks, as many as stay resident, walk the items (the row
//   blocks of a (b, h) one after another, so its K and V stay in L2):
//   the producer loads the next item's Q and first key tiles while the
//   consumers finish this one, so neither the loads' latency nor the
//   stores' lies between two items.
// * S = Q K^T is an SS wgmma m64nBKk16 (both operands K-major); O += P V
//   an RS wgmma whose a is P's accumulators packed to bf16 (c_to_a) and
//   whose b is V read N-major through the transpose bit: nothing is
//   transposed in memory, and no fragment is loaded by a thread.
// * The walk issues S of the next tile before P V of this one, so the
//   softmax of a tile (ex2.approx of pre-scaled logits, on the
//   accumulators: a row's values sit in one quad of lanes) runs while
//   the previous tile's P V is on the tensor cores. The two warpgroups of
//   an item take turns issuing their products (named barriers), so one's
//   softmax runs while the other's products do: at D = 64 the two take
//   about as long. P V goes into zeroed accumulators and into O by one
//   fp32 fma (tile_add, as the fp32 form), so O's error does not grow
//   with the walk. Masks run only in tiles that cross kv_len or the causal
//   diagonal; tiles at or past min(Sk, kv_len[b]) and, when causal, past
//   the item's last row are never loaded.
// * O leaves through shared memory: each warpgroup writes its rows in the
//   swizzle to a staging buffer, and one thread stores them by TMA (rows
//   past Sq and columns past D are not written) while the walk of the
//   next item goes on.
// * Small grids (the serving prefill, B*H = 8 and S = 128; the training
//   step's S = 64): items of one consumer warpgroup of 64 rows and 64-key
//   tiles, two blocks an SM at DP = 64 (kernels.py:_flash_fwd_plan_bf16
//   chooses). Each block shape is its own instantiation.
// * Where TMA cannot go (D % 8 != 0, a base not 16-byte aligned) the
//   producer warpgroup copies element by element into the same swizzled
//   tiles and arrives on the full barrier instead, and each thread stores
//   its own outputs.
// * No atomics: the same bits on every launch.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mxtt;

constexpr int kWarpRows = 16;   // query rows a warp owns (the mma's M)
constexpr int kMaxRowWarps = 4; // row warps a block at most (64 rows)
constexpr int kMaxWarps = 8;    // warps a block at most
constexpr int kWideBK = 32;     // keys of a warp's tile: without a key
constexpr int kSplitBK = 16;    // split, and with one
constexpr float kMasked = -1e30f;             // the JAX package's mask
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// rw warps of rows, each row group split over ks warps of BK keys
__host__ __device__ constexpr size_t fwd_smem(int DP, int BK, int rw,
                                              int ks) {
  // Q rows, then two buffers of K and V tiles (ks warp tiles each)
  return sizeof(float) * ((size_t)kWarpRows * rw + 4 * ks * BK) *
         pitch_of(DP);
}

// the card's dynamic shared memory a block at most
constexpr size_t kSmemLimit = 227 * 1024;

static_assert(fwd_smem(128, kWideBK, kMaxRowWarps, 1) <= kSmemLimit,
              "a block's shared memory exceeds 227 KB");

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// grid (B*H, ceil(Sq / (16 * rw))), 32 * rw * ks threads: warp w owns
// rows 16 * (w % rw) of the block and the key tiles w / rw, w / rw + ks,
// ... of BK keys; with ks > 1 the warps of a row group merge their
// (m, l, O) at the end
template <int DP, int BK>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ kv_len, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 int causal, float sm_scale, int ks, int vec) {
  constexpr int NT = DP / 8;          // 8-wide column tiles of D
  constexpr int KT = BK / 8;          // 8-key tiles of a warp's tile
  constexpr int P = pitch_of(DP);
  constexpr bool kQInRegs = DP <= 64;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = nthreads / 32 / ks;
  const int rows = kWarpRows * rw;
  const int sbk = BK * ks;            // keys a block step loads
  const int wk = warp / rw;           // this warp's tile of the step
  float* qs = smem;                   // rows x P
  float* kb = qs + rows * P;          // 2 x sbk x P
  float* vb = kb + 2 * sbk * P;       // 2 x sbk x P

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int ntd = (D + 7) / 8;        // column tiles holding real columns
  const int qw0 = q0 + kWarpRows * (warp % rw);   // this warp's first row

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  // key tiles starting at or past kstop hold no visible key for any row
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + rows);

  zero_pad(qs, P, rows + 4 * sbk, D, DP, tid, nthreads);
  copy_rows(qs, P, q + qbase, q0, rows, Sq, D, vec, tid, nthreads);
  cp_commit();
  auto load_step = [&](int k0, int buf) {
    copy_rows(kb + buf * sbk * P, P, k + kbase, k0, sbk, Sk, D, vec, tid,
              nthreads);
    copy_rows(vb + buf * sbk * P, P, v + kbase, k0, sbk, Sk, D, vec, tid,
              nthreads);
  };
  load_step(0, 0);                    // before kv_len is known (Sk > 0)
  cp_commit();

  const float* qw = qs + (qw0 - q0) * P;
  uint32_t qh[kQInRegs ? NT : 1][4], ql[kQInRegs ? NT : 1][4];
  if constexpr (kQInRegs) {
    cp_wait<1>();                     // the Q rows (and the padding)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
      load_a(qw, P, 8 * kk, g, t, qh[kk], ql[kk]);
  }

  // rows g and g + 8 of the warp: running max and this lane's share of
  // the running sum; O in the C layout of 16 x DP
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int buf = 0;
  for (int k0 = 0; k0 < kstop; k0 += sbk, buf ^= 1) {
    if (k0 + sbk < kstop) {
      load_step(k0 + sbk, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kw0 = k0 + BK * wk;     // this warp's first key
    const float* kt = kb + (buf * sbk + BK * wk) * P;
    const float* vt = vb + (buf * sbk + BK * wk) * P;
    // keys of this tile that can hold a p > 0 for this warp's rows
    int klive = min(kend - kw0, BK);
    if (causal) klive = min(klive, qw0 + kWarpRows - kw0);
    if (qw0 < Sq && klive > 0) {
      float s[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T over the columns that hold real values
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        if (kk >= ntd) break;
        uint32_t ah[4], al[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[kk][i];
          }
        } else {
          load_a(qw, P, 8 * kk, g, t, ah, al);
        }
        uint32_t bh_[KT][2], bl_[KT][2];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          load_b_rows(kt + 8 * j * P + 8 * kk, P, g, t, bh_[j], bl_[j]);
        mma3x1<KT>(s, ah, al, bh_, bl_);
      }
      // scale; mask only a tile that straddles kv_len or the diagonal
      // (its keys past klive among them)
      const bool edge = kw0 + BK > kend || (causal && kw0 + BK - 1 > qw0);
      unsigned keep = ~0u;            // bit 4j + e: entry (j, e) is visible
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= sm_scale;
          if (edge) {
            const int kj = kw0 + 8 * j + 2 * t + (e & 1);
            const int qi = qw0 + g + ((e & 2) ? 8 : 0);
            if (!(kj < kend && (!causal || kj <= qi))) {
              s[j][e] = kMasked;
              keep &= ~(1u << (4 * j + e));
            }
          }
        }
      }
      // the online softmax; a masked entry's p is 0 whatever the row's
      // running max, so a row may meet its first visible key in any tile
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp2f((m0 - mx0) * kLog2e);
      const float a1 = exp2f((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[j][e], kLog2e, (e & 2) ? -ml1 : -ml0));
          s[j][e] = (keep >> (4 * j + e)) & 1u ? p : 0.f;
        }
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      // O = O alpha + P V over the 8-key columns with a live key
      // (permuted): the tile's product in zeroed accumulators, then one
      // fp32 fma into O (tile_add)
      float pv[NT][4] = {};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (8 * j >= klive) break;
        uint32_t ph[4], pl[4];
        c_as_a(s[j], ph, pl);
        const float* vr = vt + 8 * j * P;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 4) {
          if (n0 >= ntd) break;
          uint32_t bh_[4][2], bl_[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            load_b_perm(vr + 8 * (n0 + i), P, g, t, bh_[i], bl_[i]);
          mma3x1<4>(pv + n0, ph, pl, bh_, bl_);
        }
      }
      tile_add<NT>(o, pv, a0, a1);
    }
    __syncthreads();  // this buffer is consumed
  }
  cp_wait<0>();

  if (ks > 1) {
    // the warps of a row group merge into its first: each later warp
    // leaves (m, l, O) of every lane in the tile buffers, lane-minor
    constexpr int W = 4 * NT + 4;
    __syncthreads();                  // (the loop may not have run)
    if (wk > 0) {
      float* part = kb + (size_t)(warp - rw) * 32 * W + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[32 * (4 * n + e)] = o[n][e];
      part[32 * (4 * NT)] = m0;
      part[32 * (4 * NT + 1)] = m1;
      part[32 * (4 * NT + 2)] = l0;
      part[32 * (4 * NT + 3)] = l1;
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < ks; ++w) {
      const float* pw = kb + (size_t)(warp + (w - 1) * rw) * 32 * W + lane;
      const float pm0 = pw[32 * (4 * NT)], pm1 = pw[32 * (4 * NT + 1)];
      const float n0 = fmaxf(m0, pm0), n1 = fmaxf(m1, pm1);
      const float a0 = exp2f((m0 - n0) * kLog2e);
      const float b0 = exp2f((pm0 - n0) * kLog2e);
      const float a1 = exp2f((m1 - n1) * kLog2e);
      const float b1 = exp2f((pm1 - n1) * kLog2e);
      l0 = l0 * a0 + pw[32 * (4 * NT + 2)] * b0;
      l1 = l1 * a1 + pw[32 * (4 * NT + 3)] * b1;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = o[n][e] * ((e & 2) ? a1 : a0) +
                    pw[32 * (4 * n + e)] * ((e & 2) ? b1 : b0);
      m0 = n0;
      m1 = n1;
    }
  }

  // a row with every key masked has l == 0: it writes zeros
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qw0 + g + ((e & 2) ? 8 : 0);
      const int d = 8 * n + 2 * t + (e & 1);
      if (qi < Sq && d < D)
        out[qbase + (size_t)qi * D + d] = o[n][e] / ((e & 2) ? d1 : d0);
    }
  }
  if (t == 0) {
    if (qw0 + g < Sq) lse[(size_t)bh * Sq + qw0 + g] = m0 + logf(d0);
    if (qw0 + g + 8 < Sq) lse[(size_t)bh * Sq + qw0 + g + 8] = m1 + logf(d1);
  }
}

template <int DP, int BK>
int launch(const float* q, const float* k, const float* v, const int* kv_len,
           float* out, float* lse, int B, int H, int Sq, int Sk, int D,
           int causal, float sm_scale, int rw, int ks, int vec,
           long long smem, cudaStream_t stream) {
  // the merge leaves (ks - 1) * rw warps' state in the tile buffers
  const size_t state = sizeof(float) * (ks - 1) * rw * 32 * (DP / 2 + 4);
  if (rw < 1 || rw > kMaxRowWarps || ks < 1 || rw * ks > kMaxWarps ||
      smem != static_cast<long long>(fwd_smem(DP, BK, rw, ks)) ||
      smem > static_cast<long long>(kSmemLimit) ||
      state > fwd_smem(DP, BK, 0, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_fwd_kernel<DP, BK>, kSmemLimit, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kWarpRows * rw;
  const dim3 grid(B * H, (Sq + rows - 1) / rows);
  flash_fwd_kernel<DP, BK><<<grid, 32 * rw * ks, smem, stream>>>(
      q, k, v, kv_len, out, lse, H, Sq, Sk, D, causal, sm_scale, ks, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 and float16 forms, on wgmma (wgmma.cuh) fed by TMA (tma.cuh):
// one template on the element type T (bf16 or f16; both 2 bytes, so the
// plan, its tiles and their bytes are one, named for bf16, the first)
// ---------------------------------------------------------------------------
constexpr int kBf16WgRows = 64;   // query rows of a consumer warpgroup
constexpr int kBf16RowWgs = 2;    // consumer warpgroups of a 128-row block
// ring stages: a warpgroup holds two key tiles at once (S of the next is
// issued before P V of this one), and the third lets the producer load
// ahead of both
constexpr int kBf16Stages = 3;
// keys of a tile: 128 where two warpgroups share each tile at DP = 64;
// else 64 (at DP = 128, S and P V's accumulators share a thread's
// registers; a block of one warpgroup keeps two blocks an SM)
__host__ __device__ constexpr int fwd_bf16_bk(int DP, int rw) {
  return DP == 64 && rw == kBf16RowWgs ? 128 : 64;
}

// 1024 bytes to align the swizzled tiles; two buffers of the block's Q
// rows (64 rw) and one of its O rows on the way out; the ring's K and V
// tiles (BK rows each); the ring's full and empty barriers, and a full
// and an empty one for each Q buffer
__host__ __device__ constexpr size_t fwd_smem_bf16(int DP, int BK, int rw) {
  return 1024 +
         sizeof(bf16) * ((size_t)3 * kBf16WgRows * rw * DP +
                         (size_t)2 * kBf16Stages * BK * DP) +
         sizeof(uint64_t) * (2 * kBf16Stages + 4);
}

static_assert(fwd_smem_bf16(64, fwd_bf16_bk(64, 2), 2) <= kSmemLimit &&
                  fwd_smem_bf16(128, fwd_bf16_bk(128, 2), 2) <= kSmemLimit &&
                  2 * (fwd_smem_bf16(64, fwd_bf16_bk(64, 1), 1) + 1024) <=
                      228 * 1024,
              "a bf16 block's shared memory exceeds 227 KB, or two of one "
              "warpgroup at DP = 64 an SM's 228 KB");

// registers a thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers. A block's pool is what __launch_bounds__ leaves
// it (two consumer warpgroups: 384 threads x 168; one at DP = 64, two
// blocks an SM: 256 x 128), and each split spends it exactly
constexpr int kProducerRegs = 24;
__host__ __device__ constexpr int consumer_regs(int wgs, int DP) {
  return wgs == 2 ? 240 : DP == 64 ? 232 : 240;
}

// the two consumer warpgroups of a 128-row block take turns at the tensor
// cores (named barriers 1 and 2): warpgroup w issues its products after
// turn_wait(w) and lets the other issue with turn_pass(w), so one's
// softmax runs while the other's products do
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
// the 128 threads of warpgroup wg (named barriers 3 and 4)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// Persistent: grid (min(items, resident blocks)), 128 (RW + 1) threads:
// RW consumer warpgroups, warpgroup w owning rows 64 w .. 64 w + 63 of
// each item (a block of 64 RW rows of one (b, h); the row blocks of a
// (b, h) are consecutive items, so its K and V stay in L2), then the
// producer. Block x takes items x, x + gridDim.x, ...; the producer loads
// the next item's Q and first key tiles while the consumers finish this
// one.
template <typename T, int DP, int RW>
__global__ void __launch_bounds__(128 * RW + 128, RW == 1 && DP == 64 ? 2 : 1)
flash_fwd_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      float* __restrict__ lse, int BH, int H, int Sq, int Sk,
                      int D, int causal, float sm_scale, int vec,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o) {
  constexpr int ROWS = kBf16WgRows * RW;   // query rows an item
  constexpr int NC = 128 * RW;             // consumer threads
  constexpr int BK = fwd_bf16_bk(DP, RW);
  constexpr int S = kBf16Stages;
  constexpr int NK = BK / 8;   // 8-key column tiles of S
  constexpr int ND = DP / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  T* qs = reinterpret_cast<T*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024));                  // 2 buffers of ROWS rows
  T* os = qs + 2 * ROWS * DP;           // ROWS rows
  T* kst = os + ROWS * DP;              // S tiles of BK rows
  T* vst = kst + S * BK * DP;           // S tiles of BK rows
  uint64_t* full = reinterpret_cast<uint64_t*>(vst + S * BK * DP);
  uint64_t* empty = full + S;              // S each
  uint64_t* q_full = empty + S;            // 2 each
  uint64_t* q_empty = q_full + 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warp-uniform in the compiler's eyes too (a shuffle from lane 0), as
  // kend below: a wgmma under a branch it cannot prove uniform is
  // serialized with every other
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int nrb = (Sq + ROWS - 1) / ROWS;   // row blocks of a (b, h)
  const int items = BH * nrb;
  // an item's (b, h), first row, last visible key and key tiles; key
  // tiles starting at or past kstop hold no visible key for any row of
  // the item: never loaded. Every consumer warpgroup walks all the others
  // (equal walks keep the turns paired; a warpgroup's rows past Sq, or a
  // causal tile past its rows, are computed and masked)
  struct Item {
    int bh, q0, kend, ntiles;
  };
  auto item_of = [&](int it) {
    Item w;
    w.bh = it / nrb;
    w.q0 = (it - w.bh * nrb) * ROWS;
    int kend = Sk;
    if (kv_len != nullptr) kend = max(0, min(kend, kv_len[w.bh / H]));
    w.kend = __shfl_sync(kFull, kend, 0);
    const int kstop = causal ? min(w.kend, w.q0 + ROWS) : w.kend;
    w.ntiles = (kstop + BK - 1) / BK;
    return w;
  };

  // the ring: the block's key tiles in the order loaded, tile c in stage
  // c % S; full[st] completes when its K and V are in (TMA: the bytes
  // counted; else the producer's copies), empty[st] when each consumer
  // warp is done with it. The item n's Q lies in buffer n % 2, with a
  // full and an empty barrier of its own
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, vec ? 1 : 128);
      mbar_init(empty + st, NC / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + b, vec ? 1 : 128);
      mbar_init(q_empty + b, NC / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NC / 32) {
    // the producer warpgroup: each item's Q, then its key tiles as their
    // stages free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs)
                 : "memory");
    const int ptid = tid - NC;
    if (!vec && D < DP) {
      // the padded columns are zeroed once and never written again
      for (int b = 0; b < 2; ++b) zero_pad_sw(qs + b * ROWS * DP, ROWS, D,
                                              DP, ptid, 128);
      for (int st = 0; st < S; ++st) {
        zero_pad_sw(kst + st * BK * DP, BK, D, DP, ptid, 128);
        zero_pad_sw(vst + st * BK * DP, BK, D, DP, ptid, 128);
      }
    }
    int c = 0;   // key tiles loaded so far
    for (int it = blockIdx.x, n = 0; it < items; it += gridDim.x, ++n) {
      const Item w = item_of(it);
      const int qb = n & 1;
      T* qdst = qs + qb * ROWS * DP;
      if (n >= 2) mbar_wait(q_empty + qb, ((n >> 1) - 1) & 1);
      if (vec) {
        if (ptid == 0) {
          mbar_expect_tx(q_full + qb, ROWS * DP * 2);
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load_3d(qdst + cb * ROWS * 64, &tm_q, q_full + qb, 64 * cb,
                        w.q0, w.bh);
        }
      } else {
        // element by element into the same swizzled tiles
        copy_rows_sw<ROWS, 128>(qdst, q + (size_t)w.bh * Sq * D, w.q0, Sq,
                                D, ptid);
        fence_async_smem();
        mbar_arrive(q_full + qb);
      }
      const T* kb = k + (size_t)w.bh * Sk * D;
      const T* vb = v + (size_t)w.bh * Sk * D;
      for (int i = 0; i < w.ntiles; ++i, ++c) {
        const int st = c % S;
        if (c >= S) mbar_wait(empty + st, (c / S - 1) & 1);
        if (vec) {
          if (ptid == 0) {
            mbar_expect_tx(full + st, 2 * BK * DP * 2);
#pragma unroll
            for (int cb = 0; cb < DP / 64; ++cb) {
              tma_load_3d(kst + st * BK * DP + cb * BK * 64, &tm_k,
                          full + st, 64 * cb, i * BK, w.bh);
              tma_load_3d(vst + st * BK * DP + cb * BK * 64, &tm_v,
                          full + st, 64 * cb, i * BK, w.bh);
            }
          }
        } else {
          copy_rows_sw<BK, 128>(kst + st * BK * DP, kb, i * BK, Sk, D,
                                ptid);
          copy_rows_sw<BK, 128>(vst + st * BK * DP, vb, i * BK, Sk, D,
                                ptid);
          fence_async_smem();
          mbar_arrive(full + st);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   consumer_regs(RW, DP))
               : "memory");

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rq = 16 * (warp & 3) + g;   // this thread's rows of the
                                        // warpgroup's 64: rq, rq + 8
  const float c = sm_scale * kLog2e;
  T* ow = os + wg * kBf16WgRows * 64;  // the warpgroup's O rows, within
                                          // each 64-column block
  int c0 = 0;   // key tiles of the block's earlier items

  for (int it = blockIdx.x, n = 0; it < items; it += gridDim.x, ++n) {
    const Item w = item_of(it);
    const int qb = n & 1;
    const int qw0 = w.q0 + kBf16WgRows * wg;
    const int qr = qw0 + rq;
    const T* qw = qs + qb * ROWS * DP + wg * kBf16WgRows * 64;
    const int kend = w.kend;
    const int ntiles = w.ntiles;

    // rows qr and qr + 8: running max of the scaled scores and this
    // lane's share of the running sum; O in the accumulators' layout
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
    float a0 = 1.f, a1 = 1.f;   // the rescale of O by the pending tile
    float o[ND][4], pv[ND][4], s[NK][4];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;

    // S = Q K^T of tile i (the warpgroup's 64 rows x BK keys): a = its Q
    // rows, b = the tile's K rows, both K-major
    auto issue_s = [&](int i) {
      const T* kt = kst + ((c0 + i) % S) * BK * DP;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BK, 0, T>(
            s,
            sw128_desc(qw + (kk >> 2) * ROWS * 64 + 16 * (kk & 3), 16, 1024),
            sw128_desc(kt + (kk >> 2) * BK * 64 + 16 * (kk & 3), 16, 1024),
            kk);
    };
    auto wait_full = [&](int i) {
      mbar_wait(full + (c0 + i) % S, ((c0 + i) / S) & 1);
    };
    // the online softmax of tile i on s: p = 2^(s scale log2(e) - m
    // log2(e)) in place, (b0, b1) = the rescale of what came before;
    // masked (the finite -1e30 of the JAX package has p = 0 too) only in
    // a tile that crosses kv_len or the causal diagonal
    auto softmax = [&](int i, float& b0, float& b1) {
      const int k0 = i * BK;
      auto body = [&](auto masked) {
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + 8 * j + 2 * t + (e & 1);
              const int qi = qr + ((e & 2) ? 8 : 0);
              if (!(kj < kend && (!causal || kj <= qi)))
                s[j][e] = -CUDART_INF_F;
            }
        }
        float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        const float n0 = fmaxf(m0, quad_max(mx0) * sm_scale);
        const float n1 = fmaxf(m1, quad_max(mx1) * sm_scale);
        b0 = exp2_approx((m0 - n0) * kLog2e);
        b1 = exp2_approx((m1 - n1) * kLog2e);
        m0 = n0;
        m1 = n1;
        const float ml0 = n0 * kLog2e, ml1 = n1 * kLog2e;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[j][e], c, (e & 2) ? -ml1 : -ml0));
            if constexpr (decltype(masked)::value)
              p = s[j][e] == -CUDART_INF_F ? 0.f : p;
            s[j][e] = p;
          }
          ps0 += s[j][0] + s[j][1];
          ps1 += s[j][2] + s[j][3];
        }
        l0 = l0 * b0 + ps0;
        l1 = l1 * b1 + ps1;
      };
      if (k0 + BK > kend || (causal && k0 + BK - 1 > qw0))
        body(std::true_type{});
      else
        body(std::false_type{});
    };
    auto release = [&](uint64_t* bar) {   // the warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // one step of the walk on tile i: P V of tile i and, with `next`, S
    // of tile i + 1 issued before it, so the softmax of the next tile
    // runs while P V of this one is on the tensor cores (and, in a
    // 128-row block, while the other warpgroup's products are). Each
    // product has a fence and a group of its own, issued unconditionally
    // inside the step and retired before it ends: ptxas serializes every
    // wgmma of a kernel where accumulators of a product in flight merge
    // across a branch
    auto step = [&](int i, auto next) {
      constexpr bool kNext = decltype(next)::value;
      // P of tile i rounded to T as the a of P V, 16 keys a k step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        c_to_a<T>(s[2 * kk], s[2 * kk + 1], pa[kk]);
      if constexpr (kNext) wait_full(i + 1);
      if (RW == 2) turn_wait(wg);
      if constexpr (kNext) {
        wg_fence();
        issue_s(i + 1);
        wg_commit();
      }
      // P V: a = P's columns of 16 keys, b = those keys' V rows (N-major)
      const T* vt = vst + ((c0 + i) % S) * BK * DP;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP, 1, T>(pv, pa[kk],
                        sw128_desc(vt + kk * 16 * 64, BK * 128, 1024),
                        kk > 0);
      wg_commit();
      // the second warpgroup's last pass would have no turn to meet
      if (RW == 2 && (kNext || wg == 0)) turn_pass(wg);
      float b0 = 1.f, b1 = 1.f;
      if constexpr (kNext) {
        wg_wait<1>();   // S of the next tile is in
        pin<NK>(s);
        softmax(i + 1, b0, b1);
      } else {
        release(q_empty + qb);   // every S product of the item is done
      }
      // O = O alpha + T(P) V of this tile: its product in zeroed
      // accumulators, then one fp32 fma (tile_add)
      wg_wait<0>();
      pin<ND>(pv);
      release(empty + (c0 + i) % S);
      tile_add<ND>(o, pv, a0, a1);
      a0 = b0;
      a1 = b1;
    };

    mbar_wait(q_full + qb, (n >> 1) & 1);
    if (ntiles > 0) {
      if (RW == 2 && wg == 1) turn_pass(1);   // the first turn is the
                                              // first warpgroup's
      wait_full(0);
      if (RW == 2) turn_wait(wg);
      wg_fence();
      issue_s(0);
      wg_commit();
      if (RW == 2) turn_pass(wg);
      wg_wait<0>();
      pin<NK>(s);
      softmax(0, a0, a1);
      for (int i = 0; i + 1 < ntiles; ++i) step(i, std::true_type{});
      step(ntiles - 1, std::false_type{});
    } else {
      release(q_empty + qb);
    }
    c0 += ntiles;

    // a row with every key masked has l == 0: it writes zeros
    const float d0 = fmaxf(quad_sum(l0), 1e-30f);
    const float d1 = fmaxf(quad_sum(l1), 1e-30f);
    const float r0 = 1.f / d0, r1 = 1.f / d1;
    if (vec) {
      // O through the warpgroup's staging rows in the swizzle, then one
      // TMA store a 64-column block (rows past Sq and columns past D are
      // not written); the store of the last item has read them first
      if ((tid & 127) == 0) tma_store_wait_read();
      warpgroup_sync(wg);
#pragma unroll
      for (int nn = 0; nn < ND; ++nn) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rq + 8 * half;
          const int d = 8 * nn + 2 * t;
          const float rn = half ? r1 : r0;
          *reinterpret_cast<uint32_t*>(ow + (d >> 6) * ROWS * 64 +
                                       sw_off(r, d & 63, kBf16WgRows)) =
              pack2<T>(o[nn][2 * half] * rn, o[nn][2 * half + 1] * rn);
        }
      }
      fence_async_smem();
      warpgroup_sync(wg);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb)
          tma_store_3d(&tm_o, ow + cb * ROWS * 64, 64 * cb, qw0, w.bh);
        tma_store_commit();
      }
    } else {
      const bool pair = (D & 1) == 0;
      const size_t qbase = (size_t)w.bh * Sq * D;
#pragma unroll
      for (int nn = 0; nn < ND; ++nn) {
        const int d = 8 * nn + 2 * t;
        if (d >= D) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qi = qr + 8 * half;
          const float rn = half ? r1 : r0;
          if (qi < Sq)
            store_pair(out, qbase + (size_t)qi * D + d, o[nn][2 * half] * rn,
                       o[nn][2 * half + 1] * rn, pair, d + 1 < D);
        }
      }
    }
    if (t == 0) {
      float* lr = lse + (size_t)w.bh * Sq;
      if (qr < Sq) lr[qr] = m0 + logf(d0);
      if (qr + 8 < Sq) lr[qr + 8] = m1 + logf(d1);
    }
  }
  // the stores have read shared memory before the block ends
  if (vec && (tid & 127) == 0) tma_store_wait_read();
}

template <typename T, int DP, int RW>
int launch_bf16(const T* q, const T* k, const T* v,
                const int* kv_len, T* out, float* lse, int B, int H,
                int Sq, int Sk, int D, int causal, float sm_scale, int vec,
                cudaStream_t stream) {
  constexpr int ROWS = kBf16WgRows * RW;
  constexpr int BK = fwd_bf16_bk(DP, RW);
  constexpr int NT = 128 * RW + 128;
  // TMA where rows are whole 16-byte pieces and the bases 16-byte aligned
  // (the wrapper's vec); else the producer's element copies and the
  // threads' own stores
  vec = vec && aligned16(out) && encode_tiled() != nullptr;
  CUtensorMap tm[4] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec && !(map_rows(tm + 0, ty, q, B * H, Sq, D, ROWS) &&
               map_rows(tm + 1, ty, k, B * H, Sk, D, BK) &&
               map_rows(tm + 2, ty, v, B * H, Sk, D, BK) &&
               map_rows(tm + 3, ty, out, B * H, Sq, D, kBf16WgRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = fwd_smem_bf16(DP, BK, RW);
  auto kernel = flash_fwd_bf16_kernel<T, DP, RW>;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(kernel, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as stay resident on the card, at most one an item
  static std::atomic<int> resident[64];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap = resident[dev & 63].load(std::memory_order_relaxed);
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = std::max(1, sms * per_sm);
    resident[dev & 63].store(cap, std::memory_order_relaxed);
  }
  const long long items = (long long)B * H * ((Sq + ROWS - 1) / ROWS);
  const int grid = (int)std::min<long long>(items, cap);
  kernel<<<grid, NT, smem, stream>>>(q, k, v, kv_len, out, lse, B * H, H, Sq,
                                     Sk, D, causal, sm_scale, vec, tm[0],
                                     tm[1], tm[2], tm[3]);
  return static_cast<int>(cudaGetLastError());
}

// the block shapes the plan takes: 2 x 64 rows, or 64 rows
template <typename T, int DP>
int launch_bf16_rows(const T* q, const T* k, const T* v,
                     const int* kv_len, T* out, float* lse, int B, int H,
                     int Sq, int Sk, int D, int causal, float sm_scale,
                     int BK, int rw, int ks, int vec, long long smem,
                     cudaStream_t stream) {
  if ((rw != 1 && rw != kBf16RowWgs) || ks != 1 ||
      BK != fwd_bf16_bk(DP, rw) ||
      smem != static_cast<long long>(fwd_smem_bf16(DP, BK, rw)))
    return static_cast<int>(cudaErrorInvalidValue);
  return rw == kBf16RowWgs
             ? launch_bf16<T, DP, 2>(q, k, v, kv_len, out, lse, B, H, Sq,
                                     Sk, D, causal, sm_scale, vec, stream)
             : launch_bf16<T, DP, 1>(q, k, v, kv_len, out, lse, B, H, Sq,
                                     Sk, D, causal, sm_scale, vec, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan this file would not have made: BK 32
// or 16, rw row warps (1-4) times ks key warps at most 8, smem their
// shared bytes within the card's limit.
extern "C" int mxtt_flash_fwd_f32(const float* q, const float* k,
                                  const float* v, const int* kv_len,
                                  float* out, float* lse, int B, int H,
                                  int Sq, int Sk, int D, int causal,
                                  float sm_scale, int BK, int rw, int ks,
                                  int vec, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_FWD(DP)                                                        \
  (BK == kWideBK                                                            \
       ? launch<DP, kWideBK>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D,   \
                             causal, sm_scale, rw, ks, vec, smem, st)       \
       : launch<DP, kSplitBK>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D,  \
                              causal, sm_scale, rw, ks, vec, smem, st))
  if (D <= 0 || D > 128 || (BK != kWideBK && BK != kSplitBK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_FWD(32);
  if (D <= 64) return MXTT_FWD(64);
  if (D <= 96) return MXTT_FWD(96);
  return MXTT_FWD(128);
#undef MXTT_FWD
}

// The 16-bit forms: q, k, v and out of one type T (bf16, f16), fp32 lse
// (the forward's template on T); the same arguments and return codes,
// on the plan both share (kernels.py:_flash_fwd_plan_bf16): rw consumer
// warpgroups of 64 rows (1 or 2), BK = fwd_bf16_bk(DP, rw) keys a tile,
// ks = 1, smem fwd_smem_bf16's bytes.
template <typename T>
int flash_fwd_16(const void* q, const void* k, const void* v,
                 const int* kv_len, void* out, float* lse, int B, int H,
                 int Sq, int Sk, int D, int causal, float sm_scale, int BK,
                 int rw, int ks, int vec, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  T* ob = static_cast<T*>(out);
#define MXTT_FWD_16(DP)                                                     \
  launch_bf16_rows<T, DP>(qb, kb, vb, kv_len, ob, lse, B, H, Sq, Sk, D,     \
                          causal, sm_scale, BK, rw, ks, vec, smem, st)
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return MXTT_FWD_16(64);
  return MXTT_FWD_16(128);
#undef MXTT_FWD_16
}

extern "C" int mxtt_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, float* lse, int B, int H,
                                   int Sq, int Sk, int D, int causal,
                                   float sm_scale, int BK, int rw, int ks,
                                   int vec, long long smem, void* stream) {
  return flash_fwd_16<bf16>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D,
                            causal, sm_scale, BK, rw, ks, vec, smem, stream);
}

extern "C" int mxtt_flash_fwd_f16(const void* q, const void* k,
                                  const void* v, const int* kv_len,
                                  void* out, float* lse, int B, int H,
                                  int Sq, int Sk, int D, int causal,
                                  float sm_scale, int BK, int rw, int ks,
                                  int vec, long long smem, void* stream) {
  return flash_fwd_16<f16>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D,
                           causal, sm_scale, BK, rw, ks, vec, smem, stream);
}
