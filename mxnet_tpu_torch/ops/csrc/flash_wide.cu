// Flash attention for wide heads (D > 128, any width), forward and
// backward, for Hopper (sm_90a), in fp32, bf16 and fp16.
//
// Replaces, for head widths the narrow kernels (flash_fwd.cu,
// flash_bwd.cu: D <= 128, one or two 128-byte swizzle atoms) do not take:
//   * mxnet_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (:219): out and
//     the row log-sum-exp, with an optional causal mask (kj <= qi in
//     absolute indices, the top-left mask, for any Sq and Sk) and an
//     optional per-batch key length (kj < kv_len[b]);
//   * _flash_bwd_dkv_kernel (:417): dK and dV;
//   * _flash_bwd_dq_kernel (:484): dQ.
// The Pallas kernels take any head width (`_pallas_ok` gates on the
// sequence length only), and so do these.
//
// Semantics kept from the JAX kernels: fp32 softmax and accumulation for
// every input dtype; a row with no visible key writes zeros (out) and
// gets zero gradients (p is masked itself, not left to underflow); lse =
// m + log(max(l, 1e-30)); the backward takes delta = rowsum(dO * O) in
// fp32 from its caller. In bf16 / fp16 the rounding points are the
// narrow kernels' (kernels.py:_flash_plain, _flash_bwd_plain): p is
// rounded to the input type before P V (l sums the unrounded p) and out
// is rounded once; dV takes r(p), dK takes r(r(p) (dP - delta) scale),
// dQ takes r(p (dP - delta) scale), each gradient rounded once.
//
// What bounds them on this card. At B = 2, H = 8, S = 1024, D = 256,
// causal (8.4 M live (q, k) pairs) the forward's 4 * pairs * D take
// 0.0087 ms at the bf16 tensor-core peak (989 TFLOP/s) against 0.0100
// ms of bytes, the dK/dV kernel's 8 * pairs * D 0.0174 ms and the dQ
// kernel's 6 * pairs * D 0.0130 ms; fp32 at the split-TF32 rate (495 / 3
// TFLOP/s) 0.052, 0.104 and 0.078 ms. A warp a row in fp32 FMAs (a dot
// product reduced by five dependent shuffles, 16 shared loads a pair) ran
// at 160-340x the 16-bit bound: every kernel here is on the tensor cores.
//
// bf16 / fp16 (mxtt_flash_wide_fwd_{bf16,f16},
// mxtt_flash_wide_bwd_dkv_{bf16,f16}, mxtt_flash_wide_bwd_dq_{bf16,f16}):
// the narrow 16-bit designs (flash_fwd.cu, flash_bwd.cu) generalised over
// the number of 64-column swizzle atoms, on wgmma (wgmma.cuh) fed by a
// TMA ring (tma.cuh).
// * Registers set the column split. O is 64 rows x D in fp32 a
//   warpgroup (D / 2 registers a thread), dK plus dV or dQ 64 rows x D
//   each a block, split between its two warpgroups (D / 2 and D / 4); at
//   most 256 columns (four atoms) of it stay in a block. So a block
//   writes a chunk of four atoms of the output, and wider heads split
//   their columns over the grid's z axis; each chunk's block recomputes
//   S (and dP) over the whole of D.
// * Three modes (kernels.py:flash_wide_plan), by what fits 227 KB.
//   Resident (D <= 256): a tile holds all four atoms (D zero-padded to
//   256); the forward keeps its 128 Q rows, the dK/dV kernel its 64 K and
//   V rows and the dQ kernel its 64 Q and dO rows in shared memory, and
//   one ring stage holds a key tile's K and V (a query tile's Q and dO).
//   Split (D <= 512): the same rows stay with 8 atoms; a stage holds four
//   atoms of K (the forward: two stages a key tile) or the chunk's V, or
//   two atoms of Q and dO (dK/dV) or of K and V (dQ), four stages a tile,
//   the chunk's two last, each warpgroup's half of the chunk's columns.
//   Streamed (above): nothing stays; the products over D walk it an atom
//   a stage (the forward's Q and K atom; the backward's K, Q, V and dO
//   atom), then a stage brings the chunk's V (the chunk's Q and dO, one
//   stage a warpgroup's half; the chunk's K). Streamed, the side that
//   split keeps is read again from L2 for every tile: at D = 512 the
//   streamed forward ran 0.190 ms, split 0.128. A product over more than
//   four atoms sums its slots' products in fp32 registers: the tensor
//   cores' own running sum over 128 k steps moved lse to 4.7x the plain
//   version's distance from float64 at D = 2048.
// * No producer warpgroup: thread 0 keeps the ring S - 1 stages ahead
//   (TMA; where TMA cannot go, D % 8 != 0 or a base not 16-byte aligned,
//   every thread copies element by element into the same swizzled
//   tiles), a full mbarrier a stage counting the bytes and an empty one
//   that each warp arrives on when done. The three kernels share one
//   ring (`TcRing`) and differ only in what a slot holds (`fill`).
// * Forward: two consumer warpgroups of 64 query rows (a block of 128).
//   Causal and resident, the two share 64 rows instead and walk alternate
//   key tiles, merging (m, l, O) through shared memory at the end: the
//   causal grid is one wave whose longest block (the last rows) walked
//   16 key tiles against a mean of 8.5 at S = 1024; split, it walks 8.
//   S = Q K^T is an SS wgmma m64n64k16 accumulating over D; the softmax
//   is online in one walk (ex2.approx on the accumulators, a row's
//   values in one quad of lanes), masked only in tiles that cross kv_len
//   or the diagonal; O is rescaled in registers and O += P V is an RS
//   wgmma m64n128k16 a pair of atoms, P packed from S's accumulators
//   (c_to_a), V read N-major through the transpose bit.
// * dK/dV: a block owns 64 keys and walks 64-query tiles. Warpgroup 0
//   computes S^T = K Q^T, warpgroup 1 dP^T = V dO^T, once each (SS); 0
//   writes P^T = r(exp(s scale - lse)) to shared memory as 16-bit (key,
//   query) rows, 1 reads it and writes dS^T = r(P^T (dP^T - delta)
//   scale) beside it (named barriers 1 and 2, double-buffered by the
//   tile's parity); then each warpgroup adds P^T dO and dS^T Q into its
//   own half of the chunk's dV and dK columns (SS m64n128k16, two atoms).
// * dQ: a block owns 64 queries (the heaviest causal blocks first: the
//   grid is about two waves of one block an SM, and the last rows walk 16
//   key tiles against a mean of 8.5 at S = 1024) and walks 64-key tiles.
//   Warpgroup 0 computes S = Q K^T, warpgroup 1 dP = dO V^T (SS, each
//   once); 0 hands p = exp(s scale - lse) to 1 in fp32 through shared
//   memory (p is not rounded: dQ takes r(p (dP - delta) scale)), 1 writes
//   dS = r(p (dP - delta) scale) as 16-bit (query, key) rows (named
//   barriers 1 and 2), and each warpgroup adds dS K into its own half of
//   the chunk's dQ columns (SS m64n128k16, K read N-major through the
//   transpose bit), 64 registers a thread.
// * Tiles at or past min(Sk, kv_len[b]) and, when causal, past the
//   block's last row (before its first key) are never loaded; a dK/dV
//   block whose keys all lie past kv_len writes zeros, and so does a dQ
//   row that sees no key.
// * No wgmma under a branch on anything but a warp-uniform value, and
//   every product is retired inside the step that issues it.
//
// fp32 (mxtt_flash_wide_fwd_f32, mxtt_flash_wide_bwd_dkv_f32,
// mxtt_flash_wide_bwd_dq_f32): split TF32 on mma.sync m16n8k8
// (tf32_mma.cuh, the narrow fp32 forms' arithmetic: hi * hi + hi * lo +
// lo * hi, each operand split as its fragment is loaded). wgmma's tf32
// takes both shared operands K-major, so V (and dO, Q in dK/dV, K in dQ)
// would need transposed hi and lo copies: at D = 256 a 64-row Q tile's
// alone would fill 128 KB, so shared memory decides for mma.sync. A warp
// owns 16 rows (query rows in the forward and dQ, keys in dK/dV) and a
// block 64; D streams through shared memory in pieces of 64 columns
// (cp.async; the forward's Q rows stay whole to D = 320), each piece's
// products in zeroed accumulators summed in fp32, and the output's
// columns split into chunks of 128 over the grid's z axis (O, dK plus
// dV, or dQ in registers: 64 or 128 a thread). The forward walks 32-key
// tiles with the online softmax (exp2f, as the narrow fp32 form), P as
// the A fragment of the permuted contraction (c_as_a) and V's rows read
// in that order; P V goes into zeroed accumulators four column tiles at
// a time and into O by fp32 fma (tile_add). The dK/dV kernel walks
// 32-query tiles: S^T = K Q^T and dP^T = V dO^T (one after the other),
// p and dS in registers, then the tile's Q and dO rows in the chunk's
// columns for dV += P^T dO and dK += dS^T Q, likewise. The dQ kernel
// walks 32-key tiles: S = Q K^T and dP = dO V^T (interleaved, mma3x2), p
// and dS in registers, then the tile's K rows in the chunk's columns for
// dQ += dS K, likewise (the heaviest causal blocks first).
//
// Layout: q (B, H, Sq, D), k / v (B, H, Sk, D), out / dq (like q), dk /
// dv (like k), all contiguous in one type; lse / delta (B*H, Sq) fp32;
// kv_len (B,) int32 or NULL. Each entry recomputes the launch plan
// (chunks, stages, shared bytes) and returns cudaErrorInvalidValue for
// one that disagrees, else cudaGetLastError() after its launch (0 =
// launched). No atomics: two launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

constexpr float kMasked = -1e30f;  // the JAX package's mask
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 227 * 1024;  // dynamic shared bytes a block

// chunks of `width` output columns over D
__host__ __device__ constexpr int chunks_of(int D, int width) {
  return (D + width - 1) / width;
}

// ---------------------------------------------------------------------------
// the fp32 forward and dK/dV kernels: split TF32 on mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

constexpr int kF32Warps = 4;    // warps a block, 16 rows (keys) each
constexpr int kF32BK = 32;      // keys of a forward tile
constexpr int kF32BQ = 32;      // queries of a dK/dV tile
constexpr int kF32PW = 64;      // columns of a piece of D
constexpr int kF32DC = 128;     // output columns of a chunk
constexpr int kF32PP = pitch_of(kF32PW);   // a piece's shared row
constexpr int kF32CP = pitch_of(kF32DC);   // a chunk's shared row
constexpr int kF32Rows = 16 * kF32Warps;   // query rows (keys) a block

// the forward keeps its Q rows (D padded to pieces) in shared memory to
// D = 320, where two blocks still fit an SM's shared memory (at D = 512
// one block an SM ran 1.2x slower than copying Q a piece at a time)
constexpr int kF32QResMaxD = 320;
__host__ __device__ constexpr bool f32_qres(int D) {
  return D <= kF32QResMaxD;
}
// shared bytes: the forward the block's Q rows (to kF32QResMaxD, else a
// piece of them), a piece of a key tile's K rows and the tile's V rows in
// the chunk's columns; the dK/dV kernel a piece of the block's K and V
// rows and of a query tile's Q and dO rows (the chunk's Q and dO rows
// reuse K's and V's)
__host__ __device__ constexpr int f32_qpitch(int D) {
  return f32_qres(D) ? pitch_of(kF32PW * ((D + kF32PW - 1) / kF32PW))
                     : kF32PP;
}
__host__ __device__ constexpr size_t f32_fwd_smem(int D) {
  return sizeof(float) * ((size_t)kF32Rows * f32_qpitch(D) +
                          (size_t)kF32BK * kF32PP + (size_t)kF32BK * kF32CP);
}
static_assert(2 * (f32_fwd_smem(kF32QResMaxD) + 1024) <= 228 * 1024,
              "two fp32 forward blocks with resident Q rows exceed an "
              "SM's 228 KB");
__host__ __device__ constexpr size_t f32_dkv_smem() {
  return sizeof(float) * (size_t)2 * (kF32Rows + kF32BQ) * kF32PP;
}
static_assert(kF32BQ * kF32CP <= kF32Rows * kF32PP,
              "a chunk's Q / dO rows fit a piece's K / V buffer");
// the dQ kernel: a piece of the block's Q and dO rows and of a key
// tile's K and V rows (the chunk's K rows reuse Q's)
__host__ __device__ constexpr size_t f32_dq_smem() {
  return sizeof(float) * (size_t)2 * (kF32Rows + kF32BK) * kF32PP;
}
static_assert(kF32BK * kF32CP <= kF32Rows * kF32PP,
              "a chunk's K rows fit a piece's Q buffer");

// rows [r0, r0 + n) x columns [c0, c0 + w) of a (limit, D) fp32 matrix
// into shared rows of `pitch` floats by cp.async, zeros past `limit` and
// past D; vec (D % 4 == 0, src 16-byte aligned; c0 and w multiples of 4)
// in 16-byte pieces
__device__ __forceinline__ void copy_cols(float* dst, int pitch,
                                          const float* src, int r0, int n,
                                          int limit, int D, int c0, int w,
                                          bool vec, int tid) {
  constexpr int NT = 32 * kF32Warps;
  if (vec) {
    const int per_row = w / 4;
    for (int idx = tid; idx < n * per_row; idx += NT) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 4;
      const bool ok = r0 + r < limit && c0 + c < D;
      cp_async16(dst + r * pitch + c,
                 ok ? src + (size_t)(r0 + r) * D + c0 + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < n * w; idx += NT) {
      const int r = idx / w;
      const int c = idx - r * w;
      const bool ok = r0 + r < limit && c0 + c < D;
      cp_async4(dst + r * pitch + c,
                ok ? src + (size_t)(r0 + r) * D + c0 + c : src, ok);
    }
  }
}

// grid (B*H, ceil(Sq / 64), chunks of 128 columns), 128 threads: warp w
// owns rows q0 + 16 w .. + 15 (the heaviest causal blocks first) and the
// chunk's columns of their O
template <bool QRES>
__global__ void __launch_bounds__(32 * kF32Warps)
    wide_fwd_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, float* __restrict__ lse,
                        int H, int Sq, int Sk, int D, int causal,
                        float sm_scale, int vec) {
  constexpr int NC = kF32DC / 8;   // 8-column tiles of O
  constexpr int KT = kF32BK / 8;   // 8-key tiles of S
  constexpr int PP = kF32PP, CP = kF32CP;
  const int QP = f32_qpitch(D);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kF32Rows x QP
  float* ks = qs + kF32Rows * QP;      // kF32BK x PP
  float* vs = ks + kF32BK * PP;        // kF32BK x CP
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int c0 = blockIdx.z * kF32DC;
  const int qw0 = q0 + 16 * warp;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  const int kstop = causal ? min(kend, q0 + kF32Rows) : kend;
  const float* qw = qs + 16 * warp * QP;
  if constexpr (QRES) {
    // the block's Q rows once, D padded to whole pieces with zeros
    copy_cols(qs, QP, qb, q0, kF32Rows, Sq, D, 0, QP - 4, vec, tid);
    cp_commit();
  }

  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float o[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = 0; k0 < kstop; k0 += kF32BK) {
    // S = Q K^T over D, a piece at a time: each piece's product in zeroed
    // accumulators, summed in fp32 (a long contraction's running sum in
    // the tensor cores drifts)
    float s[KT][4];
    for (int p0 = 0; p0 < D; p0 += kF32PW) {
      __syncthreads();
      if constexpr (!QRES)
        copy_cols(qs, PP, qb, q0, kF32Rows, Sq, D, p0, kF32PW, vec, tid);
      copy_cols(ks, PP, kb, k0, kF32BK, Sk, D, p0, kF32PW, vec, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      float sp[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
      const int qc = QRES ? p0 : 0;   // the piece's first column in qs
#pragma unroll
      for (int kk = 0; kk < kF32PW / 8; ++kk) {
        uint32_t ah[4], al[4], bh_[KT][2], bl_[KT][2];
        load_a(qw, QP, qc + 8 * kk, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < KT; ++j)
          load_b_rows(ks + 8 * j * PP + 8 * kk, PP, g, t, bh_[j], bl_[j]);
        mma3x1<KT>(sp, ah, al, bh_, bl_);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p0 > 0 ? s[j][e] + sp[j][e] : sp[j][e];
    }
    // scale; mask only a tile that straddles kv_len or the diagonal
    const bool edge = k0 + kF32BK > kend || (causal && k0 + kF32BK - 1 > qw0);
    unsigned keep = ~0u;   // bit 4j + e: entry (j, e) is visible
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sm_scale;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = qw0 + g + ((e & 2) ? 8 : 0);
          if (!(kj < kend && (!causal || kj <= qi))) {
            s[j][e] = kMasked;
            keep &= ~(1u << (4 * j + e));
          }
        }
      }
    }
    // the online softmax; a masked entry's p is 0 whatever the row's
    // running max
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
    // the tile's V rows in the chunk's columns
    __syncthreads();
    copy_cols(vs, CP, vb, k0, kF32BK, Sk, D, c0, kF32DC, vec, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // O = O a + P V: each group of four column tiles' product in zeroed
    // accumulators, added in fp32 (tile_add); P as the A fragment of the
    // permuted contraction, V's rows read in that order
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += 4) {
      if (c0 + 8 * n0 >= D) break;
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t ph[4], pl[4], bh_[4][2], bl_[4][2];
        c_as_a(s[j], ph, pl);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_b_perm(vs + 8 * j * CP + 8 * (n0 + i), CP, g, t, bh_[i],
                      bl_[i]);
        mma3x1<4>(pv, ph, pl, bh_, bl_);
      }
      tile_add<4>(o + n0, pv, a0, a1);
    }
  }

  cp_wait<0>();   // (the Q copy, where no key tile ran)
  // a row with every key masked has l == 0: it writes zeros
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  const size_t qbase = (size_t)bh * Sq * D;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qw0 + g + ((e & 2) ? 8 : 0);
      const int d = c0 + 8 * n + 2 * t + (e & 1);
      if (qi < Sq && d < D)
        out[qbase + (size_t)qi * D + d] = o[n][e] / ((e & 2) ? d1 : d0);
    }
  }
  if (t == 0 && blockIdx.z == 0) {
    if (qw0 + g < Sq) lse[(size_t)bh * Sq + qw0 + g] = m0 + logf(d0);
    if (qw0 + g + 8 < Sq) lse[(size_t)bh * Sq + qw0 + g + 8] = m1 + logf(d1);
  }
}

// dK/dV: grid (B*H, ceil(Sk / 64), chunks of 128 columns), 128 threads:
// warp w owns keys k0 + 16 w .. + 15 and the chunk's columns of their dK
// and dV
__global__ void __launch_bounds__(32 * kF32Warps)
    wide_dkv_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_len,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int Sq, int Sk, int D, int causal,
                        float sm_scale, int vec) {
  constexpr int NC = kF32DC / 8;   // 8-column tiles of dK and dV
  constexpr int QT = kF32BQ / 8;   // 8-query tiles of S^T and dP^T
  constexpr int PP = kF32PP, CP = kF32CP;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // kF32Rows x PP (the chunk's Q)
  float* vs = ks + kF32Rows * PP;      // kF32Rows x PP (the chunk's dO)
  float* qs = vs + kF32Rows * PP;      // kF32BQ x PP
  float* dos = qs + kF32BQ * PP;       // kF32BQ x PP
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kF32Rows;
  const int c0 = blockIdx.z * kF32DC;
  const int kw0 = k0 + 16 * warp;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const float cl = sm_scale * kLog2e;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));

  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // keys past kv_len contribute p = 0: a block of them writes zeros;
  // when causal, queries before the block's first key see none of it
  const int qstart = k0 >= kend ? Sq : (causal ? k0 : 0);
  for (int q0 = qstart; q0 < Sq; q0 += kF32BQ) {
    // S^T = K Q^T and dP^T = V dO^T over D, a piece at a time, each
    // piece's products (one after the other: dK and dV hold 128
    // registers a thread) in zeroed accumulators summed in fp32
    float st[QT][4], dpt[QT][4];
    for (int p0 = 0; p0 < D; p0 += kF32PW) {
      __syncthreads();
      copy_cols(ks, PP, k + kbase, k0, kF32Rows, Sk, D, p0, kF32PW, vec,
                tid);
      copy_cols(vs, PP, v + kbase, k0, kF32Rows, Sk, D, p0, kF32PW, vec,
                tid);
      copy_cols(qs, PP, q + qbase, q0, kF32BQ, Sq, D, p0, kF32PW, vec, tid);
      copy_cols(dos, PP, dout + qbase, q0, kF32BQ, Sq, D, p0, kF32PW, vec,
                tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      // a = K (V) rows of the warp, b = the tile's Q (dO) rows
      auto piece = [&](const float* a, const float* b, float (*acc)[4]) {
        float sp[QT][4];
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kF32PW / 8; ++kk) {
          uint32_t ah[4], al[4], bh_[QT][2], bl_[QT][2];
          load_a(a + 16 * warp * PP, PP, 8 * kk, g, t, ah, al);
#pragma unroll
          for (int j = 0; j < QT; ++j)
            load_b_rows(b + 8 * j * PP + 8 * kk, PP, g, t, bh_[j], bl_[j]);
          mma3x1<QT>(sp, ah, al, bh_, bl_);
        }
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = p0 > 0 ? acc[j][e] + sp[j][e] : sp[j][e];
      };
      piece(ks, qs, st);
      piece(vs, dos, dpt);
    }
    // lse log2(e) and delta of this thread's queries 8 j + 2 t + e
    float lq[QT][2], dl[QT][2];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        lq[j][e] = qi < Sq ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
        dl[j][e] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
      }
    // p = exp(s scale - lse) where the mask allows (qi, kj), else 0, and
    // dS = p (dP - delta) scale, in place
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kw0 + g + ((e & 2) ? 8 : 0);
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        const bool ok = qi < Sq && kj < kend && (!causal || kj <= qi);
        const float p =
            ok ? exp2f(fmaf(st[j][e], cl, -lq[j][e & 1])) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[j][e & 1]) * sm_scale;
      }
    // the tile's Q and dO rows in the chunk's columns
    __syncthreads();
    copy_cols(ks, CP, q + qbase, q0, kF32BQ, Sq, D, c0, kF32DC, vec, tid);
    copy_cols(vs, CP, dout + qbase, q0, kF32BQ, Sq, D, c0, kF32DC, vec,
              tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q, a group of four column tiles at a
    // time (dV's, then dK's: 128 registers of dK and dV stay); P^T and
    // dS^T as the A fragments of the permuted contraction over the
    // tile's queries
    // a = P^T (dS^T) of the tile, b = its dO (Q) rows; one group's
    // product in zeroed accumulators, added to acc (dV, dK) in fp32
    auto group = [&](float (*a)[4], const float* b, float (*acc)[4],
                     int n0) {
      float gs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        uint32_t ah[4], al[4], bh_[4][2], bl_[4][2];
        c_as_a(a[j], ah, al);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_b_perm(b + 8 * j * CP + 8 * (n0 + i), CP, g, t, bh_[i],
                      bl_[i]);
        mma3x1<4>(gs, ah, al, bh_, bl_);
      }
      tile_add<4>(acc + n0, gs, 1.f, 1.f);
    };
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += 4) {
      if (c0 + 8 * n0 >= D) break;
      group(st, vs, dva, n0);
      group(dpt, ks, dka, n0);
    }
  }

#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = kw0 + g + ((e & 2) ? 8 : 0);
      const int d = c0 + 8 * n + 2 * t + (e & 1);
      if (kj < Sk && d < D) {
        dk[kbase + (size_t)kj * D + d] = dka[n][e];
        dv[kbase + (size_t)kj * D + d] = dva[n][e];
      }
    }
  }
}

// dQ: grid (B*H, ceil(Sq / 64), chunks of 128 columns), 128 threads: warp
// w owns queries q0 + 16 w .. + 15 (the heaviest causal blocks first) and
// the chunk's columns of their dQ
__global__ void __launch_bounds__(32 * kF32Warps)
    wide_dq_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ kv_len,
                       float* __restrict__ dq, int H, int Sq, int Sk, int D,
                       int causal, float sm_scale, int vec) {
  constexpr int NC = kF32DC / 8;   // 8-column tiles of dQ
  constexpr int KT = kF32BK / 8;   // 8-key tiles of S and dP
  constexpr int PP = kF32PP, CP = kF32CP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kF32Rows x PP (the chunk's K)
  float* dos = qs + kF32Rows * PP;     // kF32Rows x PP
  float* ks = dos + kF32Rows * PP;     // kF32BK x PP
  float* vs = ks + kF32BK * PP;        // kF32BK x PP
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int c0 = blockIdx.z * kF32DC;
  const int qw0 = q0 + 16 * warp;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const float cl = sm_scale * kLog2e;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  // key tiles at or past kstop hold no visible key for any row
  const int kstop = causal ? min(kend, q0 + kF32Rows) : kend;
  // lse log2(e) and delta of this thread's rows qw0 + g, qw0 + g + 8
  float lq[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qw0 + g + 8 * h;
    lq[h] = qi < Sq ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
    dl[h] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
  }

  float dqa[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int k0 = 0; k0 < kstop; k0 += kF32BK) {
    // S = Q K^T and dP = dO V^T over D, a piece at a time, each piece's
    // products in zeroed accumulators summed in fp32
    float s[KT][4], dp[KT][4];
    for (int p0 = 0; p0 < D; p0 += kF32PW) {
      __syncthreads();
      copy_cols(qs, PP, q + qbase, q0, kF32Rows, Sq, D, p0, kF32PW, vec, tid);
      copy_cols(dos, PP, dout + qbase, q0, kF32Rows, Sq, D, p0, kF32PW, vec,
                tid);
      copy_cols(ks, PP, k + kbase, k0, kF32BK, Sk, D, p0, kF32PW, vec, tid);
      copy_cols(vs, PP, v + kbase, k0, kF32BK, Sk, D, p0, kF32PW, vec, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      float sp[KT][4], dpp[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = dpp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kF32PW / 8; ++kk) {
        uint32_t ah[4], al[4], eh[4], el[4];
        uint32_t bh_[KT][2], bl_[KT][2], fh[KT][2], fl[KT][2];
        load_a(qs + 16 * warp * PP, PP, 8 * kk, g, t, ah, al);
        load_a(dos + 16 * warp * PP, PP, 8 * kk, g, t, eh, el);
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          load_b_rows(ks + 8 * j * PP + 8 * kk, PP, g, t, bh_[j], bl_[j]);
          load_b_rows(vs + 8 * j * PP + 8 * kk, PP, g, t, fh[j], fl[j]);
        }
        mma3x2<KT>(sp, ah, al, bh_, bl_, dpp, eh, el, fh, fl);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = p0 > 0 ? s[j][e] + sp[j][e] : sp[j][e];
          dp[j][e] = p0 > 0 ? dp[j][e] + dpp[j][e] : dpp[j][e];
        }
    }
    // p = exp(s scale - lse) where the mask allows (qi, kj), else 0, and
    // dS = p (dP - delta) scale in place of s (fp32: no rounding)
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = qw0 + g + 8 * h;
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = qi < Sq && kj < kend && (!causal || kj <= qi);
        const float p = ok ? exp2f(fmaf(s[j][e], cl, -lq[h])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]) * sm_scale;
      }
    // the tile's K rows in the chunk's columns
    __syncthreads();
    copy_cols(qs, CP, k + kbase, k0, kF32BK, Sk, D, c0, kF32DC, vec, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // dQ += dS K, a group of four column tiles at a time: dS as the A
    // fragment of the permuted contraction over the tile's keys, K's rows
    // read in that order; each group's product in zeroed accumulators,
    // added to dQ in fp32
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += 4) {
      if (c0 + 8 * n0 >= D) break;
      float gs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t ah[4], al[4], bh_[4][2], bl_[4][2];
        c_as_a(s[j], ah, al);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_b_perm(qs + 8 * j * CP + 8 * (n0 + i), CP, g, t, bh_[i],
                      bl_[i]);
        mma3x1<4>(gs, ah, al, bh_, bl_);
      }
      tile_add<4>(dqa + n0, gs, 1.f, 1.f);
    }
  }

  // a row with no visible key gets zeros
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qw0 + g + ((e & 2) ? 8 : 0);
      const int d = c0 + 8 * n + 2 * t + (e & 1);
      if (qi < Sq && d < D) dq[qbase + (size_t)qi * D + d] = dqa[n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 / fp16 forward, dK/dV and dQ kernels on wgmma
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 256;  // two consumer warpgroups
constexpr int kTcRows = 128;     // query rows of a forward block
constexpr int kTcBK = 64;        // keys of a forward tile, of a dK/dV block
constexpr int kTcBQ = 64;        // queries of a dK/dV tile
constexpr int kTcAtoms = 4;      // atoms of a resident tile and of a chunk
constexpr int kTcMaxStages = 6;
constexpr int kTcAtomElems = 64 * 64;  // elements of a 64-row atom

// the stages a ring gets: the most, up to kTcMaxStages, whose tiles, the
// fixed buffers and the barriers (a full and an empty one a stage, and
// `extra`) fit a block's shared memory after 1024 bytes of alignment
__host__ __device__ constexpr size_t tc_smem(size_t fixed, size_t stage,
                                             int stages, int extra) {
  return 1024 + fixed + stages * stage + 8 * (2 * stages + extra);
}
__host__ __device__ constexpr int tc_stages(size_t fixed, size_t stage,
                                            int extra) {
  int s = kTcMaxStages;
  while (s > 1 && tc_smem(fixed, stage, s, extra) > kSmemLimit) --s;
  return s;
}

// the modes, by the atoms of D: resident (at most 4: every tile holds
// all of D), split (at most 8: the resident side's 8 atoms stay, the
// other side comes in pieces), streamed (above: nothing stays)
constexpr int kResident = 0, kSplit = 1, kStreamed = 2;
__host__ __device__ constexpr int tc_mode(int D) {
  return (D + 63) / 64 <= kTcAtoms       ? kResident
         : (D + 63) / 64 <= 2 * kTcAtoms ? kSplit
                                         : kStreamed;
}

// bytes of each layout (2-byte elements). Forward: resident, Q (128 rows
// x 4 atoms) fixed and a stage K and V (64 rows x 4 atoms each); split, Q
// (128 rows x 8 atoms) fixed and a stage half of K's atoms or V's chunk
// (64 rows x 4 atoms); streamed, a stage the larger of Q's and K's atom
// (128 + 64 rows) and V's chunk. One barrier more (Q's)
constexpr size_t kTile4 = 2 * kTcBK * 64 * kTcAtoms;   // 64 rows x 4 atoms
constexpr size_t kFwdResFixed = 2 * kTcRows * 64 * kTcAtoms;
constexpr size_t kFwdResStage = 2 * kTile4;
constexpr size_t kFwdSplitFixed = 2 * kFwdResFixed;
// the key split (causal, resident): Q's 64 rows x 4 atoms fixed
constexpr size_t kFwdKsFixed = kFwdResFixed / 2;
constexpr size_t kFwdStrStage =
    2 * std::max((kTcRows + kTcBK) * 64, kTcBK * 64 * kTcAtoms);
// dK/dV: two buffers each of P^T and dS^T (64 x 64) fixed in every mode;
// resident, K and V (64 rows x 4 atoms each) fixed and a stage Q and dO
// (64 rows x 4 atoms); split, K and V (64 rows x 8 atoms) fixed and a
// stage two atoms of Q and dO (64 rows each); streamed, a stage the K, Q,
// V and dO of one atom or a warpgroup's half of the chunk's Q and dO. One
// barrier more (K's and V's)
constexpr size_t kPtBytes = 2 * 2 * 2 * kTcAtomElems;
constexpr size_t kDkvResFixed = 2 * kTile4 + kPtBytes;
constexpr size_t kDkvResStage = 2 * kTile4;
constexpr size_t kDkvSplitFixed = 4 * kTile4 + kPtBytes;
constexpr size_t kDkvStrStage = 2 * 4 * kTcAtomElems;

// dQ: the p exchange (64 x 64 fp32) and dS (64 x 64) fixed in every mode;
// resident, Q and dO (64 rows x 4 atoms each) fixed and a stage a key
// tile's K and V (64 rows x 4 atoms each); split, Q and dO (64 rows x 8
// atoms) fixed and a stage two atoms of K and of V; streamed, a stage the
// Q, K, dO and V of one atom or the chunk's four atoms of K. One barrier
// more (Q's and dO's)
constexpr size_t kXpBytes = 4 * kTcAtomElems + 2 * kTcAtomElems;
constexpr size_t kDqResFixed = 2 * kTile4 + kXpBytes;
constexpr size_t kDqResStage = 2 * kTile4;
constexpr size_t kDqSplitFixed = 4 * kTile4 + kXpBytes;
constexpr size_t kDqStrStage = 2 * 4 * kTcAtomElems;

__host__ __device__ constexpr size_t tc_fwd_fixed(int mode, bool ks) {
  return ks ? kFwdKsFixed
            : mode == kResident ? kFwdResFixed
                                : mode == kSplit ? kFwdSplitFixed : 0;
}
__host__ __device__ constexpr size_t tc_fwd_stage(int mode) {
  return mode == kResident ? kFwdResStage
                           : mode == kSplit ? kTile4 : kFwdStrStage;
}
__host__ __device__ constexpr size_t tc_dkv_fixed(int mode) {
  return mode == kResident ? kDkvResFixed
                           : mode == kSplit ? kDkvSplitFixed : kPtBytes;
}
__host__ __device__ constexpr size_t tc_dkv_stage(int mode) {
  return mode == kResident ? kDkvResStage : kDkvStrStage;
}

__host__ __device__ constexpr size_t tc_dq_fixed(int mode) {
  return mode == kResident ? kDqResFixed
                           : mode == kSplit ? kDqSplitFixed : kXpBytes;
}
__host__ __device__ constexpr size_t tc_dq_stage(int mode) {
  return mode == kResident ? kDqResStage : kDqStrStage;
}

static_assert(tc_stages(kFwdResFixed, kFwdResStage, 1) >= 2 &&
                  tc_stages(kFwdKsFixed, kFwdResStage, 1) >= 2 &&
                  tc_stages(kDkvResFixed, kDkvResStage, 1) >= 2 &&
                  tc_stages(kFwdSplitFixed, kTile4, 1) >= 2 &&
                  tc_stages(kDkvSplitFixed, kDkvStrStage, 1) >= 2 &&
                  tc_stages(kDqResFixed, kDqResStage, 1) >= 2 &&
                  tc_stages(kDqSplitFixed, kDqStrStage, 1) >= 2,
              "a wide block's ring needs two stages in 227 KB");
// the split forward's three slots a key tile land in three stages, so
// K's second half always fills stage 1 (`wide_fwd_tc_kernel` zeroes its
// atoms past D once)
static_assert(tc_stages(kFwdSplitFixed, kTile4, 1) == 3,
              "the split forward needs three stages");

// named barriers over `n` threads: 1 and 2 pass P^T and dS^T between the
// dK/dV kernel's warpgroups (p and dS between the dQ kernel's), 3 + wg is
// warpgroup wg alone
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rows [r0, r0 + ROWS) x atoms [a0, a0 + NA) of a (limit, D) matrix of T
// into a swizzled tile of ROWS rows and NA atoms, element by element by
// all kTcThreads threads (where TMA cannot go); zeros past `limit` and
// past D
template <int ROWS, int NA, typename T>
__device__ __forceinline__ void copy_atoms(T* dst, const T* src, int r0,
                                           int limit, int D, int a0,
                                           int tid) {
  for (int idx = tid; idx < ROWS * 64 * NA; idx += kTcThreads) {
    const int r = idx / (64 * NA);
    const int cc = idx - r * 64 * NA;
    const int c = 64 * a0 + cc;
    dst[sw_off(r, cc, ROWS)] = r0 + r < limit && c < D
                                   ? src[(size_t)(r0 + r) * D + c]
                                   : to_t<T>(0.f);
  }
}

// the bytes of a swizzled tile's atoms [a0, a0 + NA) of ROWS rows that
// hold columns of D (atoms at or past `la` are not loaded), and their
// loads by TMA
template <int ROWS, int NA>
__device__ __forceinline__ uint32_t atom_bytes(int a0, int la) {
  return ROWS * 64 * 2 * max(0, min(NA, la - a0));
}
template <int ROWS, int NA, typename T>
__device__ __forceinline__ void tma_atoms(T* dst, const CUtensorMap* m,
                                          uint64_t* bar, int a0, int la,
                                          int row, int bh) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
    if (a0 + a < la)
      tma_load_3d(dst + a * ROWS * 64, m, bar, 64 * (a0 + a), row, bh);
}

// The wgmma kernels' TMA ring: `stages` stages of STAGE bytes behind a
// full and an empty mbarrier each. Slot c (the c-th load of a block's
// walk) lands in stage c % stages. Thread 0 (every thread, where the
// element copies fill it: `filler`) fills the slots in order through
// `fill(c)`, each once every warp is done with the slot `stages` before
// it in its stage; before slot c the ring runs stages - 1 slots ahead.
// Only `fill` differs between the kernels.
template <typename T, size_t STAGE, class Fill>
struct TcRing {
  Fill& fill;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, nslots;
  bool filler;
  int lane;
  int filled = 0;

  __device__ __forceinline__ void top_up(int upto) {
    if (!filler) return;
    for (upto = min(upto, nslots); filled < upto; ++filled) {
      if (filled >= stages)
        mbar_wait(empty + filled % stages, (filled / stages - 1) & 1);
      fill(filled);
    }
  }
  __device__ __forceinline__ void wait_full(int c) const {
    mbar_wait(full + c % stages, (c / stages) & 1);
  }
  __device__ __forceinline__ void begin(int c) {
    top_up(c + stages);
    wait_full(c);
  }
  // the warp is done with slot c
  __device__ __forceinline__ void release(int c) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % stages);
  }
  __device__ __forceinline__ T* stage_of(int c) const {
    return reinterpret_cast<T*>(ring + (c % stages) * STAGE);
  }
};

// The forward: grid (B*H, ceil(Sq / 128), chunks), 256 threads, two
// consumer warpgroups of 64 rows; block (bh, y) owns rows [q0, q0 + 128)
// with the heaviest causal blocks (the last rows) first, and the chunk
// z's four atoms of O
template <typename T, int MODE, bool KS>
__global__ void __launch_bounds__(kTcThreads, 1)
    wide_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       float* __restrict__ lse, int H, int Sq, int Sk, int D,
                       int causal, float sm_scale, int stages, int vec,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v) {
  constexpr int CA = kTcAtoms;
  constexpr int ND = CA * 8;         // 8-column tiles of O
  constexpr int NK = kTcBK / 8;      // 8-key tiles of S
  constexpr size_t STAGE = tc_fwd_stage(MODE);
  constexpr int QA = MODE == kSplit ? 2 * CA : CA;   // resident Q atoms
  // query rows a block: two warpgroups of 64, or (the key split) 64 that
  // both warpgroups share, each walking alternate key tiles
  static_assert(!KS || MODE == kResident, "the key split is resident");
  constexpr int ROWS = KS ? kTcRows / 2 : kTcRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024);
  T* qs = reinterpret_cast<T*>(base);   // ROWS rows x QA atoms
  unsigned char* ring = base + tc_fwd_fixed(MODE, KS);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint64_t* q_bar = empty + stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warp-uniform in the compiler's eyes too (a shuffle from lane 0)
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int ca0 = blockIdx.z * CA;   // the chunk's first atom
  const int la = (D + 63) / 64;      // atoms holding columns of D
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  kend = __shfl_sync(kFull, kend, 0);
  // key tiles at or past kstop hold no visible key for any row: never
  // loaded
  const int kstop = causal ? min(kend, q0 + ROWS) : kend;
  const int ntiles = (kstop + kTcBK - 1) / kTcBK;
  // ring slots a key tile: resident 1; split K's halves and V; streamed
  // Q's and K's atoms and V
  const int per_tile = MODE == kResident ? 1 : MODE == kSplit ? 3 : la + 1;
  const int nslots = ntiles * per_tile;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, vec ? 1 : kTcThreads);
      // each warp of the slot's warpgroup (the key split: of one)
      mbar_init(empty + st, kTcThreads / 32 / (KS ? 2 : 1));
    }
    mbar_init(q_bar, vec ? 1 : kTcThreads);
    mbar_init_fence();
  }
  if (MODE != kStreamed && vec && la < QA) {
    // Q's and K's atoms past D are zeros (TMA never writes them; they
    // are in S's contraction, whose products take a fixed count of k
    // steps: one that hangs on D serialises every wgmma). Split: K's
    // second half always lands in stage 1 (three slots a tile, three
    // stages)
    zero_pad_sw(qs, ROWS, 64 * la, 64 * QA, tid, kTcThreads);
    for (int st = 0; st < stages; ++st)
      if (MODE == kResident || st == 1)
        zero_pad_sw(reinterpret_cast<T*>(ring + st * STAGE), kTcBK,
                    max(0, 64 * (la - (MODE == kSplit ? CA : 0))), 64 * CA,
                    tid, kTcThreads);
    fence_async_smem();
  }
  __syncthreads();

  // slot c: key tile c / per_tile; resident, its K and V; split, slot r <
  // 2 K's atoms 4 r .. 4 r + 3; streamed, slot r < la Q's and K's atom
  // r; then the chunk's V
  auto fill = [&](int c) {
    const int st = c % stages;
    unsigned char* sb = ring + st * STAGE;
    const int i = c / per_tile;
    const int r = c - i * per_tile;
    const int k0 = i * kTcBK;
    if constexpr (MODE == kResident) {
      T* kt = reinterpret_cast<T*>(sb);
      T* vt = kt + kTcBK * 64 * CA;
      if (vec) {
        mbar_expect_tx(full + st, 2 * atom_bytes<kTcBK, CA>(0, la));
        tma_atoms<kTcBK, CA>(kt, &tm_k, full + st, 0, la, k0, bh);
        tma_atoms<kTcBK, CA>(vt, &tm_v, full + st, 0, la, k0, bh);
      } else {
        copy_atoms<kTcBK, CA>(kt, kb, k0, Sk, D, 0, tid);
        copy_atoms<kTcBK, CA>(vt, vb, k0, Sk, D, 0, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else if (MODE == kSplit && r < 2) {
      T* kt = reinterpret_cast<T*>(sb);
      if (vec) {
        mbar_expect_tx(full + st, atom_bytes<kTcBK, CA>(CA * r, la));
        tma_atoms<kTcBK, CA>(kt, &tm_k, full + st, CA * r, la, k0, bh);
      } else {
        copy_atoms<kTcBK, CA>(kt, kb, k0, Sk, D, CA * r, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else if (MODE == kStreamed && r < la) {
      T* qp = reinterpret_cast<T*>(sb);
      T* kp = qp + kTcRows * 64;
      if (vec) {
        mbar_expect_tx(full + st, (kTcRows + kTcBK) * 64 * 2);
        tma_load_3d(qp, &tm_q, full + st, 64 * r, q0, bh);
        tma_load_3d(kp, &tm_k, full + st, 64 * r, k0, bh);
      } else {
        copy_atoms<kTcRows, 1>(qp, qb, q0, Sq, D, r, tid);
        copy_atoms<kTcBK, 1>(kp, kb, k0, Sk, D, r, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else {
      T* vt = reinterpret_cast<T*>(sb);
      if (vec) {
        mbar_expect_tx(full + st, atom_bytes<kTcBK, CA>(ca0, la));
        tma_atoms<kTcBK, CA>(vt, &tm_v, full + st, ca0, la, k0, bh);
      } else {
        copy_atoms<kTcBK, CA>(vt, vb, k0, Sk, D, ca0, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    }
  };
  TcRing<T, STAGE, decltype(fill)> rg{
      fill, ring, full, empty, stages, nslots, !vec || tid == 0, lane};

  if constexpr (MODE != kStreamed) {
    if (vec) {
      if (tid == 0) {
        mbar_expect_tx(q_bar, atom_bytes<ROWS, QA>(0, la));
        tma_atoms<ROWS, QA>(qs, &tm_q, q_bar, 0, la, q0, bh);
      }
    } else {
      copy_atoms<ROWS, QA>(qs, qb, q0, Sq, D, 0, tid);
      fence_async_smem();
      mbar_arrive(q_bar);
    }
  }
  rg.top_up(stages - 1);
  if constexpr (MODE != kStreamed) mbar_wait(q_bar, 0);

  const int rq = 16 * (warp & 3) + g;   // this thread's rows of the
                                        // warpgroup's 64: rq, rq + 8
  const int qw0 = q0 + (KS ? 0 : 64 * wg);
  const int qoff = KS ? 0 : wg * kTcAtomElems;   // its rows in an atom
  const int qr = qw0 + rq;
  const float cl = sm_scale * kLog2e;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float o[ND][4], s[NK][4];
  uint32_t pa[kTcBK / 16][4];
#pragma unroll
  for (int nn = 0; nn < ND; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;

  int c = 0;   // ring slots consumed
  // the key split: warpgroup wg walks tiles wg, wg + 2, ...
  for (int i = KS ? wg : 0; i < ntiles; i += KS ? 2 : 1) {
    const int k0 = i * kTcBK;
    c = i * per_tile;
    // S = Q K^T (the warpgroup's 64 rows x 64 keys) over D: a = the Q
    // rows, b = the K rows, both K-major
    if constexpr (MODE == kResident) {
      rg.begin(c);
      const T* kt = rg.stage_of(c);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * CA; ++kk)
        wgmma_ss<64, 0, T>(
            s,
            sw128_desc(qs + (kk >> 2) * ROWS * 64 + qoff + 16 * (kk & 3), 16,
                       1024),
            sw128_desc(kt + (kk >> 2) * kTcBK * 64 + 16 * (kk & 3), 16, 1024),
            kk);
      wg_commit();
      wg_wait<0>();
      pin<NK>(s);
    } else {
      // a slot's product (split: four atoms of K against the resident
      // Q's; streamed: one atom of each) in zeroed accumulators, summed
      // in fp32 registers: the tensor cores' own running sum over a long
      // contraction drifts (at D = 2048 lse 4.7x the plain version's
      // distance from float64)
      float sa[NK][4];
      const int nsl = MODE == kSplit ? 2 : la;
      for (int a = 0; a < nsl; ++a, ++c) {
        rg.begin(c);
        const T* sp = rg.stage_of(c);
        const T* qa = MODE == kSplit ? qs + CA * a * kTcRows * 64 : sp;
        const T* ka = MODE == kSplit ? sp : sp + kTcRows * 64;
        constexpr int KSTEPS = MODE == kSplit ? 4 * CA : 4;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss<64, 0, T>(
              sa,
              sw128_desc(qa + (kk >> 2) * kTcRows * 64 + wg * kTcAtomElems +
                             16 * (kk & 3),
                         16, 1024),
              sw128_desc(ka + (kk >> 2) * kTcBK * 64 + 16 * (kk & 3), 16,
                         1024),
              kk);
        wg_commit();
        wg_wait<0>();
        pin<NK>(sa);
        rg.release(c);
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = a > 0 ? s[j][e] + sa[j][e]
                                                      : sa[j][e];
      }
    }

    // the online softmax on s: p = 2^(s scale log2(e) - m log2(e)) in
    // place, (b0, b1) the rescale of what came before; masked (p = 0)
    // only in a tile that crosses kv_len or the causal diagonal
    float b0, b1;
    auto softmax = [&](auto masked) {
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
          float p = exp2_approx(fmaf(s[j][e], cl, (e & 2) ? -ml1 : -ml0));
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
    if (k0 + kTcBK > kend || (causal && k0 + kTcBK - 1 > qw0))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    // O = O b + T(P) V: O rescaled in its registers, then the product
    // into it; a = P's columns of 16 keys, b = those keys' V rows
    // (N-major), a pair of atoms a product
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      c_to_a<T>(s[2 * kk], s[2 * kk + 1], pa[kk]);
#pragma unroll
    for (int nn = 0; nn < ND; ++nn) {
      o[nn][0] *= b0;
      o[nn][1] *= b0;
      o[nn][2] *= b1;
      o[nn][3] *= b1;
    }
    if constexpr (MODE != kResident) rg.begin(c);
    const T* vt = MODE != kResident ? rg.stage_of(c)
                                    : rg.stage_of(c) + kTcBK * 64 * CA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int a2 = 0; a2 < CA / 2; ++a2)
        wgmma_rs<128, 1, T>(
            o + 16 * a2, pa[kk],
            sw128_desc(vt + 2 * a2 * kTcBK * 64 + kk * 16 * 64, kTcBK * 128,
                       1024),
            1);
    wg_commit();
    wg_wait<0>();
    pin<ND>(o);
    rg.release(c);
    ++c;
  }
  if constexpr (KS) {
    // the key split: warpgroup 1 hands its (m, l, O) over shared memory
    // (the ring, every slot consumed) and warpgroup 0 merges them
    float* xm = reinterpret_cast<float*>(ring);
    const int lt = tid & 127;
    __syncthreads();
    if (wg == 1) {
      xm[lt] = m0;
      xm[128 + lt] = m1;
      xm[256 + lt] = l0;
      xm[384 + lt] = l1;
#pragma unroll
      for (int nn = 0; nn < ND; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) xm[512 + (4 * nn + e) * 128 + lt] = o[nn][e];
    }
    __syncthreads();
    if (wg == 1) return;
    const float p0 = xm[lt], p1 = xm[128 + lt];
    const float n0 = fmaxf(m0, p0), n1 = fmaxf(m1, p1);
    const float a0 = exp2_approx((m0 - n0) * kLog2e);
    const float a1 = exp2_approx((m1 - n1) * kLog2e);
    const float b0 = exp2_approx((p0 - n0) * kLog2e);
    const float b1 = exp2_approx((p1 - n1) * kLog2e);
    l0 = l0 * a0 + xm[256 + lt] * b0;
    l1 = l1 * a1 + xm[384 + lt] * b1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn) {
      o[nn][0] = o[nn][0] * a0 + xm[512 + (4 * nn) * 128 + lt] * b0;
      o[nn][1] = o[nn][1] * a0 + xm[512 + (4 * nn + 1) * 128 + lt] * b0;
      o[nn][2] = o[nn][2] * a1 + xm[512 + (4 * nn + 2) * 128 + lt] * b1;
      o[nn][3] = o[nn][3] * a1 + xm[512 + (4 * nn + 3) * 128 + lt] * b1;
    }
  }

  // a row with every key masked has l == 0: it writes zeros
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  const float r0 = 1.f / d0, r1 = 1.f / d1;
  const bool pair = (D & 1) == 0;
  const size_t qbase = (size_t)bh * Sq * D;
#pragma unroll
  for (int nn = 0; nn < ND; ++nn) {
    const int d = 64 * ca0 + 8 * nn + 2 * t;
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
  if (t == 0 && blockIdx.z == 0) {
    float* lr = lse + (size_t)bh * Sq;
    if (qr < Sq) lr[qr] = m0 + logf(d0);
    if (qr + 8 < Sq) lr[qr + 8] = m1 + logf(d1);
  }
}

// dK/dV: grid (B*H, ceil(Sk / 64), chunks), 256 threads; block (bh, y)
// owns keys [k0, k0 + 64) and the chunk z's four atoms of dK and dV,
// warpgroup wg the atoms 2 wg, 2 wg + 1 of it
template <typename T, int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
    wide_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ kv_len, T* __restrict__ dk,
                       T* __restrict__ dv, int H, int Sq, int Sk, int D,
                       int causal, float sm_scale, int stages, int vec,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do) {
  constexpr int CA = kTcAtoms;
  constexpr int NH = CA / 2 * 8;   // 8-column tiles of a warpgroup's half
  constexpr int NQ = kTcBQ / 8;    // 8-query tiles of S^T and dP^T
  constexpr size_t STAGE = tc_dkv_stage(MODE);
  constexpr int KA = MODE == kSplit ? 2 * CA : CA;   // resident K, V atoms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024);
  // resident and split: K and V (64 rows x KA atoms each); then P^T and
  // dS^T, two buffers each of 64 keys x 64 queries; then the ring
  T* ks = reinterpret_cast<T*>(base);
  T* vs = ks + kTcBK * 64 * KA;
  T* pts = MODE == kStreamed ? ks : vs + kTcBK * 64 * KA;
  T* dss = pts + 2 * kTcAtomElems;
  unsigned char* ring = base + tc_dkv_fixed(MODE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint64_t* kv_bar = empty + stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcBK;
  const int ca0 = blockIdx.z * CA;
  const int la = (D + 63) / 64;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int kr = 16 * (warp & 3) + g;   // this thread's keys of the
                                        // block: kr, kr + 8
  const float cl = sm_scale * kLog2e;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  kend = __shfl_sync(kFull, kend, 0);

  float dka[NH][4], dva[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  if (k0 < kend) {
    // causal: the first query tile holds query k0 (k0 is a multiple of
    // kTcBQ); queries before it see none of the block's keys
    const int qstart = causal ? k0 : 0;
    const int ntiles = qstart < Sq ? (Sq - qstart + kTcBQ - 1) / kTcBQ : 0;
    // ring slots a query tile: resident 1; split four of two atoms of Q
    // and dO each, the chunk's two last; streamed the atoms of K, Q, V
    // and dO, then the chunk's two halves
    const int per_tile =
        MODE == kResident ? 1 : MODE == kSplit ? 4 : la + 2;
    // split: slot r of a tile holds the atoms 2 p, 2 p + 1, the chunk's
    // (p = 2 z, 2 z + 1) last
    auto pair_of = [&](int r) { return (r + 2 - 2 * (int)blockIdx.z) & 3; };
    const int nslots = ntiles * per_tile;
    const T* qb = q + qbase;
    const T* db = dout + qbase;
    const T* kb = k + kbase;
    const T* vb = v + kbase;

    if (tid == 0) {
      for (int st = 0; st < stages; ++st) {
        mbar_init(full + st, vec ? 1 : kTcThreads);
        mbar_init(empty + st, kTcThreads / 32);
      }
      mbar_init(kv_bar, vec ? 1 : kTcThreads);
      mbar_init_fence();
    }
    if (MODE != kStreamed && vec && la < KA) {
      // resident atoms past D are zeros (TMA never writes them; they are
      // in S^T's and dP^T's contraction, whose products take a fixed
      // count of k steps: one that hangs on D serialises every wgmma)
      zero_pad_sw(ks, kTcBK, 64 * la, 64 * KA, tid, kTcThreads);
      zero_pad_sw(vs, kTcBK, 64 * la, 64 * KA, tid, kTcThreads);
      if constexpr (MODE == kResident) {
        for (int st = 0; st < stages; ++st) {
          T* qt = reinterpret_cast<T*>(ring + st * STAGE);
          zero_pad_sw(qt, kTcBQ, 64 * la, 64 * CA, tid, kTcThreads);
          zero_pad_sw(qt + kTcBQ * 64 * CA, kTcBQ, 64 * la, 64 * CA, tid,
                      kTcThreads);
        }
      } else {
        // split: a pair's atoms past D are never loaded, and their K /
        // V atoms are zeros; the stages start as zeros, so what they
        // hold there is always finite
        uint4* z = reinterpret_cast<uint4*>(ring);
        for (int i = tid; i < stages * (int)(STAGE / 16); i += kTcThreads)
          z[i] = make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
    }
    __syncthreads();

    // slot c: query tile c / per_tile; resident, its Q and dO; split, two
    // atoms of Q and of dO (`pair_of`); streamed, slot r < la the K, Q, V
    // and dO of atom r, then warpgroup 0's and warpgroup 1's halves of
    // the chunk's Q and dO
    auto fill = [&](int c) {
      const int st = c % stages;
      unsigned char* sb = ring + st * STAGE;
      const int i = c / per_tile;
      const int r = c - i * per_tile;
      const int q0 = qstart + i * kTcBQ;
      if constexpr (MODE == kResident) {
        T* qt = reinterpret_cast<T*>(sb);
        T* dt = qt + kTcBQ * 64 * CA;
        if (vec) {
          mbar_expect_tx(full + st, 2 * atom_bytes<kTcBQ, CA>(0, la));
          tma_atoms<kTcBQ, CA>(qt, &tm_q, full + st, 0, la, q0, bh);
          tma_atoms<kTcBQ, CA>(dt, &tm_do, full + st, 0, la, q0, bh);
        } else {
          copy_atoms<kTcBQ, CA>(qt, qb, q0, Sq, D, 0, tid);
          copy_atoms<kTcBQ, CA>(dt, db, q0, Sq, D, 0, tid);
          fence_async_smem();
          mbar_arrive(full + st);
        }
      } else if (MODE == kStreamed && r < la) {
        T* kp = reinterpret_cast<T*>(sb);
        T* qp = kp + kTcAtomElems;
        T* vp = qp + kTcAtomElems;
        T* dp = vp + kTcAtomElems;
        if (vec) {
          mbar_expect_tx(full + st, 4 * kTcAtomElems * 2);
          tma_load_3d(kp, &tm_k, full + st, 64 * r, k0, bh);
          tma_load_3d(qp, &tm_q, full + st, 64 * r, q0, bh);
          tma_load_3d(vp, &tm_v, full + st, 64 * r, k0, bh);
          tma_load_3d(dp, &tm_do, full + st, 64 * r, q0, bh);
        } else {
          copy_atoms<kTcBK, 1>(kp, kb, k0, Sk, D, r, tid);
          copy_atoms<kTcBQ, 1>(qp, qb, q0, Sq, D, r, tid);
          copy_atoms<kTcBK, 1>(vp, vb, k0, Sk, D, r, tid);
          copy_atoms<kTcBQ, 1>(dp, db, q0, Sq, D, r, tid);
          fence_async_smem();
          mbar_arrive(full + st);
        }
      } else {
        const int a0 = MODE == kSplit ? 2 * pair_of(r) : ca0 + 2 * (r - la);
        T* qh = reinterpret_cast<T*>(sb);
        T* dh = qh + 2 * kTcAtomElems;
        if (vec) {
          mbar_expect_tx(full + st, 2 * atom_bytes<kTcBQ, 2>(a0, la));
          tma_atoms<kTcBQ, 2>(qh, &tm_q, full + st, a0, la, q0, bh);
          tma_atoms<kTcBQ, 2>(dh, &tm_do, full + st, a0, la, q0, bh);
        } else {
          copy_atoms<kTcBQ, 2>(qh, qb, q0, Sq, D, a0, tid);
          copy_atoms<kTcBQ, 2>(dh, db, q0, Sq, D, a0, tid);
          fence_async_smem();
          mbar_arrive(full + st);
        }
      }
    };
    TcRing<T, STAGE, decltype(fill)> rg{
        fill, ring, full, empty, stages, nslots, !vec || tid == 0, lane};

    if constexpr (MODE != kStreamed) {
      if (vec) {
        if (tid == 0) {
          mbar_expect_tx(kv_bar, 2 * atom_bytes<kTcBK, KA>(0, la));
          tma_atoms<kTcBK, KA>(ks, &tm_k, kv_bar, 0, la, k0, bh);
          tma_atoms<kTcBK, KA>(vs, &tm_v, kv_bar, 0, la, k0, bh);
        }
      } else {
        copy_atoms<kTcBK, KA>(ks, kb, k0, Sk, D, 0, tid);
        copy_atoms<kTcBK, KA>(vs, vb, k0, Sk, D, 0, tid);
        fence_async_smem();
        mbar_arrive(kv_bar);
      }
    }
    rg.top_up(stages - 1);
    if constexpr (MODE != kStreamed) mbar_wait(kv_bar, 0);

    int c = 0;
    for (int i = 0; i < ntiles; ++i) {
      const int q0 = qstart + i * kTcBQ;
      // this thread's 16 queries of the tile: lse log2(e) (warpgroup 0)
      // or delta (warpgroup 1)
      float lv[NQ][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + 2 * t + e;
          lv[j][e] = qi < Sq ? (wg == 0 ? lse[(size_t)bh * Sq + qi] * kLog2e
                                        : delta[(size_t)bh * Sq + qi])
                             : 0.f;
        }
      // x = S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), the
      // block's 64 keys x the tile's 64 queries over D, both K-major
      float x[NQ][4];
      if constexpr (MODE == kResident) {
        rg.begin(c);
        const T* qt = rg.stage_of(c);
        const T* at = wg == 0 ? ks : vs;
        const T* bt = wg == 0 ? qt : qt + kTcBQ * 64 * CA;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * CA; ++kk)
          wgmma_ss<64, 0, T>(
              x,
              sw128_desc(at + (kk >> 2) * kTcBK * 64 + 16 * (kk & 3), 16,
                         1024),
              sw128_desc(bt + (kk >> 2) * kTcBQ * 64 + 16 * (kk & 3), 16,
                         1024),
              kk);
        wg_commit();
        wg_wait<0>();
        pin<NQ>(x);
      } else if constexpr (MODE == kSplit) {
        // the four slots' products (two atoms of the resident K or V
        // against the slot's Q or dO) in zeroed accumulators, summed in
        // fp32 registers; the chunk's two slots stay until dV and dK have
        // read them (so the last is not topped up past: the refill would
        // wait on them)
        float xa[NQ][4];
        for (int r = 0; r < 4; ++r) {
          if (r < 3)
            rg.begin(c + r);
          else
            rg.wait_full(c + r);
          const int p = pair_of(r);
          const T* at = (wg == 0 ? ks : vs) + 2 * p * kTcAtomElems;
          const T* bt = rg.stage_of(c + r) + 2 * wg * kTcAtomElems;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_ss<64, 0, T>(
                xa,
                sw128_desc(at + (kk >> 2) * kTcAtomElems + 16 * (kk & 3), 16,
                           1024),
                sw128_desc(bt + (kk >> 2) * kTcAtomElems + 16 * (kk & 3), 16,
                           1024),
                kk);
          wg_commit();
          wg_wait<0>();
          pin<NQ>(xa);
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[j][e] = r > 0 ? x[j][e] + xa[j][e] : xa[j][e];
          if (r < 2) rg.release(c + r);
        }
        c += 2;   // at the chunk's slots
      } else {
        // an atom's product in zeroed accumulators, summed in fp32
        // registers (as the forward's S)
        float xa[NQ][4];
        for (int a = 0; a < la; ++a, ++c) {
          rg.begin(c);
          const T* kp = rg.stage_of(c);
          const T* at = kp + 2 * wg * kTcAtomElems;        // K or V
          const T* bt = kp + (2 * wg + 1) * kTcAtomElems;  // Q or dO
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64, 0, T>(xa, sw128_desc(at + 16 * kk, 16, 1024),
                               sw128_desc(bt + 16 * kk, 16, 1024), kk);
          wg_commit();
          wg_wait<0>();
          pin<NQ>(xa);
          rg.release(c);
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[j][e] = a > 0 ? x[j][e] + xa[j][e] : xa[j][e];
        }
      }

      T* pt = pts + (i & 1) * kTcAtomElems;
      T* dt = dss + (i & 1) * kTcAtomElems;
      if (wg == 0) {
        // P^T = r(p), p = exp(s scale - lse) where the mask allows (qi,
        // kj), else 0, into pt as (key, query) rows
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kj = k0 + kr + 8 * h;
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qi = q0 + 8 * j + 2 * t + e;
              const bool ok = qi < Sq && kj < kend && (!causal || kj <= qi);
              p[e] = ok ? exp2_approx(fmaf(x[j][2 * h + e], cl, -lv[j][e]))
                        : 0.f;
            }
            *reinterpret_cast<uint32_t*>(pt + sw_off(kr + 8 * h,
                                                     8 * j + 2 * t, 64)) =
                pack2<T>(p[0], p[1]);
          }
        fence_async_smem();
        named_arrive(1, kTcThreads);   // P^T is in
        named_sync(2, kTcThreads);     // dS^T is in
      } else {
        named_sync(1, kTcThreads);
        // dS^T = r(r(p) (dP^T - delta) scale), into dt likewise
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = sw_off(kr + 8 * h, 8 * j + 2 * t, 64);
            const uint32_t pp = *reinterpret_cast<const uint32_t*>(pt + off);
            const T* pe = reinterpret_cast<const T*>(&pp);
            *reinterpret_cast<uint32_t*>(dt + off) = pack2<T>(
                to_f(pe[0]) * (x[j][2 * h] - lv[j][0]) * sm_scale,
                to_f(pe[1]) * (x[j][2 * h + 1] - lv[j][1]) * sm_scale);
          }
        fence_async_smem();
        named_arrive(2, kTcThreads);
        named_sync(3 + wg, 128);   // the warpgroup's dS^T is in
      }

      // dV += P^T dO and dK += dS^T Q over the warpgroup's two atoms: a =
      // P^T / dS^T (K-major, 16 queries a k step), b = the queries' dO /
      // Q rows (N-major)
      const T* qh;
      const T* dh;
      if constexpr (MODE == kResident) {
        qh = rg.stage_of(c) + 2 * wg * kTcAtomElems;
        dh = qh + kTcBQ * 64 * CA;
      } else {
        if constexpr (MODE == kStreamed) {
          // both halves' slots, the ring topped up to the first's (a
          // refill past it would wait on the halves themselves)
          rg.begin(c);
          rg.wait_full(c + 1);
        }
        qh = rg.stage_of(c + wg);
        dh = qh + 2 * kTcAtomElems;
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBQ / 16; ++kk)
        wgmma_ss<128, 1, T>(dva, sw128_desc(pt + 16 * kk, 16, 1024),
                            sw128_desc(dh + kk * 16 * 64, kTcBQ * 128, 1024),
                            1);
#pragma unroll
      for (int kk = 0; kk < kTcBQ / 16; ++kk)
        wgmma_ss<128, 1, T>(dka, sw128_desc(dt + 16 * kk, 16, 1024),
                            sw128_desc(qh + kk * 16 * 64, kTcBQ * 128, 1024),
                            1);
      wg_commit();
      wg_wait<0>();
      pin<NH>(dva);
      pin<NH>(dka);
      rg.release(c);
      ++c;
      if constexpr (MODE != kResident) {
        rg.release(c);
        ++c;
      }
    }
  }

  // keys past kv_len contribute p = 0: their rows are exactly 0
  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int d = 64 * (ca0 + 2 * wg) + 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = k0 + kr + 8 * half;
      if (kj < Sk) {
        const size_t i = kbase + (size_t)kj * D + d;
        store_pair(dk, i, dka[n][2 * half], dka[n][2 * half + 1], pair,
                   d + 1 < D);
        store_pair(dv, i, dva[n][2 * half], dva[n][2 * half + 1], pair,
                   d + 1 < D);
      }
    }
  }
}

// dQ: grid (B*H, ceil(Sq / 64), chunks), 256 threads; block (bh, y) owns
// queries [q0, q0 + 64) (the heaviest causal blocks first) and the chunk
// z's four atoms of dQ, warpgroup wg the atoms 2 wg, 2 wg + 1 of it
template <typename T, int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
    wide_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_len, T* __restrict__ dq,
                      int H, int Sq, int Sk, int D, int causal,
                      float sm_scale, int stages, int vec,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do) {
  constexpr int CA = kTcAtoms;
  constexpr int E = kTcAtomElems;
  constexpr int NH = CA / 2 * 8;   // 8-column tiles of a warpgroup's half
  constexpr int NK = kTcBK / 8;    // 8-key tiles of S and dP
  constexpr size_t STAGE = tc_dq_stage(MODE);
  constexpr int QA = MODE == kSplit ? 2 * CA : CA;   // resident Q, dO atoms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024);
  // resident and split: Q and dO (64 rows x QA atoms each); then dS (64
  // queries x 64 keys) and the p exchange (fp32); then the ring
  T* qs = reinterpret_cast<T*>(base);
  T* dos = qs + kTcBQ * 64 * QA;
  T* dss = MODE == kStreamed ? qs : dos + kTcBQ * 64 * QA;
  float* xp = reinterpret_cast<float*>(dss + E);
  unsigned char* ring = base + tc_dq_fixed(MODE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint64_t* q_bar = empty + stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lt = tid & 127;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int ca0 = blockIdx.z * CA;
  const int la = (D + 63) / 64;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int rq = 16 * (warp & 3) + g;   // this thread's queries of the
                                        // block: q0 + rq, q0 + rq + 8
  const float cl = sm_scale * kLog2e;
  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  kend = __shfl_sync(kFull, kend, 0);
  // key tiles at or past kstop hold no visible key for any row: never
  // loaded
  const int kstop = causal ? min(kend, q0 + kTcBQ) : kend;
  const int ntiles = (kstop + kTcBK - 1) / kTcBK;
  // ring slots a key tile: resident 1; split four of two atoms of K and
  // V each, the chunk's two last; streamed the atoms of Q, K, dO and V,
  // then the chunk's K
  const int per_tile = MODE == kResident ? 1 : MODE == kSplit ? 4 : la + 1;
  // split: slot r of a tile holds the atoms 2 p, 2 p + 1, the chunk's (p
  // = 2 z, 2 z + 1) last
  auto pair_of = [&](int r) { return (r + 2 - 2 * (int)blockIdx.z) & 3; };
  const int nslots = ntiles * per_tile;
  const T* qb = q + qbase;
  const T* db = dout + qbase;
  const T* kb = k + kbase;
  const T* vb = v + kbase;

  // lse log2(e) (warpgroup 0) or delta (warpgroup 1) of this thread's rows
  float lv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + rq + 8 * h;
    lv[h] = qi < Sq ? (wg == 0 ? lse[(size_t)bh * Sq + qi] * kLog2e
                               : delta[(size_t)bh * Sq + qi])
                    : 0.f;
  }

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, vec ? 1 : kTcThreads);
      mbar_init(empty + st, kTcThreads / 32);
    }
    mbar_init(q_bar, vec ? 1 : kTcThreads);
    mbar_init_fence();
  }
  if (MODE != kStreamed && vec && la < QA) {
    // resident atoms past D are zeros (TMA never writes them; they are in
    // S's and dP's contraction, whose products take a fixed count of k
    // steps: one that hangs on D serialises every wgmma)
    zero_pad_sw(qs, kTcBQ, 64 * la, 64 * QA, tid, kTcThreads);
    zero_pad_sw(dos, kTcBQ, 64 * la, 64 * QA, tid, kTcThreads);
    if constexpr (MODE == kResident) {
      for (int st = 0; st < stages; ++st) {
        T* kt = reinterpret_cast<T*>(ring + st * STAGE);
        zero_pad_sw(kt, kTcBK, 64 * la, 64 * CA, tid, kTcThreads);
        zero_pad_sw(kt + kTcBK * 64 * CA, kTcBK, 64 * la, 64 * CA, tid,
                    kTcThreads);
      }
    } else {
      // split: a pair's atoms past D are never loaded, and their Q / dO
      // atoms are zeros; the stages start as zeros, so what they hold
      // there is always finite
      uint4* z = reinterpret_cast<uint4*>(ring);
      for (int i = tid; i < stages * (int)(STAGE / 16); i += kTcThreads)
        z[i] = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();

  // slot c: key tile c / per_tile; resident, its K and V; split, two
  // atoms of K and of V (`pair_of`); streamed, slot r < la the Q, K, dO
  // and V of atom r, then the chunk's four atoms of K
  auto fill = [&](int c) {
    const int st = c % stages;
    unsigned char* sb = ring + st * STAGE;
    const int i = c / per_tile;
    const int r = c - i * per_tile;
    const int k0 = i * kTcBK;
    if constexpr (MODE == kResident) {
      T* kt = reinterpret_cast<T*>(sb);
      T* vt = kt + kTcBK * 64 * CA;
      if (vec) {
        mbar_expect_tx(full + st, 2 * atom_bytes<kTcBK, CA>(0, la));
        tma_atoms<kTcBK, CA>(kt, &tm_k, full + st, 0, la, k0, bh);
        tma_atoms<kTcBK, CA>(vt, &tm_v, full + st, 0, la, k0, bh);
      } else {
        copy_atoms<kTcBK, CA>(kt, kb, k0, Sk, D, 0, tid);
        copy_atoms<kTcBK, CA>(vt, vb, k0, Sk, D, 0, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else if (MODE == kSplit) {
      const int a0 = 2 * pair_of(r);
      T* kp = reinterpret_cast<T*>(sb);
      T* vp = kp + 2 * E;
      if (vec) {
        mbar_expect_tx(full + st, 2 * atom_bytes<kTcBK, 2>(a0, la));
        tma_atoms<kTcBK, 2>(kp, &tm_k, full + st, a0, la, k0, bh);
        tma_atoms<kTcBK, 2>(vp, &tm_v, full + st, a0, la, k0, bh);
      } else {
        copy_atoms<kTcBK, 2>(kp, kb, k0, Sk, D, a0, tid);
        copy_atoms<kTcBK, 2>(vp, vb, k0, Sk, D, a0, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else if (r < la) {
      T* qp = reinterpret_cast<T*>(sb);
      T* kp = qp + E;
      T* dp = kp + E;
      T* vp = dp + E;
      if (vec) {
        mbar_expect_tx(full + st, 4 * E * 2);
        tma_load_3d(qp, &tm_q, full + st, 64 * r, q0, bh);
        tma_load_3d(kp, &tm_k, full + st, 64 * r, k0, bh);
        tma_load_3d(dp, &tm_do, full + st, 64 * r, q0, bh);
        tma_load_3d(vp, &tm_v, full + st, 64 * r, k0, bh);
      } else {
        copy_atoms<kTcBQ, 1>(qp, qb, q0, Sq, D, r, tid);
        copy_atoms<kTcBK, 1>(kp, kb, k0, Sk, D, r, tid);
        copy_atoms<kTcBQ, 1>(dp, db, q0, Sq, D, r, tid);
        copy_atoms<kTcBK, 1>(vp, vb, k0, Sk, D, r, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    } else {
      T* kt = reinterpret_cast<T*>(sb);
      if (vec) {
        mbar_expect_tx(full + st, atom_bytes<kTcBK, CA>(ca0, la));
        tma_atoms<kTcBK, CA>(kt, &tm_k, full + st, ca0, la, k0, bh);
      } else {
        copy_atoms<kTcBK, CA>(kt, kb, k0, Sk, D, ca0, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    }
  };
  TcRing<T, STAGE, decltype(fill)> rg{
      fill, ring, full, empty, stages, nslots, !vec || tid == 0, lane};

  if constexpr (MODE != kStreamed) {
    if (vec) {
      if (tid == 0) {
        mbar_expect_tx(q_bar, 2 * atom_bytes<kTcBQ, QA>(0, la));
        tma_atoms<kTcBQ, QA>(qs, &tm_q, q_bar, 0, la, q0, bh);
        tma_atoms<kTcBQ, QA>(dos, &tm_do, q_bar, 0, la, q0, bh);
      }
    } else {
      copy_atoms<kTcBQ, QA>(qs, qb, q0, Sq, D, 0, tid);
      copy_atoms<kTcBQ, QA>(dos, db, q0, Sq, D, 0, tid);
      fence_async_smem();
      mbar_arrive(q_bar);
    }
  }
  rg.top_up(stages - 1);
  if constexpr (MODE != kStreamed) mbar_wait(q_bar, 0);

  float dqa[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int c = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int k0 = i * kTcBK;
    // x = S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), the
    // block's 64 queries x the tile's 64 keys over D, both K-major
    float x[NK][4];
    if constexpr (MODE == kResident) {
      rg.begin(c);
      const T* kt = rg.stage_of(c);
      const T* at = wg == 0 ? qs : dos;
      const T* bt = wg == 0 ? kt : kt + kTcBK * 64 * CA;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * CA; ++kk)
        wgmma_ss<64, 0, T>(
            x, sw128_desc(at + (kk >> 2) * E + 16 * (kk & 3), 16, 1024),
            sw128_desc(bt + (kk >> 2) * E + 16 * (kk & 3), 16, 1024), kk);
      wg_commit();
      wg_wait<0>();
      pin<NK>(x);
    } else if constexpr (MODE == kSplit) {
      // the four slots' products (two atoms of the resident Q or dO
      // against the slot's K or V) in zeroed accumulators, summed in fp32
      // registers; the chunk's two slots stay until dQ has read them (so
      // the last is not topped up past: the refill would wait on them)
      float xa[NK][4];
      for (int r = 0; r < 4; ++r) {
        if (r < 3)
          rg.begin(c + r);
        else
          rg.wait_full(c + r);
        const int p = pair_of(r);
        const T* at = (wg == 0 ? qs : dos) + 2 * p * E;
        const T* bt = rg.stage_of(c + r) + 2 * wg * E;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss<64, 0, T>(
              xa, sw128_desc(at + (kk >> 2) * E + 16 * (kk & 3), 16, 1024),
              sw128_desc(bt + (kk >> 2) * E + 16 * (kk & 3), 16, 1024), kk);
        wg_commit();
        wg_wait<0>();
        pin<NK>(xa);
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = r > 0 ? x[j][e] + xa[j][e] : xa[j][e];
        if (r < 2) rg.release(c + r);
      }
      c += 2;   // at the chunk's slots
    } else {
      // an atom's product in zeroed accumulators, summed in fp32
      // registers (as the forward's S)
      float xa[NK][4];
      for (int a = 0; a < la; ++a, ++c) {
        rg.begin(c);
        const T* at = rg.stage_of(c) + 2 * wg * E;   // Q or dO
        const T* bt = at + E;                      // K or V
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64, 0, T>(xa, sw128_desc(at + 16 * kk, 16, 1024),
                             sw128_desc(bt + 16 * kk, 16, 1024), kk);
        wg_commit();
        wg_wait<0>();
        pin<NK>(xa);
        rg.release(c);
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = a > 0 ? x[j][e] + xa[j][e] : xa[j][e];
      }
    }

    if (wg == 0) {
      // p = exp(s scale - lse) where the mask allows (qi, kj), else 0, in
      // fp32 (not rounded) to warpgroup 1, entry (j, e) of thread lt at
      // xp[4 (128 j + lt) + e]; masked only in a tile that crosses an edge
      auto p_of = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2_approx(fmaf(x[j][e], cl, -lv[e >> 1]));
            if constexpr (decltype(masked)::value) {
              const int qi = q0 + rq + ((e & 2) ? 8 : 0);
              const int kj = k0 + 8 * j + 2 * t + (e & 1);
              if (!(qi < Sq && kj < kend && (!causal || kj <= qi)))
                p[e] = 0.f;
            }
          }
          reinterpret_cast<float4*>(xp)[128 * j + lt] =
              make_float4(p[0], p[1], p[2], p[3]);
        }
      };
      if ((causal && k0 + kTcBK - 1 > q0) || k0 + kTcBK > kend ||
          q0 + kTcBQ > Sq)
        p_of(std::true_type{});
      else
        p_of(std::false_type{});
      named_arrive(1, kTcThreads);   // p is in
      named_sync(2, kTcThreads);     // dS is in
    } else {
      named_sync(1, kTcThreads);
      // dS = r(p (dP - delta) scale) into dss as (query, key) rows
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float4 p = reinterpret_cast<const float4*>(xp)[128 * j + lt];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              dss + sw_off(rq + 8 * h, 8 * j + 2 * t, 64)) =
              pack2<T>((h ? p.z : p.x) * (x[j][2 * h] - lv[h]) * sm_scale,
                       (h ? p.w : p.y) * (x[j][2 * h + 1] - lv[h]) *
                           sm_scale);
      }
      fence_async_smem();
      named_arrive(2, kTcThreads);
      named_sync(3 + wg, 128);   // the warpgroup's dS is in
    }

    // dQ += dS K over the warpgroup's two atoms: a = dS (K-major, 16 keys
    // a k step), b = the keys' K rows in the chunk's columns (N-major)
    const T* kh;
    if constexpr (MODE == kResident) {
      kh = rg.stage_of(c) + 2 * wg * E;
    } else if constexpr (MODE == kSplit) {
      kh = rg.stage_of(c + wg);
    } else {
      rg.begin(c);
      kh = rg.stage_of(c) + 2 * wg * E;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_ss<128, 1, T>(dqa, sw128_desc(dss + 16 * kk, 16, 1024),
                          sw128_desc(kh + kk * 16 * 64, kTcBK * 128, 1024),
                          1);
    wg_commit();
    wg_wait<0>();
    pin<NH>(dqa);
    rg.release(c);
    ++c;
    if constexpr (MODE == kSplit) {
      rg.release(c);
      ++c;
    }
  }

  // a row with no visible key gets zeros
  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int d = 64 * (ca0 + 2 * wg) + 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = q0 + rq + 8 * half;
      if (qi < Sq)
        store_pair(dq, qbase + (size_t)qi * D + d, dqa[n][2 * half],
                   dqa[n][2 * half + 1], pair, d + 1 < D);
    }
  }
}

// the wgmma kernels' plan (kernels.py:flash_wide_plan): the mode;
// chunks of four atoms; the ring's stages and shared bytes
struct TcPlan {
  int mode;
  bool ks;   // the forward's key split (causal, resident)
  int chunks, stages;
  size_t smem;
};
__host__ __device__ constexpr TcPlan tc_fwd_plan(int D, bool causal) {
  const int m = tc_mode(D);
  const bool ks = causal && m == kResident;
  const int s = tc_stages(tc_fwd_fixed(m, ks), tc_fwd_stage(m), 1);
  return TcPlan{m, ks, chunks_of(D, 64 * kTcAtoms), s,
                tc_smem(tc_fwd_fixed(m, ks), tc_fwd_stage(m), s, 1)};
}
__host__ __device__ constexpr TcPlan tc_dkv_plan(int D) {
  const int m = tc_mode(D);
  const int s = tc_stages(tc_dkv_fixed(m), tc_dkv_stage(m), 1);
  return TcPlan{m, false, chunks_of(D, 64 * kTcAtoms), s,
                tc_smem(tc_dkv_fixed(m), tc_dkv_stage(m), s, 1)};
}

__host__ __device__ constexpr TcPlan tc_dq_plan(int D) {
  const int m = tc_mode(D);
  const int s = tc_stages(tc_dq_fixed(m), tc_dq_stage(m), 1);
  return TcPlan{m, false, chunks_of(D, 64 * kTcAtoms), s,
                tc_smem(tc_dq_fixed(m), tc_dq_stage(m), s, 1)};
}

bool plan_ok(const TcPlan& p, int chunks, int stages, long long smem) {
  return p.chunks == chunks && p.stages == stages &&
         static_cast<long long>(p.smem) == smem;
}

// the TMA path: rows of whole 16-byte pieces (the wrapper's vec) and the
// tensor maps encoded; else every thread's element copies
template <typename T, int MODE, bool KS>
int launch_fwd_tc(const T* q, const T* k, const T* v, const int* kv_len,
                  T* out, float* lse, int B, int H, int Sq, int Sk, int D,
                  int causal, float sm_scale, const TcPlan& p, int vec,
                  cudaStream_t st) {
  constexpr int ROWS = KS ? kTcRows / 2 : kTcRows;
  vec = vec && encode_tiled() != nullptr;
  CUtensorMap tm[3] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec && !(map_rows(tm + 0, ty, q, B * H, Sq, D, ROWS) &&
               map_rows(tm + 1, ty, k, B * H, Sk, D, kTcBK) &&
               map_rows(tm + 2, ty, v, B * H, Sk, D, kTcBK)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wide_fwd_tc_kernel<T, MODE, KS>;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(kernel, p.smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + ROWS - 1) / ROWS, p.chunks);
  kernel<<<grid, kTcThreads, p.smem, st>>>(q, k, v, kv_len, out, lse, H, Sq,
                                           Sk, D, causal, sm_scale, p.stages,
                                           vec, tm[0], tm[1], tm[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_dkv_tc(const T* q, const T* k, const T* v, const T* dout,
                  const float* lse, const float* delta, const int* kv_len,
                  T* dk, T* dv, int B, int H, int Sq, int Sk, int D,
                  int causal, float sm_scale, const TcPlan& p, int vec,
                  cudaStream_t st) {
  vec = vec && encode_tiled() != nullptr;
  CUtensorMap tm[4] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec && !(map_rows(tm + 0, ty, q, B * H, Sq, D, kTcBQ) &&
               map_rows(tm + 1, ty, k, B * H, Sk, D, kTcBK) &&
               map_rows(tm + 2, ty, v, B * H, Sk, D, kTcBK) &&
               map_rows(tm + 3, ty, dout, B * H, Sq, D, kTcBQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wide_dkv_tc_kernel<T, MODE>;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(kernel, p.smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + kTcBK - 1) / kTcBK, p.chunks);
  kernel<<<grid, kTcThreads, p.smem, st>>>(
      q, k, v, dout, lse, delta, kv_len, dk, dv, H, Sq, Sk, D, causal,
      sm_scale, p.stages, vec, tm[0], tm[1], tm[2], tm[3]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_dq_tc(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* delta, const int* kv_len,
                 T* dq, int B, int H, int Sq, int Sk, int D, int causal,
                 float sm_scale, const TcPlan& p, int vec, cudaStream_t st) {
  vec = vec && encode_tiled() != nullptr;
  CUtensorMap tm[4] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec && !(map_rows(tm + 0, ty, q, B * H, Sq, D, kTcBQ) &&
               map_rows(tm + 1, ty, k, B * H, Sk, D, kTcBK) &&
               map_rows(tm + 2, ty, v, B * H, Sk, D, kTcBK) &&
               map_rows(tm + 3, ty, dout, B * H, Sq, D, kTcBQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wide_dq_tc_kernel<T, MODE>;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(kernel, p.smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kTcBQ - 1) / kTcBQ, p.chunks);
  kernel<<<grid, kTcThreads, p.smem, st>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale,
      p.stages, vec, tm[0], tm[1], tm[2], tm[3]);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the entries' dispatch: each recomputes its plan and refuses one that
// disagrees
// ---------------------------------------------------------------------------
template <bool QRES>
int launch_fwd_f32_as(const float* q, const float* k, const float* v,
                      const int* kv_len, float* out, float* lse, int B,
                      int H, int Sq, int Sk, int D, int causal,
                      float sm_scale, int vec, cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(wide_fwd_f32_kernel<QRES>,
                            f32_fwd_smem(QRES ? kF32QResMaxD : D), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  vec = vec && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid(B * H, (Sq + kF32Rows - 1) / kF32Rows,
                  chunks_of(D, kF32DC));
  wide_fwd_f32_kernel<QRES><<<grid, 32 * kF32Warps, f32_fwd_smem(D), st>>>(
      q, k, v, kv_len, out, lse, H, Sq, Sk, D, causal, sm_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_f32(const float* q, const float* k, const float* v,
                   const int* kv_len, float* out, float* lse, int B, int H,
                   int Sq, int Sk, int D, int causal, float sm_scale, int vec,
                   cudaStream_t st) {
  return f32_qres(D)
             ? launch_fwd_f32_as<true>(q, k, v, kv_len, out, lse, B, H, Sq,
                                       Sk, D, causal, sm_scale, vec, st)
             : launch_fwd_f32_as<false>(q, k, v, kv_len, out, lse, B, H, Sq,
                                        Sk, D, causal, sm_scale, vec, st);
}

int launch_dkv_f32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   const int* kv_len, float* dk, float* dv, int B, int H,
                   int Sq, int Sk, int D, int causal, float sm_scale, int vec,
                   cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(wide_dkv_f32_kernel, f32_dkv_smem(), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  vec = vec && aligned16(q) && aligned16(k) && aligned16(v) &&
        aligned16(dout);
  const dim3 grid(B * H, (Sk + kF32Rows - 1) / kF32Rows,
                  chunks_of(D, kF32DC));
  wide_dkv_f32_kernel<<<grid, 32 * kF32Warps, f32_dkv_smem(), st>>>(
      q, k, v, dout, lse, delta, kv_len, dk, dv, H, Sq, Sk, D, causal,
      sm_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_f32(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const int* kv_len, float* dq, int B, int H, int Sq, int Sk,
                  int D, int causal, float sm_scale, int vec,
                  cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(wide_dq_f32_kernel, f32_dq_smem(), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  vec = vec && aligned16(q) && aligned16(k) && aligned16(v) &&
        aligned16(dout);
  const dim3 grid(B * H, (Sq + kF32Rows - 1) / kF32Rows,
                  chunks_of(D, kF32DC));
  wide_dq_f32_kernel<<<grid, 32 * kF32Warps, f32_dq_smem(), st>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 kernels' plan: chunks of 128 columns, no ring (stages 0)
bool f32_ok(int D, size_t want, int chunks, int stages, long long smem) {
  return chunks == chunks_of(D, kF32DC) && stages == 0 &&
         smem == static_cast<long long>(want);
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int wide_fwd(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, float* lse, int B, int H, int Sq, int Sk, int D,
             int causal, float sm_scale, int chunks, int stages, int vec,
             long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  T* ob = static_cast<T*>(out);
  if (D <= 0) return kBad;
  if constexpr (std::is_same<T, float>::value) {
    if (!f32_ok(D, f32_fwd_smem(D), chunks, stages, smem)) return kBad;
    return launch_fwd_f32(qb, kb, vb, kv_len, ob, lse, B, H, Sq, Sk, D,
                          causal, sm_scale, vec, st);
  } else {
    const TcPlan p = tc_fwd_plan(D, causal != 0);
    if (!plan_ok(p, chunks, stages, smem)) return kBad;
#define MXTT_FWD_TC(MODE, KS)                                               \
  launch_fwd_tc<T, MODE, KS>(qb, kb, vb, kv_len, ob, lse, B, H, Sq, Sk, D,  \
                             causal, sm_scale, p, vec, st)
    return p.ks                ? MXTT_FWD_TC(kResident, true)
           : p.mode == kResident ? MXTT_FWD_TC(kResident, false)
           : p.mode == kSplit    ? MXTT_FWD_TC(kSplit, false)
                                 : MXTT_FWD_TC(kStreamed, false);
#undef MXTT_FWD_TC
  }
}

template <typename T>
int wide_dkv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const int* kv_len,
             void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
             int causal, float sm_scale, int chunks, int stages, int vec,
             long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  const T* db = static_cast<const T*>(dout);
  T* dkb = static_cast<T*>(dk);
  T* dvb = static_cast<T*>(dv);
  if (D <= 0) return kBad;
  if constexpr (std::is_same<T, float>::value) {
    if (!f32_ok(D, f32_dkv_smem(), chunks, stages, smem)) return kBad;
    return launch_dkv_f32(qb, kb, vb, db, lse, delta, kv_len, dkb, dvb, B, H,
                          Sq, Sk, D, causal, sm_scale, vec, st);
  } else {
    const TcPlan p = tc_dkv_plan(D);
    if (!plan_ok(p, chunks, stages, smem)) return kBad;
#define MXTT_DKV_TC(MODE)                                                   \
  launch_dkv_tc<T, MODE>(qb, kb, vb, db, lse, delta, kv_len, dkb, dvb, B,   \
                         H, Sq, Sk, D, causal, sm_scale, p, vec, st)
    return p.mode == kResident ? MXTT_DKV_TC(kResident)
           : p.mode == kSplit  ? MXTT_DKV_TC(kSplit)
                               : MXTT_DKV_TC(kStreamed);
#undef MXTT_DKV_TC
  }
}

template <typename T>
int wide_dq(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const int* kv_len,
            void* dq, int B, int H, int Sq, int Sk, int D, int causal,
            float sm_scale, int chunks, int stages, int vec, long long smem,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  const T* db = static_cast<const T*>(dout);
  T* dqb = static_cast<T*>(dq);
  if (D <= 0) return kBad;
  if constexpr (std::is_same<T, float>::value) {
    if (!f32_ok(D, f32_dq_smem(), chunks, stages, smem)) return kBad;
    return launch_dq_f32(qb, kb, vb, db, lse, delta, kv_len, dqb, B, H, Sq,
                         Sk, D, causal, sm_scale, vec, st);
  } else {
    const TcPlan p = tc_dq_plan(D);
    if (!plan_ok(p, chunks, stages, smem)) return kBad;
#define MXTT_DQ_TC(MODE)                                                    \
  launch_dq_tc<T, MODE>(qb, kb, vb, db, lse, delta, kv_len, dqb, B, H, Sq,  \
                        Sk, D, causal, sm_scale, p, vec, st)
    return p.mode == kResident ? MXTT_DQ_TC(kResident)
           : p.mode == kSplit  ? MXTT_DQ_TC(kSplit)
                               : MXTT_DQ_TC(kStreamed);
#undef MXTT_DQ_TC
  }
}

}  // namespace

// Each entry: the tensors, B, H, Sq, Sk, D, causal, sm_scale, then the
// plan (chunks, stages, vec, shared bytes; kernels.py:flash_wide_plan)
// and the stream.
#define MXTT_WIDE_ENTRIES(SFX, T)                                            \
  extern "C" int mxtt_flash_wide_fwd##SFX(                                   \
      const void* q, const void* k, const void* v, const int* kv_len,       \
      void* out, float* lse, int B, int H, int Sq, int Sk, int D,           \
      int causal, float sm_scale, int chunks, int stages, int vec,          \
      long long smem, void* stream) {                                        \
    return wide_fwd<T>(q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal,  \
                       sm_scale, chunks, stages, vec, smem, stream);         \
  }                                                                          \
  extern "C" int mxtt_flash_wide_bwd_dkv##SFX(                               \
      const void* q, const void* k, const void* v, const void* dout,        \
      const float* lse, const float* delta, const int* kv_len, void* dk,    \
      void* dv, int B, int H, int Sq, int Sk, int D, int causal,            \
      float sm_scale, int chunks, int stages, int vec, long long smem,      \
      void* stream) {                                                        \
    return wide_dkv<T>(q, k, v, dout, lse, delta, kv_len, dk, dv, B, H, Sq, \
                       Sk, D, causal, sm_scale, chunks, stages, vec, smem,   \
                       stream);                                              \
  }                                                                          \
  extern "C" int mxtt_flash_wide_bwd_dq##SFX(                                \
      const void* q, const void* k, const void* v, const void* dout,        \
      const float* lse, const float* delta, const int* kv_len, void* dq,    \
      int B, int H, int Sq, int Sk, int D, int causal, float sm_scale,      \
      int chunks, int stages, int vec, long long smem, void* stream) {       \
    return wide_dq<T>(q, k, v, dout, lse, delta, kv_len, dq, B, H, Sq, Sk,  \
                      D, causal, sm_scale, chunks, stages, vec, smem,        \
                      stream);                                               \
  }

MXTT_WIDE_ENTRIES(_f32, float)
MXTT_WIDE_ENTRIES(_bf16, __nv_bfloat16)
MXTT_WIDE_ENTRIES(_f16, __half)

#undef MXTT_WIDE_ENTRIES
