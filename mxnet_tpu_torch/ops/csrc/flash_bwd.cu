// Flash-attention backward, fp32, for Hopper (sm_90a): a fused dQ/dK/dV
// kernel and a dQ kernel, both on the tensor cores in split TF32.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_dkv_kernel (:417)
// and _flash_bwd_dq_kernel (:484), launched by _flash_bwd_pallas. From
// the compact (B*H, Sq) lse of the forward and delta = rowsum(dO * O),
// which the caller computes (and may shift, as flash_block_attention
// does), both recompute
//   p  = exp(s * scale - lse)     where the mask allows (qi, kj), else 0
//   dS = p * (dP - delta) * scale with s = q.k, dP = dO.v
// so nothing Sq x Sk ever reaches memory. The mask is the forward's:
// causal (kj <= qi in absolute indices, the top-left mask of
// attention_reference, for any Sq and Sk) and the per-batch key length
// (kj < kv_len[b]). p is masked explicitly rather than through
// exp(-1e30 - lse)
// underflowing, so the dK / dV rows of keys at or past kv_len[b] are
// exactly 0 and a row with no visible key contributes 0.
//
// Layout: q, dO, dQ (B, H, Sq, D); k, v, dK, dV (B, H, Sk, D); all
// contiguous fp32, any Sq and Sk, D <= 128. lse, delta (B*H, Sq) fp32.
// kv_len (B,) int32 or NULL.
//
// What bounds it on this card. chip_smoke.py counts the live (q, k) pairs
// only (a tile with none is never loaded): the bytes are q, dO, the live
// K / V rows, lse, delta and kv_len read once and dQ, dK, dV written
// once; the operations are 10 * pairs * D (S = QK^T, dP = dO V^T, dV =
// P^T dO, dK = dS^T Q, dQ = dS K). At the training shape (B*H = 256,
// S = 64, D = 64, key lengths 5-64) that is 0.0075 ms by bytes against
// 0.0020 ms of operations at the split-TF32 rate (the H100's dense TF32
// tensor-core peak, 495 TFLOP/s, over the 3 passes): the bound is bytes.
// The dQ kernel at S = 1024 (6 * pairs * D) is bound by operations at
// that rate. The SIMT pair this file replaced ran at 13x the fused bound
// (its fp32 FMAs would have had 67 TFLOP/s): its products went
// through fp32 FMAs at 10 shared loads per 8 FMAs, the two kernels
// recomputed S and dP (14 * pairs * D FLOP instead of 10) and read every
// input twice, and its loads did not overlap its arithmetic.
//
// Design:
// * Products on the tensor cores in split TF32 ("3xTF32", the arithmetic
//   of CUTLASS's OpMultiplyAddFastF32 that PyTorch's fp32 memory-efficient
//   attention uses): each fp32 operand x becomes hi = tf32(x) (cvt.rna)
//   and lo = tf32(x - hi), and each product is lo*hi + hi*lo + hi*hi
//   through mma.sync.m16n8k8 with fp32 accumulators. The dropped lo*lo
//   term is 2^-22 relative: a few times fp32's error, where one-pass
//   TF32 keeps about 3 digits. dK / dV (over the query tiles) and dQ
//   (over the key tiles) take each tile's products in zeroed
//   accumulators and add them by fp32 adds (tile_add), so their error
//   does not grow with the walk. The helpers (fragments, cp.async, the
//   ragged-edge copies) are tf32_mma.cuh's, shared with flash_fwd.cu.
// * One fused launch. A block owns BK keys of one (b, h), one warp per 16
//   keys, and walks the query tiles (BQ = 32). Each warp computes S^T and
//   dP^T for its keys (A = its K / V rows, B = the Q / dO tile), turns
//   them into P and dS in registers, and feeds them straight back as the
//   A operand of dV += P^T dO and dK += dS^T Q: the contraction over the
//   tile's queries is permuted so that the C fragment of S^T (columns 2t,
//   2t + 1) is the A fragment (columns t, t + 4), and the B rows of dO / Q
//   are read in the same permuted order. dK and dV stay in registers. K
//   and V are loaded once; the next query tile (Q, dO, lse, delta) is
//   copied with cp.async while the current one is computed (two buffers).
// * When Sk <= BK (every attention of the training step) the block owns
//   all keys of its (b, h), writes dS once to shared memory (the round
//   trip from accumulator layout to the A layout of another warp's rows)
//   and computes dQ = dS K for the tile too: the whole backward is one
//   launch doing 10 * pairs * D FLOP.
// * When Sk > BK the fused kernel skips dQ and the dQ kernel runs after
//   it: a block owns 64 queries, one warp per 16, and walks the key tiles
//   (64 keys, two cp.async buffers) with the same register-resident P /
//   dS. No block writes what another writes: no atomics, and the same
//   bits on every run.
// * Ragged edges: D is zero-padded to DP = 32, 64, 96 or 128 in shared
//   memory; rows past Sq or Sk are zero-filled by cp.async and masked in
//   p, like keys at or past kv_len. Query tiles above the diagonal (causal:
//   a fused block starts at the tile holding query k0, so Sq < Sk leaves
//   the blocks of keys at or past Sq with nothing to load, and Sq > Sk
//   walks every query tile from there) and key tiles at or past kv_len
//   are never loaded, a warp whose 16 keys hold no live pair for the tile
//   skips its products, and a block whose keys all lie at or past kv_len
//   writes zeros and stops.
// * Shared-memory rows have a pitch of DP + 4 floats (dS: BK + 4), so the
//   fragment loads (8 rows x 4 columns, or 4 rows x 8 columns in the
//   permuted order) and the dS stores hit 32 different banks; only the
//   B operand of the fused dQ (K read down its key axis) has 2-way
//   conflicts.
// The launch plan (BK, shared bytes) is kernels.py:flash_bwd_plan; each
// launch recomputes the shared bytes here and refuses a plan that
// disagrees.
//
// bfloat16 and float16 forms (mxtt_flash_bwd_bf16, mxtt_flash_bwd_dq_bf16;
// mxtt_flash_bwd_f16, mxtt_flash_bwd_dq_f16), for Hopper on wgmma: the
// same two kernels (the dK/dV kernel, writing dQ too on the fused path,
// and the dQ kernel), masks and arguments on bf16 or f16 q, k, v, dO
// (lse, delta fp32), with the JAX kernels' rounding points in the input
// type T: the dK/dV kernel (replacing _flash_bwd_dkv_kernel on bf16 and
// f16) rounds p to T and uses it for dV = P^T dO and for dS = T(p (dP -
// delta) scale) in dK = dS^T Q (pallas_kernels.py:455-461); the dQ
// kernel (replacing _flash_bwd_dq_kernel) uses p in fp32 and dS = T(p (dP
// - delta) scale) (:521-526), so where the fused path also writes dQ it
// keeps that second dS in shared memory in T. dQ, dK, dV are rounded
// once, at the end. The kernels are templates on T; the float16 form is
// the bf16 one instantiated for __half (.f32.f16.f16 products, f16 tensor
// maps, __floats2half2_rn), at the same plan, tiles and bounds (fp16 runs
// at the bf16 tensor-core rate, and both are 2 bytes). Under float16 AMP
// dO carries the loss scale: a dS or a gradient past fp16's 65504 rounds
// to inf, as in the JAX kernel, and the loss scaler skips that step.
//
// What bounds them on this card. At BERT's shape (B*H = 192, S = 512, D =
// 64, lengths 256-512, 37.7 M live (q, k) pairs) the function's least time
// is about 0.024 ms: its bytes (every input read once, every output
// written once) and its 10 * pairs * D of products at 989 TFLOP/s come out
// nearly equal. The split pair does 14 * pairs * D (dK/dV 8, dQ 6; S and
// dP are computed twice), 0.034 ms at that rate. What holds the kernels
// above it is the chain inside a warpgroup (products, then 32 exp2 a
// thread on the MUFU unit, then the next products) and, in the mma.sync
// forms they replace, 32-bit fragment loads and ldmatrix for every
// product, small 16 x 8 products between barriers and every thread
// issuing its share of each tile's copies.
//
// Design:
// * Products on wgmma (wgmma.cuh). The dK/dV kernel: a block owns BK =
//   64 or 128 keys of one (b, h), a warpgroup per 64 (two at DP = 64, one
//   at DP = 128), K and V loaded once; it walks 64-query tiles. S^T = K
//   Q^T and dP^T = V dO^T are m64n64k16 with both operands in shared
//   memory, K-major; p and dS are computed in the accumulators'
//   registers; dV += P^T dO and dK += dS^T Q take P^T and dS^T from
//   registers (two 8-column accumulator tiles packed to bf16 are the A
//   fragment of the next product, c_to_a) with dO / Q read N-major through
//   the transpose bit, so nothing is transposed in memory; dV's product
//   runs while dS is computed. The dQ kernel: a block of one warpgroup
//   owns 64 queries, Q and dO loaded once, and walks 64-key tiles up to
//   min(kv_len, the causal stop): S = Q K^T and dP = dO V^T (both
//   operands in shared memory), dS in registers, dQ += dS K with K read
//   N-major. dK, dV, dQ stay in fp32 accumulators and are written once.
// * Copies by TMA: one thread asks for a whole tile (Q, dO, K, V as boxes
//   of 64 columns in the 128-byte swizzle the products read; lse and delta
//   as a box of 68 floats from the 16-byte boundary at or below the tile's
//   first entry, since TMA reads from 16-byte boundaries and writes shared
//   memory at 128-byte ones); rows past Sq or Sk and columns past D arrive
//   as zeros. The ring (three stages at DP = 64, two at DP = 128) has a
//   full mbarrier a stage (the bytes counted) and an empty one (each warp
//   arrives when done with the tile), so the warpgroups of a block drift
//   apart rather than meeting at a barrier every tile: one's exp2 overlaps
//   the other's products. Where TMA cannot go (D % 8 != 0, or a base or
//   lse / delta not 16-byte aligned) every thread copies element by element
//   into the same layout and arrives on the full barrier instead.
//   The copies, mbarriers and tensor maps are tma.cuh's, shared with the
//   bf16 forward.
// * p = 2^(s scale log2(e) - lse log2(e)) (ex2.approx), masked only in a
//   tile that crosses an edge (the causal diagonal, kv_len, Sq); p, dS
//   and the masks are the fp32 forms' otherwise.
// * When Sk fits one block (Sk <= 128 at DP = 64, <= 64 at DP = 128) the
//   dK/dV kernel also writes dQ (one launch): each warpgroup writes its
//   keys' dQ-dS to shared memory as bf16 (query rows, K-major, swizzled),
//   and the first warpgroup computes dQ = dS K for the tile (m64nDPk16,
//   both operands in shared memory). No block writes what another writes:
//   no atomics, the same bits on every run.
// * Keys at or past kv_len contribute p = 0, so their dK / dV rows are
//   exactly 0; a block whose keys all lie there writes zeros and stops.
// The launch plan (BK, stages, shared bytes) is kernels.py:flash_bwd_plan
// in bf16; each launch recomputes the shared bytes and refuses a plan that
// disagrees.
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mxtt;

constexpr int kBQ = 32;        // query rows per tile of the fused kernel
constexpr int kMaxBK = 128;    // keys per fused block at most (8 warps)
constexpr int kDqBQ = 64;      // query rows per dQ block (4 warps)
constexpr int kDqBK = 64;      // keys per tile of the dQ kernel
constexpr int kDqThreads = 32 * kDqBQ / 16;

__host__ __device__ constexpr size_t fused_smem(int DP, int BK, int dq) {
  return sizeof(float) *
         ((size_t)2 * BK * pitch_of(DP) + (size_t)4 * kBQ * pitch_of(DP) +
          4 * kBQ + (dq ? (size_t)kBQ * (BK + 4) : 0));
}

__host__ __device__ constexpr size_t dq_smem(int DP) {
  return sizeof(float) *
         ((size_t)2 * kDqBQ * pitch_of(DP) +
          (size_t)4 * kDqBK * pitch_of(DP) + 2 * kDqBQ);
}

// the largest block of either kernel fits the card's 227 KB a block
static_assert(fused_smem(128, kMaxBK, 1) <= 227 * 1024 &&
                  dq_smem(128) <= 227 * 1024,
              "a block's shared memory exceeds 227 KB");

// ---------------------------------------------------------------------------
// fused: grid (B*H, ceil(Sk / BK)), BK / 16 warps; dK, dV and (with_dq,
// which needs Sk <= BK) dQ
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * kMaxBK / 16)
flash_bwd_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ kv_len,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, int H, int Sq, int Sk, int D,
                       int causal, float sm_scale, int BK, int with_dq,
                       int vec) {
  constexpr int NT = DP / 8;          // 8-wide column tiles of D
  constexpr int QT = kBQ / 8;         // 8-wide query tiles of a tile
  constexpr int P = pitch_of(DP);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // BK x P
  float* vs = ks + BK * P;            // BK x P
  float* qs = vs + BK * P;            // 2 x kBQ x P
  float* dos = qs + 2 * kBQ * P;      // 2 x kBQ x P
  float* lse_s = dos + 2 * kBQ * P;   // 2 x kBQ
  float* delta_s = lse_s + 2 * kBQ;   // 2 x kBQ
  float* dss = delta_s + 2 * kBQ;     // kBQ x (BK + 4), with_dq only
  const int dsp = BK + 4;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int ntd = (D + 7) / 8;        // column tiles holding real columns
  const int kw0 = k0 + 16 * warp;     // this warp's first key

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (k0 < kend) {
    zero_pad(ks, P, 2 * BK + 4 * kBQ, D, DP, tid, nthreads);
    const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
    copy_rows(ks, P, k + kbase, k0, BK, Sk, D, vec, tid, nthreads);
    copy_rows(vs, P, v + kbase, k0, BK, Sk, D, vec, tid, nthreads);
    auto load_tile = [&](int q0, int buf) {
      copy_rows(qs + buf * kBQ * P, P, q + qbase, q0, kBQ, Sq, D, vec, tid,
                nthreads);
      copy_rows(dos + buf * kBQ * P, P, dout + qbase, q0, kBQ, Sq, D, vec,
                tid, nthreads);
      copy_vec(lse_s + buf * kBQ, lse + (size_t)bh * Sq, q0, kBQ, Sq, tid,
               nthreads);
      copy_vec(delta_s + buf * kBQ, delta + (size_t)bh * Sq, q0, kBQ, Sq,
               tid, nthreads);
    };
    load_tile(qstart, 0);
    cp_commit();

    int buf = 0;
    for (int q0 = qstart; q0 < Sq; q0 += kBQ, buf ^= 1) {
      if (q0 + kBQ < Sq) {
        load_tile(q0 + kBQ, buf ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* qt = qs + buf * kBQ * P;
      const float* dot = dos + buf * kBQ * P;
      const float* lt = lse_s + buf * kBQ;
      const float* dt = delta_s + buf * kBQ;

      // a warp whose keys hold no live pair for this tile does nothing
      const bool live = kw0 < kend && !(causal && kw0 > q0 + kBQ - 1);
      if (live) {
        // S^T and dP^T of this warp's 16 keys x the tile's queries
        float s[QT][4], dp[QT][4];
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const float* kw = ks + 16 * warp * P;
        const float* vw = vs + 16 * warp * P;
        for (int kk = 0; kk < 8 * ntd; kk += 8) {
          uint32_t kh[4], kl[4], vh[4], vl[4];
          uint32_t qh[QT][2], ql[QT][2], oh[QT][2], ol[QT][2];
          load_a(kw, P, kk, g, t, kh, kl);
          load_a(vw, P, kk, g, t, vh, vl);
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            load_b_rows(qt + 8 * j * P + kk, P, g, t, qh[j], ql[j]);
            load_b_rows(dot + 8 * j * P + kk, P, g, t, oh[j], ol[j]);
          }
          mma3x2<QT>(s, kh, kl, qh, ql, dp, vh, vl, oh, ol);
        }
        // p and dS in place (rows: keys g, g + 8; columns: queries 2t, 2t+1)
#pragma unroll
        for (int j = 0; j < QT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = g + ((e & 2) ? 8 : 0);
            const int col = 8 * j + 2 * t + (e & 1);
            const int kj = kw0 + row;
            const int qi = q0 + col;
            const bool keep = qi < Sq && kj < kend && (!causal || kj <= qi);
            const float p = keep ? expf(s[j][e] * sm_scale - lt[col]) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dt[col]) * sm_scale;
            if (with_dq) dss[col * dsp + 16 * warp + row] = dp[j][e];
          }
        }
        // dV += P^T dO, dK += dS^T Q over the tile's queries (permuted),
        // four column tiles at a time (DP is a multiple of 32, so each
        // group holds real columns; the padding reads zeros): the tile's
        // products in zeroed accumulators, then fp32 adds (tile_add)
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 4) {
          float tv[4][4] = {}, tk[4][4] = {};
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            uint32_t ph[4], pl[4], sh[4], sl[4];
            c_as_a(s[j], ph, pl);
            c_as_a(dp[j], sh, sl);
            const float* dor = dot + 8 * j * P;
            const float* qr = qt + 8 * j * P;
            uint32_t oh[4][2], ol[4][2], qh[4][2], ql[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              load_b_perm(dor + 8 * (n0 + i), P, g, t, oh[i], ol[i]);
              load_b_perm(qr + 8 * (n0 + i), P, g, t, qh[i], ql[i]);
            }
            mma3x2<4>(tv, ph, pl, oh, ol, tk, sh, sl, qh, ql);
          }
          tile_add<4>(dv_acc + n0, tv, 1.f, 1.f);
          tile_add<4>(dk_acc + n0, tk, 1.f, 1.f);
        }
      }

      if (with_dq) {
        __syncthreads();  // dS of every warp is in place
        // dQ of the tile = dS K over the live keys; a warp takes 16 rows
        // x 32 columns at a time
        int klive = min(kend, k0 + BK) - k0;
        if (causal) klive = min(klive, q0 + kBQ - k0);
        const int ksteps = (klive + 7) / 8;
        const int ngroups = (ntd + 3) / 4;
        const int items = (kBQ / 16) * ngroups;
        for (int it = warp; it < items; it += nwarps) {
          const int m = it % (kBQ / 16);
          const int grp = it / (kBQ / 16);
          float acc[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          const float* dsm = dss + 16 * m * dsp;
          for (int ks8 = 0; ks8 < ksteps; ++ks8) {
            uint32_t ah[4], al[4], bh_[4][2], bl_[4][2];
            load_a(dsm, dsp, 8 * ks8, g, t, ah, al);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              // B[k = key][n = d] = K[key][d]
              const float* kr =
                  ks + (8 * ks8 + t) * P + 8 * (4 * grp + n) + g;
              split(kr[0], bh_[n][0], bl_[n][0]);
              split(kr[4 * P], bh_[n][1], bl_[n][1]);
            }
            mma3x1<4>(acc, ah, al, bh_, bl_);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int nt = 4 * grp + n;
            if (nt >= ntd) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0 + 16 * m + g + ((e & 2) ? 8 : 0);
              const int d = 8 * nt + 2 * t + (e & 1);
              if (qi < Sq && d < D) dq[qbase + (size_t)qi * D + d] = acc[n][e];
            }
          }
        }
      }
      __syncthreads();  // this buffer (and dS) is consumed
    }
  } else if (with_dq) {
    // no live key in the (b, h): every row of dQ is 0
    for (int i = tid; i < Sq * D; i += nthreads) dq[qbase + i] = 0.f;
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = kw0 + g + ((e & 2) ? 8 : 0);
      const int d = 8 * n + 2 * t + (e & 1);
      if (kj < Sk && d < D) {
        dk[kbase + (size_t)kj * D + d] = dk_acc[n][e];
        dv[kbase + (size_t)kj * D + d] = dv_acc[n][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (Sk > BK): grid (B*H, ceil(Sq / 64)), 4 warps of 16 query rows
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    int H, int Sq, int Sk, int D, int causal,
                    float sm_scale, int vec) {
  constexpr int NT = DP / 8;
  constexpr int KT = kDqBK / 8;       // 8-wide key tiles of a tile
  constexpr int P = pitch_of(DP);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // kDqBQ x P
  float* dos = qs + kDqBQ * P;        // kDqBQ x P
  float* ks = dos + kDqBQ * P;        // 2 x kDqBK x P
  float* vs = ks + 2 * kDqBK * P;     // 2 x kDqBK x P
  float* lse_s = vs + 2 * kDqBK * P;  // kDqBQ
  float* delta_s = lse_s + kDqBQ;     // kDqBQ

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kDqBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int ntd = (D + 7) / 8;
  const int qw0 = q0 + 16 * warp;     // this warp's first query row

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  // key tiles starting at or past kstop hold no live key for these rows
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + kDqBQ);

  zero_pad(qs, P, 2 * kDqBQ + 4 * kDqBK, D, DP, tid, kDqThreads);
  copy_rows(qs, P, q + qbase, q0, kDqBQ, Sq, D, vec, tid, kDqThreads);
  copy_rows(dos, P, dout + qbase, q0, kDqBQ, Sq, D, vec, tid, kDqThreads);
  copy_vec(lse_s, lse + (size_t)bh * Sq, q0, kDqBQ, Sq, tid, kDqThreads);
  copy_vec(delta_s, delta + (size_t)bh * Sq, q0, kDqBQ, Sq, tid,
           kDqThreads);
  auto load_tile = [&](int k0, int buf) {
    copy_rows(ks + buf * kDqBK * P, P, k + kbase, k0, kDqBK, Sk, D, vec, tid,
              kDqThreads);
    copy_rows(vs + buf * kDqBK * P, P, v + kbase, k0, kDqBK, Sk, D, vec,
              tid, kDqThreads);
  };
  if (kstop > 0) load_tile(0, 0);
  cp_commit();

  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  int buf = 0;
  for (int k0 = 0; k0 < kstop; k0 += kDqBK, buf ^= 1) {
    if (k0 + kDqBK < kstop) {
      load_tile(k0 + kDqBK, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * kDqBK * P;
    const float* vt = vs + buf * kDqBK * P;
    const bool live = qw0 < Sq && !(causal && k0 > qw0 + 15);
    if (live) {
      // S and dP of this warp's 16 rows x the tile's keys
      float s[KT][4], dp[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const float* qw = qs + 16 * warp * P;
      const float* dow = dos + 16 * warp * P;
      for (int kk = 0; kk < 8 * ntd; kk += 8) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        load_a(qw, P, kk, g, t, qh, ql);
        load_a(dow, P, kk, g, t, oh, ol);
#pragma unroll
        for (int j0 = 0; j0 < KT; j0 += 4) {
          uint32_t kh[4][2], kl[4][2], vh[4][2], vl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            load_b_rows(kt + 8 * (j0 + i) * P + kk, P, g, t, kh[i], kl[i]);
            load_b_rows(vt + 8 * (j0 + i) * P + kk, P, g, t, vh[i], vl[i]);
          }
          mma3x2<4>(s + j0, qh, ql, kh, kl, dp + j0, oh, ol, vh, vl);
        }
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * warp + g + ((e & 2) ? 8 : 0);
          const int qi = q0 + row;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const bool keep = qi < Sq && kj < kend && (!causal || kj <= qi);
          const float p =
              keep ? expf(s[j][e] * sm_scale - lse_s[row]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_s[row]) * sm_scale;
        }
      }
      // dQ += dS K over the tile's keys (permuted): the tile's product in
      // zeroed accumulators, then fp32 adds (tile_add)
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 4) {
        float tq[4][4] = {};
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t ah[4], al[4];
          c_as_a(dp[j], ah, al);
          const float* kr = kt + 8 * j * P;
          uint32_t bh_[4][2], bl_[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            load_b_perm(kr + 8 * (n0 + i), P, g, t, bh_[i], bl_[i]);
          mma3x1<4>(tq, ah, al, bh_, bl_);
        }
        tile_add<4>(dq_acc + n0, tq, 1.f, 1.f);
      }
    }
    __syncthreads();  // this buffer is consumed
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qw0 + g + ((e & 2) ? 8 : 0);
      const int d = 8 * n + 2 * t + (e & 1);
      if (qi < Sq && d < D) dq[qbase + (size_t)qi * D + d] = dq_acc[n][e];
    }
  }
}

template <int DP>
int launch_fused(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 const int* kv_len, float* dq, float* dk, float* dv, int B,
                 int H, int Sq, int Sk, int D, int causal, float sm_scale,
                 int BK, int with_dq, int vec, long long smem,
                 cudaStream_t stream) {
  if (BK < 16 || BK > kMaxBK || BK % 16 != 0 || (with_dq && Sk > BK) ||
      smem != static_cast<long long>(fused_smem(DP, BK, with_dq)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_fused_kernel<DP>,
                            fused_smem(DP, kMaxBK, 1), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  flash_bwd_fused_kernel<DP><<<grid, 32 * (BK / 16), smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, dk, dv, H, Sq, Sk, D, causal,
      sm_scale, BK, with_dq, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const int* kv_len, float* dq, int B, int H, int Sq, int Sk,
              int D, int causal, float sm_scale, int vec, long long smem,
              cudaStream_t stream) {
  if (smem != static_cast<long long>(dq_smem(DP)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_dq_kernel<DP>, dq_smem(DP), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kDqBQ - 1) / kDqBQ);
  flash_bwd_dq_kernel<DP><<<grid, kDqThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 and float16 forms, on wgmma (wgmma.cuh): templates on the
// element type T (bf16 or f16; both 2 bytes, so the plan, its tiles and
// their bytes are one, named for bf16, the first)
// ---------------------------------------------------------------------------
constexpr int kBf16BQ = 64;       // query rows per tile of the dK/dV kernel
constexpr int kBf16MaxBK = 128;   // keys per dK/dV block at most, 64 a
                                  // warpgroup
constexpr int kBf16DqBK = 64;     // keys per tile of the dQ kernel
constexpr int kBf16DqBQ = 64;     // queries per dQ block, one warpgroup
// lse and delta of a query tile: a TMA box of kBf16LVBox entries from the
// 16-byte boundary at or below the tile's first (TMA reads from 16-byte
// boundaries), in a stage slot of kBf16LV entries (it writes shared memory
// at 128-byte boundaries)
constexpr int kBf16LVBox = kBf16BQ + 4;
constexpr int kBf16LV = kBf16BQ + 32;

// D is zero-padded to DP = 64 or 128 (one or two 128-byte swizzle atoms);
// DP = 64 takes two warpgroups of keys a dK/dV block, DP = 128 one (its dK
// and dV accumulators take 128 registers a thread)
__host__ __device__ constexpr int bf16_max_bk(int DP) {
  return DP == 64 ? kBf16MaxBK : 64;
}
// ring stages of both kernels: three at DP = 64; two at DP = 128, where a
// third would leave room for one block an SM
__host__ __device__ constexpr int bf16_stages(int DP) {
  return DP == 64 ? 3 : 2;
}

// 1024 bytes to align the swizzled tiles; K and V (BK rows each); the
// ring's Q and dO tiles (kBf16BQ rows) and fp32 lse and delta; with dq,
// the tile's dS (kBf16BQ x BK); the ring's full and empty barriers and
// one for K and V
__host__ __device__ constexpr size_t dkv_smem_bf16(int DP, int BK, int dq) {
  return 1024 +
         sizeof(bf16) * ((size_t)2 * BK * DP +
                         (size_t)2 * bf16_stages(DP) * kBf16BQ * DP +
                         (dq ? (size_t)kBf16BQ * BK : 0)) +
         sizeof(float) * 2 * bf16_stages(DP) * kBf16LV +
         sizeof(uint64_t) * (2 * bf16_stages(DP) + 1);
}

// 1024 to align; the block's Q and dO rows; the ring's K and V tiles; the
// ring's barriers and one for Q and dO
__host__ __device__ constexpr size_t dq_smem_bf16(int DP) {
  return 1024 +
         sizeof(bf16) * ((size_t)2 * kBf16DqBQ * DP +
                         (size_t)2 * bf16_stages(DP) * kBf16DqBK * DP) +
         sizeof(uint64_t) * (2 * bf16_stages(DP) + 1);
}

static_assert(dkv_smem_bf16(64, kBf16MaxBK, 1) <= 227 * 1024 &&
                  dkv_smem_bf16(128, bf16_max_bk(128), 1) <= 227 * 1024 &&
                  dq_smem_bf16(64) <= 227 * 1024 &&
                  dq_smem_bf16(128) <= 227 * 1024,
              "a bf16 block's shared memory exceeds 227 KB");

constexpr float kLog2e = 1.4426950408889634f;

// entries [r0, r0 + n) of a vector, zero past `limit`, by NT threads
template <int NT>
__device__ __forceinline__ void copy_vec_sync(float* dst, const float* src,
                                              int r0, int n, int limit,
                                              int tid) {
  for (int i = tid; i < n; i += NT)
    dst[i] = r0 + i < limit ? src[r0 + i] : 0.f;
}

// dK/dV: grid (B*H, ceil(Sk / BK)), WGS warpgroups, each owning 64 keys
// (BK = 64 WGS); DQ (Sk <= BK, one block a (b, h)) also dQ
template <typename T, int DP, int WGS, bool DQ>
__global__ void __launch_bounds__(128 * WGS, 1)
flash_bwd_dkv_bf16_kernel(const T* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_len,
                          T* __restrict__ dq, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Sq, int Sk,
                          int D, int causal, float sm_scale, int vec,
                          const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta) {
  constexpr int BK = 64 * WGS;
  constexpr int NT = 128 * WGS;   // threads
  constexpr int BQ = kBf16BQ;
  constexpr int S = bf16_stages(DP);
  constexpr int NQ = BQ / 8;   // 8-query column tiles of S^T and dP^T
  constexpr int ND = DP / 8;   // 8-column tiles of dK, dV and dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  T* ks = reinterpret_cast<T*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024));
  T* vs = ks + BK * DP;                   // BK rows
  T* qs = vs + BK * DP;                   // S tiles of BQ rows
  T* dos = qs + S * BQ * DP;              // S tiles of BQ rows
  T* dss = dos + S * BQ * DP;             // BQ x BK, DQ
  float* lse_s = reinterpret_cast<float*>(dss + (DQ ? BQ * BK : 0));
  float* delta_s = lse_s + S * kBf16LV;    // S x kBf16LV each
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + S * kBf16LV);
  uint64_t* empty = full + S;              // S each
  uint64_t* kv_bar = empty + S;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int kw0 = k0 + 64 * wg;                // the warpgroup's keys
  const int kr = kw0 + 16 * (warp & 3) + g;    // this thread's: kr, kr + 8
  const bool pair = (D & 1) == 0;
  const float c = sm_scale * kLog2e;

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (k0 < kend) {
    // causal: the first query tile holds query k0
    const int qstart = causal ? (k0 / BQ) * BQ : 0;
    const int ntiles = (Sq - qstart + BQ - 1) / BQ;
    // a tile's lse / delta box starts at the 16-byte boundary at or below
    // its first entry (bh Sq + q0, with q0 a multiple of 4), lv0 entries
    // before it
    const int lv0 = (bh * Sq) & 3;
    // the ring: tile i of the walk in stage i % S; full[st] completes
    // when its tile is in (TMA: the bytes counted; else every thread's
    // copies), empty[st] when each warp is done with it
    if (tid == 0) {
      for (int st = 0; st < S; ++st) {
        mbar_init(full + st, vec ? 1 : NT);
        mbar_init(empty + st, NT / 32);
      }
      mbar_init(kv_bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    auto fill = [&](int i) {   // tile i into stage i % S
      const int q0 = qstart + i * BQ;
      const int st = i % S;
      if (vec) {
        mbar_expect_tx(full + st, 2 * BQ * DP * 2 + 2 * kBf16LVBox * 4);
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb) {
          tma_load_3d(qs + st * BQ * DP + cb * BQ * 64, &tm_q, full + st,
                      64 * cb, q0, bh);
          tma_load_3d(dos + st * BQ * DP + cb * BQ * 64, &tm_do, full + st,
                      64 * cb, q0, bh);
        }
        const int c4 = (bh * Sq + q0) & ~3;
        tma_load_1d(lse_s + st * kBf16LV, &tm_lse, full + st, c4);
        tma_load_1d(delta_s + st * kBf16LV, &tm_delta, full + st, c4);
      } else {
        copy_rows_sw<BQ, NT>(qs + st * BQ * DP, q + qbase, q0, Sq, D, tid);
        copy_rows_sw<BQ, NT>(dos + st * BQ * DP, dout + qbase, q0, Sq, D,
                             tid);
        copy_vec_sync<NT>(lse_s + st * kBf16LV + lv0, lse + (size_t)bh * Sq,
                          q0, BQ, Sq, tid);
        copy_vec_sync<NT>(delta_s + st * kBf16LV + lv0,
                          delta + (size_t)bh * Sq, q0, BQ, Sq, tid);
        fence_async_smem();
        mbar_arrive(full + st);
      }
    };
    if (vec) {
      // K and V by TMA (rows past Sk and columns past D arrive as zeros),
      // and the ring's first tiles, from one thread
      if (tid == 0) {
        mbar_expect_tx(kv_bar, 2 * BK * DP * 2);
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb) {
          tma_load_3d(ks + cb * BK * 64, &tm_k, kv_bar, 64 * cb, k0, bh);
          tma_load_3d(vs + cb * BK * 64, &tm_v, kv_bar, 64 * cb, k0, bh);
        }
        for (int i = 0; i < S - 1 && i < ntiles; ++i) fill(i);
      }
      mbar_wait(kv_bar, 0);
    } else {
      if (D < DP) {
        zero_pad_sw(ks, BK, D, DP, tid, NT);
        zero_pad_sw(vs, BK, D, DP, tid, NT);
        for (int st = 0; st < S; ++st) {
          zero_pad_sw(qs + st * BQ * DP, BQ, D, DP, tid, NT);
          zero_pad_sw(dos + st * BQ * DP, BQ, D, DP, tid, NT);
        }
      }
      copy_rows_sw<BK, NT>(ks, k + kbase, k0, Sk, D, tid);
      copy_rows_sw<BK, NT>(vs, v + kbase, k0, Sk, D, tid);
      for (int i = 0; i < S - 1 && i < ntiles; ++i) fill(i);
      fence_async_smem();
      __syncthreads();
    }

    for (int i = 0; i < ntiles; ++i) {
      // refill the stage tile i - 1 used (the first S - 1 went in above)
      // with tile i + S - 1, once every warp is done with it
      if (i + S - 1 < ntiles && (!vec || tid == 0)) {
        if (i >= 1) mbar_wait(empty + (i - 1) % S, ((i - 1) / S) & 1);
        fill(i + S - 1);
      }
      mbar_wait(full + i % S, (i / S) & 1);
      const int q0 = qstart + i * BQ;
      const T* qt = qs + (i % S) * BQ * DP;
      const T* dot = dos + (i % S) * BQ * DP;
      const float* lt = lse_s + (i % S) * kBf16LV + lv0;
      const float* dt = delta_s + (i % S) * kBf16LV + lv0;

      if (kw0 < kend && !(causal && kw0 > q0 + BQ - 1)) {
        // S^T = K Q^T and dP^T = V dO^T (keys x the tile's queries): a =
        // the warpgroup's 64 K / V rows, b = the Q / dO rows, both K-major
        float s[NQ][4], dp[NQ][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<64, 0, T>(
              s,
              sw128_desc(ks + (kk >> 2) * BK * 64 + wg * 4096 +
                             16 * (kk & 3), 16, 1024),
              sw128_desc(qt + (kk >> 2) * BQ * 64 + 16 * (kk & 3), 16,
                         1024),
              kk);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<64, 0, T>(
              dp,
              sw128_desc(vs + (kk >> 2) * BK * 64 + wg * 4096 +
                             16 * (kk & 3), 16, 1024),
              sw128_desc(dot + (kk >> 2) * BQ * 64 + 16 * (kk & 3), 16,
                         1024),
              kk);
        wg_commit();
        wg_wait<1>();  // S^T is in
        pin<NQ>(s);
        // p = exp(s scale - lse) where the mask allows (qi, kj), else 0;
        // the mask is evaluated only in a tile that crosses an edge (the
        // causal diagonal, kv_len, Sq)
        auto p_of = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const float p =
                  exp2_approx(fmaf(s[j][e], c, -lt[col] * kLog2e));
              if constexpr (decltype(masked)::value) {
                const int kj = kr + ((e & 2) ? 8 : 0);
                const int qi = q0 + col;
                s[j][e] = qi < Sq && kj < kend && (!causal || kj <= qi)
                              ? p
                              : 0.f;
              } else {
                s[j][e] = p;
              }
            }
          }
        };
        if ((causal && kw0 + 63 > q0) || kw0 + 64 > kend || q0 + BQ > Sq)
          p_of(std::true_type{});
        else
          p_of(std::false_type{});
        // dV += T(P)^T dO while dP^T finishes: a = P^T's columns of
        // 16 queries packed from its C fragments, b = those queries' dO
        // rows (N-major)
        uint32_t pa[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          c_to_a<T>(s[2 * kk], s[2 * kk + 1], pa[kk]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<DP, 1, T>(dv_acc, pa[kk],
                          sw128_desc(dot + kk * 16 * 64, BQ * 128, 1024), 1);
        wg_commit();
        wg_wait<1>();  // dP^T is in
        pin<NQ>(dp);
        // dK's dS = T(p) (dP - delta) scale (rounded when packed);
        // fused, dQ's dS = T(p (dP - delta) scale) into shared memory
        // as (query, key)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float ddp = dp[j][e] - dt[col];
            const float pb = to_f(to_t<T>(s[j][e]));
            if constexpr (DQ)
              dss[sw_off(col, kr - k0 + ((e & 2) ? 8 : 0), BQ)] =
                  to_t<T>(s[j][e] * ddp * sm_scale);
            dp[j][e] = pb * ddp * sm_scale;
          }
        }
        // dK += dS^T Q: a = dS^T packed likewise, b = the Q rows
        uint32_t sa[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          c_to_a<T>(dp[2 * kk], dp[2 * kk + 1], sa[kk]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<DP, 1, T>(dk_acc, sa[kk],
                          sw128_desc(qt + kk * 16 * 64, BQ * 128, 1024), 1);
        wg_commit();
        wg_wait<0>();
        pin<ND>(dv_acc);
        pin<ND>(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % S);   // the stage is read

      if constexpr (DQ) {
        fence_async_smem();
        __syncthreads();  // every warpgroup's dS is in place
        if (wg == 0) {
          // dQ of the tile = dS K over the live keys, 16 a k step: a =
          // dS (K-major), b = K's rows (N-major)
          int klive = min(kend, k0 + BK) - k0;
          if (causal) klive = min(klive, q0 + BQ - k0);
          const int ksteps = (klive + 15) / 16;   // at least 1
          float acc[ND][4];
          wg_fence();
          for (int st = 0; st < ksteps; ++st)
            wgmma_ss<DP, 1, T>(
                acc,
                sw128_desc(dss + (st >> 2) * BQ * 64 + 16 * (st & 3), 16,
                           1024),
                sw128_desc(ks + st * 16 * 64, BK * 128, 1024), st);
          wg_commit();
          wg_wait<0>();
          pin<ND>(acc);
          const int qw = q0 + 16 * (warp & 3) + g;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const int d = 8 * n + 2 * t;
            if (d >= D) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int qi = qw + 8 * half;
              if (qi < Sq)
                store_pair(dq, qbase + (size_t)qi * D + d, acc[n][2 * half],
                           acc[n][2 * half + 1], pair, d + 1 < D);
            }
          }
        }
        __syncthreads();  // dS is read before the next tile writes it
      }
    }
  } else if (DQ) {
    for (int i = tid; i < Sq * D; i += NT)
      dq[qbase + i] = to_t<T>(0.f);
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = kr + 8 * half;
      if (kj < Sk) {
        const size_t i = kbase + (size_t)kj * D + d;
        store_pair(dk, i, dk_acc[n][2 * half], dk_acc[n][2 * half + 1],
                   pair, d + 1 < D);
        store_pair(dv, i, dv_acc[n][2 * half], dv_acc[n][2 * half + 1],
                   pair, d + 1 < D);
      }
    }
  }
}

// dQ: grid (B*H, ceil(Sq / 64)), one warpgroup of 64 queries a block
template <typename T, int DP>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_bf16_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len,
                         T* __restrict__ dq, int H, int Sq, int Sk, int D,
                         int causal, float sm_scale, int vec,
                         const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do) {
  constexpr int QR = kBf16DqBQ;
  constexpr int NT = 128;      // threads
  constexpr int BK = kBf16DqBK;
  constexpr int S = bf16_stages(DP);
  constexpr int NK = BK / 8;   // 8-key column tiles of S and dP
  constexpr int ND = DP / 8;   // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                              __cvta_generic_to_shared(smem_raw)) % 1024) %
                  1024));
  T* dos = qs + QR * DP;                  // QR rows
  T* kst = dos + QR * DP;                 // S tiles of BK rows
  T* vst = kst + S * BK * DP;             // S tiles of BK rows
  uint64_t* full = reinterpret_cast<uint64_t*>(vst + S * BK * DP);
  uint64_t* empty = full + S;              // S each
  uint64_t* q_bar = empty + S;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * QR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int qr = q0 + 16 * warp + g;   // this thread's rows: qr, qr + 8

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  const int kstop = causal ? min(kend, q0 + QR) : kend;
  const int ntiles = (kstop + BK - 1) / BK;

  // the ring of key tiles, as the dK/dV kernel's of query tiles
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, vec ? 1 : NT);
      mbar_init(empty + st, NT / 32);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int i) {   // key tile i into stage i % S
    const int st = i % S;
    if (vec) {
      mbar_expect_tx(full + st, 2 * BK * DP * 2);
#pragma unroll
      for (int cb = 0; cb < DP / 64; ++cb) {
        tma_load_3d(kst + st * BK * DP + cb * BK * 64, &tm_k, full + st,
                    64 * cb, i * BK, bh);
        tma_load_3d(vst + st * BK * DP + cb * BK * 64, &tm_v, full + st,
                    64 * cb, i * BK, bh);
      }
    } else {
      copy_rows_sw<BK, NT>(kst + st * BK * DP, k + kbase, i * BK, Sk, D,
                           tid);
      copy_rows_sw<BK, NT>(vst + st * BK * DP, v + kbase, i * BK, Sk, D,
                           tid);
      fence_async_smem();
      mbar_arrive(full + st);
    }
  };
  if (vec) {
    if (tid == 0) {
      mbar_expect_tx(q_bar, 2 * QR * DP * 2);
#pragma unroll
      for (int cb = 0; cb < DP / 64; ++cb) {
        tma_load_3d(qs + cb * QR * 64, &tm_q, q_bar, 64 * cb, q0, bh);
        tma_load_3d(dos + cb * QR * 64, &tm_do, q_bar, 64 * cb, q0, bh);
      }
      for (int i = 0; i < S - 1 && i < ntiles; ++i) fill(i);
    }
  } else {
    if (D < DP) {
      zero_pad_sw(qs, QR, D, DP, tid, NT);
      zero_pad_sw(dos, QR, D, DP, tid, NT);
      for (int st = 0; st < S; ++st) {
        zero_pad_sw(kst + st * BK * DP, BK, D, DP, tid, NT);
        zero_pad_sw(vst + st * BK * DP, BK, D, DP, tid, NT);
      }
    }
    copy_rows_sw<QR, NT>(qs, q + qbase, q0, Sq, D, tid);
    copy_rows_sw<QR, NT>(dos, dout + qbase, q0, Sq, D, tid);
    for (int i = 0; i < S - 1 && i < ntiles; ++i) fill(i);
    fence_async_smem();
    __syncthreads();
  }
  // lse log2(e) and delta of this thread's rows
  const float c = sm_scale * kLog2e;
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qr + 8 * half;
    lr[half] = qi < Sq ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
    dr[half] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
  }
  if (vec) mbar_wait(q_bar, 0);

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + S - 1 < ntiles && (!vec || tid == 0)) {
      if (i >= 1) mbar_wait(empty + (i - 1) % S, ((i - 1) / S) & 1);
      fill(i + S - 1);
    }
    mbar_wait(full + i % S, (i / S) & 1);
    const int k0 = i * BK;
    const T* kt = kst + (i % S) * BK * DP;
    const T* vt = vst + (i % S) * BK * DP;
    // S = Q K^T and dP = dO V^T (the warpgroup's 64 queries x the
    // tile's keys): a = its Q / dO rows, b = the K / V rows, K-major
    float s[NK][4], dp[NK][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<64, 0, T>(
          s,
          sw128_desc(qs + (kk >> 2) * QR * 64 + 16 * (kk & 3), 16, 1024),
          sw128_desc(kt + (kk >> 2) * BK * 64 + 16 * (kk & 3), 16, 1024),
          kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<64, 0, T>(
          dp,
          sw128_desc(dos + (kk >> 2) * QR * 64 + 16 * (kk & 3), 16, 1024),
          sw128_desc(vt + (kk >> 2) * BK * 64 + 16 * (kk & 3), 16, 1024),
          kk);
    wg_commit();
    wg_wait<1>();  // S is in
    pin<NK>(s);
    // p, masked only in a tile that crosses an edge
    auto p_of = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[j][e], c, -lr[e >> 1]));
          if constexpr (decltype(masked)::value) {
            const int qi = qr + ((e & 2) ? 8 : 0);
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            s[j][e] =
                qi < Sq && kj < kend && (!causal || kj <= qi) ? p : 0.f;
          } else {
            s[j][e] = p;
          }
        }
      }
    };
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > kend || q0 + QR > Sq)
      p_of(std::true_type{});
    else
      p_of(std::false_type{});
    wg_wait<0>();  // dP is in
    pin<NK>(dp);
    // dS = p (dP - delta) scale, rounded when packed; dQ += dS K: a =
    // dS's columns of 16 keys, b = those keys' K rows (N-major)
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - dr[e >> 1]) * sm_scale;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      c_to_a<T>(dp[2 * kk], dp[2 * kk + 1], a[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP, 1, T>(dq_acc, a[kk],
                      sw128_desc(kt + kk * 16 * 64, BK * 128, 1024), 1);
    wg_commit();
    wg_wait<0>();
    pin<ND>(dq_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % S);   // the stage is read
  }

  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qr + 8 * half;
      if (qi < Sq)
        store_pair(dq, qbase + (size_t)qi * D + d, dq_acc[n][2 * half],
                   dq_acc[n][2 * half + 1], pair, d + 1 < D);
    }
  }
}

// an fp32 vector of n entries as boxes of `len` (the tensor maps of bf16
// or f16 rows are tma.cuh's map_rows)
bool map_vec(CUtensorMap* m, const float* base, long long n, int len) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t step[1] = {1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<float*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP, int WGS, bool DQ>
int launch_dkv_bf16_as(const T* q, const T* k, const T* v,
                       const T* dout, const float* lse,
                       const float* delta, const int* kv_len, T* dq,
                       T* dk, T* dv, int B, int H, int Sq, int Sk,
                       int D, int causal, float sm_scale, int vec,
                       long long smem, cudaStream_t stream) {
  constexpr int BK = 64 * WGS;
  // TMA: rows of whole 16-byte pieces (the wrapper's vec) and lse / delta
  // 16-byte aligned; else the element-by-element copies
  vec = vec && aligned16(lse) && aligned16(delta) && encode_tiled();
  CUtensorMap tm[6] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec &&
      !(map_rows(tm + 0, ty, q, B * H, Sq, D, kBf16BQ) &&
        map_rows(tm + 1, ty, k, B * H, Sk, D, BK) &&
        map_rows(tm + 2, ty, v, B * H, Sk, D, BK) &&
        map_rows(tm + 3, ty, dout, B * H, Sq, D, kBf16BQ) &&
        map_vec(tm + 4, lse, (long long)B * H * Sq, kBf16LVBox) &&
        map_vec(tm + 5, delta, (long long)B * H * Sq, kBf16LVBox)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_dkv_bf16_kernel<T, DP, WGS, DQ>,
                            dkv_smem_bf16(DP, BK, DQ), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  flash_bwd_dkv_bf16_kernel<T, DP, WGS, DQ><<<grid, 128 * WGS, smem,
                                             stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, dk, dv, H, Sq, Sk, D, causal,
      sm_scale, vec, tm[0], tm[1], tm[2], tm[3], tm[4], tm[5]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dkv_bf16(const T* q, const T* k, const T* v,
                    const T* dout, const float* lse, const float* delta,
                    const int* kv_len, T* dq, T* dk, T* dv, int B,
                    int H, int Sq, int Sk, int D, int causal, float sm_scale,
                    int BK, int with_dq, int vec, long long smem,
                    cudaStream_t stream) {
  if ((BK != 64 && BK != bf16_max_bk(DP)) || (with_dq && Sk > BK) ||
      smem != static_cast<long long>(dkv_smem_bf16(DP, BK, with_dq)))
    return static_cast<int>(cudaErrorInvalidValue);
#define MXTT_DKV_AS(WGS, DQ)                                                \
  launch_dkv_bf16_as<T, DP, WGS, DQ>(q, k, v, dout, lse, delta, kv_len, dq,\
                                  dk, dv, B, H, Sq, Sk, D, causal,          \
                                  sm_scale, vec, smem, stream)
  if (BK == 64) return with_dq ? MXTT_DKV_AS(1, true) : MXTT_DKV_AS(1, false);
  if constexpr (bf16_max_bk(DP) == 128)
    return with_dq ? MXTT_DKV_AS(2, true) : MXTT_DKV_AS(2, false);
#undef MXTT_DKV_AS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DP>
int launch_dq_bf16(const T* q, const T* k, const T* v,
                   const T* dout, const float* lse, const float* delta,
                   const int* kv_len, T* dq, int B, int H, int Sq, int Sk,
                   int D, int causal, float sm_scale, int vec, long long smem,
                   cudaStream_t stream) {
  if (smem != static_cast<long long>(dq_smem_bf16(DP)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int QR = kBf16DqBQ;
  vec = vec && encode_tiled();
  CUtensorMap tm[4] = {};
  constexpr CUtensorMapDataType ty = map_type<T>();
  if (vec && !(map_rows(tm + 0, ty, q, B * H, Sq, D, QR) &&
               map_rows(tm + 1, ty, k, B * H, Sk, D, kBf16DqBK) &&
               map_rows(tm + 2, ty, v, B * H, Sk, D, kBf16DqBK) &&
               map_rows(tm + 3, ty, dout, B * H, Sq, D, QR)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_dq_bf16_kernel<T, DP>, dq_smem_bf16(DP),
                            ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + QR - 1) / QR);
  flash_bwd_dq_bf16_kernel<T, DP><<<grid, 128, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale,
      vec, tm[0], tm[1], tm[2], tm[3]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a plan this file would not have made.
extern "C" int mxtt_flash_bwd_f32(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  const int* kv_len, float* dq, float* dk,
                                  float* dv, int B, int H, int Sq, int Sk,
                                  int D, int causal, float sm_scale, int BK,
                                  int with_dq, int vec, long long smem,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_FUSED(DP)                                                      \
  launch_fused<DP>(q, k, v, dout, lse, delta, kv_len, dq, dk, dv, B, H, Sq, \
                   Sk, D, causal, sm_scale, BK, with_dq, vec, smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_FUSED(32);
  if (D <= 64) return MXTT_FUSED(64);
  if (D <= 96) return MXTT_FUSED(96);
  if (D <= 128) return MXTT_FUSED(128);
#undef MXTT_FUSED
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mxtt_flash_bwd_dq_f32(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     const float* lse, const float* delta,
                                     const int* kv_len, float* dq, int B,
                                     int H, int Sq, int Sk, int D, int causal,
                                     float sm_scale, int vec, long long smem,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_DQ(DP)                                                          \
  launch_dq<DP>(q, k, v, dout, lse, delta, kv_len, dq, B, H, Sq, Sk, D,    \
                causal, sm_scale, vec, smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_DQ(32);
  if (D <= 64) return MXTT_DQ(64);
  if (D <= 96) return MXTT_DQ(96);
  if (D <= 128) return MXTT_DQ(128);
#undef MXTT_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 16-bit forms: q, k, v, dO, dQ, dK, dV of one type T (bf16, f16);
// fp32 lse and delta; the same arguments and return codes, on the plan
// both share (BK 64 or 128, dkv_smem_bf16 / dq_smem_bf16's bytes).
template <typename T>
int flash_bwd_16(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* kv_len, void* dq, void* dk, void* dv, int B,
                 int H, int Sq, int Sk, int D, int causal, float sm_scale,
                 int BK, int with_dq, int vec, long long smem,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  const T* ob = static_cast<const T*>(dout);
  T* dqb = static_cast<T*>(dq);
  T* dkb = static_cast<T*>(dk);
  T* dvb = static_cast<T*>(dv);
#define MXTT_DKV_16(DP)                                                     \
  launch_dkv_bf16<T, DP>(qb, kb, vb, ob, lse, delta, kv_len, dqb, dkb, dvb, \
                         B, H, Sq, Sk, D, causal, sm_scale, BK, with_dq,    \
                         vec, smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return MXTT_DKV_16(64);
  if (D <= 128) return MXTT_DKV_16(128);
#undef MXTT_DKV_16
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int flash_bwd_dq_16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* kv_len, void* dq, int B, int H, int Sq,
                    int Sk, int D, int causal, float sm_scale, int vec,
                    long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  const T* ob = static_cast<const T*>(dout);
  T* dqb = static_cast<T*>(dq);
#define MXTT_DQ_16(DP)                                                      \
  launch_dq_bf16<T, DP>(qb, kb, vb, ob, lse, delta, kv_len, dqb, B, H, Sq,  \
                        Sk, D, causal, sm_scale, vec, smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return MXTT_DQ_16(64);
  if (D <= 128) return MXTT_DQ_16(128);
#undef MXTT_DQ_16
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mxtt_flash_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const int* kv_len, void* dq, void* dk,
                                   void* dv, int B, int H, int Sq, int Sk,
                                   int D, int causal, float sm_scale, int BK,
                                   int with_dq, int vec, long long smem,
                                   void* stream) {
  return flash_bwd_16<bf16>(q, k, v, dout, lse, delta, kv_len, dq, dk, dv, B,
                            H, Sq, Sk, D, causal, sm_scale, BK, with_dq, vec,
                            smem, stream);
}

extern "C" int mxtt_flash_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const int* kv_len, void* dq, int B,
                                      int H, int Sq, int Sk, int D,
                                      int causal, float sm_scale, int vec,
                                      long long smem, void* stream) {
  return flash_bwd_dq_16<bf16>(q, k, v, dout, lse, delta, kv_len, dq, B, H,
                               Sq, Sk, D, causal, sm_scale, vec, smem,
                               stream);
}

extern "C" int mxtt_flash_bwd_f16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  const int* kv_len, void* dq, void* dk,
                                  void* dv, int B, int H, int Sq, int Sk,
                                  int D, int causal, float sm_scale, int BK,
                                  int with_dq, int vec, long long smem,
                                  void* stream) {
  return flash_bwd_16<f16>(q, k, v, dout, lse, delta, kv_len, dq, dk, dv, B,
                           H, Sq, Sk, D, causal, sm_scale, BK, with_dq, vec,
                           smem, stream);
}

extern "C" int mxtt_flash_bwd_dq_f16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* kv_len, void* dq, int B,
                                     int H, int Sq, int Sk, int D,
                                     int causal, float sm_scale, int vec,
                                     long long smem, void* stream) {
  return flash_bwd_dq_16<f16>(q, k, v, dout, lse, delta, kv_len, dq, B, H,
                              Sq, Sk, D, causal, sm_scale, vec, smem,
                              stream);
}
