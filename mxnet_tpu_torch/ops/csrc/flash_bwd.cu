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
// bfloat16 forms (mxtt_flash_bwd_bf16, mxtt_flash_bwd_dq_bf16): the same
// two kernels, plans and masks on bf16 q, k, v, dO (lse, delta fp32),
// with the JAX kernels' rounding points: the dK / dV kernel rounds p to
// bf16 and uses it for dV = P^T dO and for dS = bf16(p (dP - delta)
// scale) in dK = dS^T Q (pallas_kernels.py:455-461); dQ uses p in fp32
// and dS = bf16(p (dP - delta) scale) (:521-526), so where the fused
// kernel also writes dQ it keeps that second dS in shared memory as
// bf16. dQ, dK, dV are rounded once, at the end. The products are
// mma.sync.m16n8k16 with bf16 operands (bf16_mma.cuh): S^T / dP^T from
// K / V rows (A) and Q / dO rows (B, two 32-bit loads), P^T and dS^T
// from their C fragments as A, and dO / Q / K as B through
// ldmatrix.trans. At BERT's shape the pair does about 2.5x the
// forward's operations, 0.024 ms at 989 TFLOP/s.
#include <cuda_runtime.h>

#include <atomic>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

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
// bfloat16 forms
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t fused_smem_bf16(int DP, int BK,
                                                     int dq) {
  return sizeof(bf16) * ((size_t)2 * BK + (size_t)4 * kBQ) *
             bf16_pitch(DP) +
         sizeof(float) * 4 * kBQ +
         (dq ? sizeof(bf16) * (size_t)kBQ * (BK + 8) : 0);
}

__host__ __device__ constexpr size_t dq_smem_bf16(int DP) {
  return sizeof(bf16) * ((size_t)2 * kDqBQ + (size_t)4 * kDqBK) *
             bf16_pitch(DP) +
         sizeof(float) * 2 * kDqBQ;
}

// the grid and warps of flash_bwd_fused_kernel
template <int DP>
__global__ void __launch_bounds__(32 * kMaxBK / 16)
flash_bwd_fused_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ kv_len,
                            bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int H, int Sq, int Sk,
                            int D, int causal, float sm_scale, int BK,
                            int with_dq, int vec) {
  constexpr int NT = DP / 8;
  constexpr int QT = kBQ / 8;
  constexpr int P = bf16_pitch(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // BK x P
  bf16* vs = ks + BK * P;                         // BK x P
  bf16* qs = vs + BK * P;                         // 2 x kBQ x P
  bf16* dos = qs + 2 * kBQ * P;                   // 2 x kBQ x P
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBQ * P);  // 2 x kBQ
  float* delta_s = lse_s + 2 * kBQ;               // 2 x kBQ
  bf16* dss = reinterpret_cast<bf16*>(delta_s + 2 * kBQ);  // kBQ x dsp
  const int dsp = BK + 8;

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
  const int ntd = (D + 7) / 8;
  const int nkd = (D + 15) / 16;
  const int kw0 = k0 + 16 * warp;
  const bool pair = (D & 1) == 0;

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (k0 < kend) {
    zero_pad_bf16(ks, P, 2 * BK + 4 * kBQ, D, DP, tid, nthreads);
    const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
    copy_rows_bf16(ks, P, k + kbase, k0, BK, Sk, D, vec, tid, nthreads);
    copy_rows_bf16(vs, P, v + kbase, k0, BK, Sk, D, vec, tid, nthreads);
    auto load_tile = [&](int q0, int buf) {
      copy_rows_bf16(qs + buf * kBQ * P, P, q + qbase, q0, kBQ, Sq, D, vec,
                     tid, nthreads);
      copy_rows_bf16(dos + buf * kBQ * P, P, dout + qbase, q0, kBQ, Sq, D,
                     vec, tid, nthreads);
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
      const bf16* qt = qs + buf * kBQ * P;
      const bf16* dot = dos + buf * kBQ * P;
      const float* lt = lse_s + buf * kBQ;
      const float* dt = delta_s + buf * kBQ;

      const bool live = kw0 < kend && !(causal && kw0 > q0 + kBQ - 1);
      if (live) {
        // S^T and dP^T of this warp's 16 keys x the tile's queries
        float s[QT][4], dp[QT][4];
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const bf16* kw = ks + 16 * warp * P;
        const bf16* vw = vs + 16 * warp * P;
        for (int kk = 0; kk < 16 * nkd; kk += 16) {
          uint32_t ka[4], va[4];
          frag_a(kw, P, kk, g, t, ka);
          frag_a(vw, P, kk, g, t, va);
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            uint32_t qb[2], ob[2];
            frag_b_rows(qt + 8 * j * P + kk, P, g, t, qb);
            frag_b_rows(dot + 8 * j * P + kk, P, g, t, ob);
            mma_bf16(s[j], ka, qb);
            mma_bf16(dp[j], va, ob);
          }
        }
        // p (fp32, rounded to bf16 when packed for dV) and dS = bf16(p)
        // (dP - delta) scale (rounded when packed for dK); dQ's dS from
        // the fp32 p goes to shared memory as bf16
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
            const float pb = __bfloat162float(__float2bfloat16(p));
            const float ddp = dp[j][e] - dt[col];
            s[j][e] = p;
            dp[j][e] = pb * ddp * sm_scale;
            if (with_dq)
              dss[col * dsp + 16 * warp + row] =
                  __float2bfloat16(p * ddp * sm_scale);
          }
        }
        // dV += bf16(P)^T dO, dK += dS^T Q over the tile's queries, 16 at
        // a step, four column tiles at a time: the tile's products in
        // zeroed accumulators, then fp32 adds (tile_add)
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 4) {
          float tv[4][4] = {}, tk[4][4] = {};
#pragma unroll
          for (int jj = 0; jj < QT / 2; ++jj) {
            uint32_t pa[4], sa[4];
            c_to_a(s[2 * jj], s[2 * jj + 1], pa);
            c_to_a(dp[2 * jj], dp[2 * jj + 1], sa);
            const bf16* dor = dot + 16 * jj * P + 8 * n0;
            const bf16* qr = qt + 16 * jj * P + 8 * n0;
#pragma unroll
            for (int i = 0; i < 4; i += 2) {
              uint32_t ob[2][2], qb[2][2];
              frag_b_trans(dor + 8 * i, P, lane, ob);
              frag_b_trans(qr + 8 * i, P, lane, qb);
              mma_bf16(tv[i], pa, ob[0]);
              mma_bf16(tv[i + 1], pa, ob[1]);
              mma_bf16(tk[i], sa, qb[0]);
              mma_bf16(tk[i + 1], sa, qb[1]);
            }
          }
          tile_add<4>(dv_acc + n0, tv, 1.f, 1.f);
          tile_add<4>(dk_acc + n0, tk, 1.f, 1.f);
        }
      }

      if (with_dq) {
        __syncthreads();  // dS of every warp is in place
        // dQ of the tile = dS K over the live keys, 16 at a step; a warp
        // takes 16 rows x 32 columns at a time
        int klive = min(kend, k0 + BK) - k0;
        if (causal) klive = min(klive, q0 + kBQ - k0);
        const int ksteps = (klive + 15) / 16;
        const int ngroups = (ntd + 3) / 4;
        const int items = (kBQ / 16) * ngroups;
        for (int it = warp; it < items; it += nwarps) {
          const int m = it % (kBQ / 16);
          const int grp = it / (kBQ / 16);
          float acc[4][4] = {};
          const bf16* dsm = dss + 16 * m * dsp;
          for (int st = 0; st < ksteps; ++st) {
            uint32_t a[4], b[2][2];
            frag_a(dsm, dsp, 16 * st, g, t, a);
            const bf16* kr = ks + 16 * st * P + 32 * grp;
            frag_b_trans(kr, P, lane, b);
            mma_bf16(acc[0], a, b[0]);
            mma_bf16(acc[1], a, b[1]);
            frag_b_trans(kr + 16, P, lane, b);
            mma_bf16(acc[2], a, b[0]);
            mma_bf16(acc[3], a, b[1]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int d = 8 * (4 * grp + n) + 2 * t;
            if (d >= D) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int qi = q0 + 16 * m + g + 8 * half;
              if (qi < Sq)
                store_pair(dq, qbase + (size_t)qi * D + d, acc[n][2 * half],
                           acc[n][2 * half + 1], pair, d + 1 < D);
            }
          }
        }
      }
      __syncthreads();  // this buffer (and dS) is consumed
    }
  } else if (with_dq) {
    for (int i = tid; i < Sq * D; i += nthreads)
      dq[qbase + i] = __float2bfloat16(0.f);
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = kw0 + g + 8 * half;
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

// the grid and warps of flash_bwd_dq_kernel
template <int DP>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len,
                         bf16* __restrict__ dq, int H, int Sq, int Sk, int D,
                         int causal, float sm_scale, int vec) {
  constexpr int NT = DP / 8;
  constexpr int KT = kDqBK / 8;
  constexpr int P = bf16_pitch(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // kDqBQ x P
  bf16* dos = qs + kDqBQ * P;                     // kDqBQ x P
  bf16* ks = dos + kDqBQ * P;                     // 2 x kDqBK x P
  bf16* vs = ks + 2 * kDqBK * P;                  // 2 x kDqBK x P
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kDqBK * P);  // kDqBQ
  float* delta_s = lse_s + kDqBQ;                 // kDqBQ

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
  const int nkd = (D + 15) / 16;
  const int qw0 = q0 + 16 * warp;

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + kDqBQ);

  zero_pad_bf16(qs, P, 2 * kDqBQ + 4 * kDqBK, D, DP, tid, kDqThreads);
  copy_rows_bf16(qs, P, q + qbase, q0, kDqBQ, Sq, D, vec, tid, kDqThreads);
  copy_rows_bf16(dos, P, dout + qbase, q0, kDqBQ, Sq, D, vec, tid,
                 kDqThreads);
  copy_vec(lse_s, lse + (size_t)bh * Sq, q0, kDqBQ, Sq, tid, kDqThreads);
  copy_vec(delta_s, delta + (size_t)bh * Sq, q0, kDqBQ, Sq, tid,
           kDqThreads);
  auto load_tile = [&](int k0, int buf) {
    copy_rows_bf16(ks + buf * kDqBK * P, P, k + kbase, k0, kDqBK, Sk, D, vec,
                   tid, kDqThreads);
    copy_rows_bf16(vs + buf * kDqBK * P, P, v + kbase, k0, kDqBK, Sk, D, vec,
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
    const bf16* kt = ks + buf * kDqBK * P;
    const bf16* vt = vs + buf * kDqBK * P;
    const bool live = qw0 < Sq && !(causal && k0 > qw0 + 15);
    if (live) {
      float s[KT][4], dp[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const bf16* qw = qs + 16 * warp * P;
      const bf16* dow = dos + 16 * warp * P;
      for (int kk = 0; kk < 16 * nkd; kk += 16) {
        uint32_t qa[4], oa[4];
        frag_a(qw, P, kk, g, t, qa);
        frag_a(dow, P, kk, g, t, oa);
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t kb_[2], vb_[2];
          frag_b_rows(kt + 8 * j * P + kk, P, g, t, kb_);
          frag_b_rows(vt + 8 * j * P + kk, P, g, t, vb_);
          mma_bf16(s[j], qa, kb_);
          mma_bf16(dp[j], oa, vb_);
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
      // dQ += bf16(dS) K over the tile's keys, 16 at a step: the tile's
      // product in zeroed accumulators, then fp32 adds (tile_add)
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 4) {
        float tq[4][4] = {};
#pragma unroll
        for (int jj = 0; jj < KT / 2; ++jj) {
          uint32_t a[4], b[2][2];
          c_to_a(dp[2 * jj], dp[2 * jj + 1], a);
          const bf16* kr = kt + 16 * jj * P + 8 * n0;
          frag_b_trans(kr, P, lane, b);
          mma_bf16(tq[0], a, b[0]);
          mma_bf16(tq[1], a, b[1]);
          frag_b_trans(kr + 16, P, lane, b);
          mma_bf16(tq[2], a, b[0]);
          mma_bf16(tq[3], a, b[1]);
        }
        tile_add<4>(dq_acc + n0, tq, 1.f, 1.f);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw0 + g + 8 * half;
      if (qi < Sq)
        store_pair(dq, qbase + (size_t)qi * D + d, dq_acc[n][2 * half],
                   dq_acc[n][2 * half + 1], pair, d + 1 < D);
    }
  }
}

template <int DP>
int launch_fused_bf16(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* delta,
                      const int* kv_len, bf16* dq, bf16* dk, bf16* dv, int B,
                      int H, int Sq, int Sk, int D, int causal,
                      float sm_scale, int BK, int with_dq, int vec,
                      long long smem, cudaStream_t stream) {
  if (BK < 16 || BK > kMaxBK || BK % 16 != 0 || (with_dq && Sk > BK) ||
      smem != static_cast<long long>(fused_smem_bf16(DP, BK, with_dq)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_fused_bf16_kernel<DP>,
                            fused_smem_bf16(DP, kMaxBK, 1), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  flash_bwd_fused_bf16_kernel<DP><<<grid, 32 * (BK / 16), smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, dk, dv, H, Sq, Sk, D, causal,
      sm_scale, BK, with_dq, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   const int* kv_len, bf16* dq, int B, int H, int Sq, int Sk,
                   int D, int causal, float sm_scale, int vec, long long smem,
                   cudaStream_t stream) {
  if (smem != static_cast<long long>(dq_smem_bf16(DP)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_bwd_dq_bf16_kernel<DP>, dq_smem_bf16(DP),
                            ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kDqBQ - 1) / kDqBQ);
  flash_bwd_dq_bf16_kernel<DP><<<grid, kDqThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_len, dq, H, Sq, Sk, D, causal, sm_scale,
      vec);
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

// The bfloat16 forms: bf16 q, k, v, dO, dQ, dK, dV; fp32 lse and delta;
// the same plans (with fused_smem_bf16 / dq_smem_bf16's bytes) and the
// same return codes.
extern "C" int mxtt_flash_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const int* kv_len, void* dq, void* dk,
                                   void* dv, int B, int H, int Sq, int Sk,
                                   int D, int causal, float sm_scale, int BK,
                                   int with_dq, int vec, long long smem,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
#define MXTT_FUSED_BF16(DP)                                                 \
  launch_fused_bf16<DP>(qb, kb, vb, ob, lse, delta, kv_len, dqb, dkb, dvb,  \
                        B, H, Sq, Sk, D, causal, sm_scale, BK, with_dq, vec,\
                        smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_FUSED_BF16(32);
  if (D <= 64) return MXTT_FUSED_BF16(64);
  if (D <= 96) return MXTT_FUSED_BF16(96);
  if (D <= 128) return MXTT_FUSED_BF16(128);
#undef MXTT_FUSED_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mxtt_flash_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const int* kv_len, void* dq, int B,
                                      int H, int Sq, int Sk, int D,
                                      int causal, float sm_scale, int vec,
                                      long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
#define MXTT_DQ_BF16(DP)                                                     \
  launch_dq_bf16<DP>(qb, kb, vb, ob, lse, delta, kv_len, dqb, B, H, Sq, Sk, \
                     D, causal, sm_scale, vec, smem, st)
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_DQ_BF16(32);
  if (D <= 64) return MXTT_DQ_BF16(64);
  if (D <= 96) return MXTT_DQ_BF16(96);
  if (D <= 128) return MXTT_DQ_BF16(128);
#undef MXTT_DQ_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}
