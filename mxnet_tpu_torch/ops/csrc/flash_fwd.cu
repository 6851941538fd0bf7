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
// bfloat16 form (mxtt_flash_fwd_bf16): the same function on bf16 q / k /
// v, with the JAX kernel's rounding points (pallas_kernels.py:245-267):
// S = Q K^T in fp32, the online softmax in fp32, P rounded to bf16 for
// P V (fp32 sums, l sums the unrounded p), out rounded once at the end,
// lse fp32. The same plan (kernels.py:flash_fwd_plan with the dtype:
// tiles of bf16 rows, half the shared bytes), the same walk, masks and
// merge; its products are mma.sync.m16n8k16 with bf16 operands
// (bf16_mma.cuh), one product where the fp32 form issues three. Q's A
// fragments stay in registers at every DP; P's C fragments of two 8-key
// tiles are the A fragment of P V over 16 keys, and V's B fragments come
// from ldmatrix.trans. BERT's shape in bf16 is 9.4 GFLOP, 0.0095 ms at
// the bf16 tensor-core peak (989 TFLOP/s), and 25 MB of bf16 q, k, v and
// out, 0.0075 ms at 3.35 TB/s: operations bound it.
#include <cuda_runtime.h>

#include <atomic>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

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
// bfloat16 form
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t fwd_smem_bf16(int DP, int BK, int rw,
                                                   int ks) {
  return sizeof(bf16) * ((size_t)kWarpRows * rw + 4 * ks * BK) *
         bf16_pitch(DP);
}

static_assert(fwd_smem_bf16(128, kWideBK, kMaxRowWarps, 1) <= kSmemLimit,
              "a block's shared memory exceeds 227 KB");

// the grid, warps and walk of flash_fwd_kernel
template <int DP, int BK>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ kv_len, bf16* __restrict__ out,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D,
                      int causal, float sm_scale, int ks, int vec) {
  constexpr int NT = DP / 8;          // 8-wide column tiles of D
  constexpr int KT = BK / 8;          // 8-key tiles of a warp's tile
  constexpr int P = bf16_pitch(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = nthreads / 32 / ks;
  const int rows = kWarpRows * rw;
  const int sbk = BK * ks;            // keys a block step loads
  const int wk = warp / rw;           // this warp's tile of the step
  bf16* qs = smem;                    // rows x P
  bf16* kb = qs + rows * P;           // 2 x sbk x P
  bf16* vb = kb + 2 * sbk * P;        // 2 x sbk x P

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int ntd = (D + 7) / 8;        // column tiles holding real columns
  const int nkd = (D + 15) / 16;      // 16-wide k-steps holding them
  const int qw0 = q0 + kWarpRows * (warp % rw);   // this warp's first row

  int kend = Sk;
  if (kv_len != nullptr) kend = max(0, min(kend, kv_len[bh / H]));
  int kstop = kend;
  if (causal) kstop = min(kstop, q0 + rows);

  zero_pad_bf16(qs, P, rows + 4 * sbk, D, DP, tid, nthreads);
  copy_rows_bf16(qs, P, q + qbase, q0, rows, Sq, D, vec, tid, nthreads);
  cp_commit();
  auto load_step = [&](int k0, int buf) {
    copy_rows_bf16(kb + buf * sbk * P, P, k + kbase, k0, sbk, Sk, D, vec,
                   tid, nthreads);
    copy_rows_bf16(vb + buf * sbk * P, P, v + kbase, k0, sbk, Sk, D, vec,
                   tid, nthreads);
  };
  load_step(0, 0);
  cp_commit();

  // Q's A fragments, once
  const bf16* qw = qs + (qw0 - q0) * P;
  uint32_t qa[DP / 16][4];
  cp_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) frag_a(qw, P, 16 * kk, g, t, qa[kk]);

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
    const int kw0 = k0 + BK * wk;
    const bf16* kt = kb + (buf * sbk + BK * wk) * P;
    const bf16* vt = vb + (buf * sbk + BK * wk) * P;
    int klive = min(kend - kw0, BK);
    if (causal) klive = min(klive, qw0 + kWarpRows - kw0);
    if (qw0 < Sq && klive > 0) {
      float s[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk >= nkd) break;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t b[2];
          frag_b_rows(kt + 8 * j * P + 16 * kk, P, g, t, b);
          mma_bf16(s[j], qa[kk], b);
        }
      }
      const bool edge = kw0 + BK > kend || (causal && kw0 + BK - 1 > qw0);
      unsigned keep = ~0u;
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
      // O = O alpha + bf16(P) V over the 16-key steps with a live key:
      // the tile's product in zeroed accumulators, then one fp32 fma
      float pv[NT][4] = {};
#pragma unroll
      for (int jj = 0; jj < KT / 2; ++jj) {
        if (16 * jj >= klive) break;
        uint32_t pa[4];
        c_to_a(s[2 * jj], s[2 * jj + 1], pa);
        const bf16* vr = vt + 16 * jj * P;
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n >= ntd) break;
          uint32_t b[2][2];
          frag_b_trans(vr + 8 * n, P, lane, b);
          mma_bf16(pv[n], pa, b[0]);
          mma_bf16(pv[n + 1], pa, b[1]);
        }
      }
      tile_add<NT>(o, pv, a0, a1);
    }
    __syncthreads();
  }
  cp_wait<0>();

  if (ks > 1) {
    // the merge of flash_fwd_kernel, through the tile buffers as floats
    constexpr int W = 4 * NT + 4;
    float* state = reinterpret_cast<float*>(kb);
    __syncthreads();
    if (wk > 0) {
      float* part = state + (size_t)(warp - rw) * 32 * W + lane;
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
      const float* pw = state + (size_t)(warp + (w - 1) * rw) * 32 * W + lane;
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

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= ntd) continue;
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw0 + g + 8 * half;
      const float dn = half ? d1 : d0;
      if (qi < Sq)
        store_pair(out, qbase + (size_t)qi * D + d, o[n][2 * half] / dn,
                   o[n][2 * half + 1] / dn, pair, d + 1 < D);
    }
  }
  if (t == 0) {
    if (qw0 + g < Sq) lse[(size_t)bh * Sq + qw0 + g] = m0 + logf(d0);
    if (qw0 + g + 8 < Sq) lse[(size_t)bh * Sq + qw0 + g + 8] = m1 + logf(d1);
  }
}

template <int DP, int BK>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const int* kv_len, bf16* out, float* lse, int B, int H,
                int Sq, int Sk, int D, int causal, float sm_scale, int rw,
                int ks, int vec, long long smem, cudaStream_t stream) {
  const size_t state = sizeof(float) * (ks - 1) * rw * 32 * (DP / 2 + 4);
  if (rw < 1 || rw > kMaxRowWarps || ks < 1 || rw * ks > kMaxWarps ||
      smem != static_cast<long long>(fwd_smem_bf16(DP, BK, rw, ks)) ||
      smem > static_cast<long long>(kSmemLimit) ||
      state > fwd_smem_bf16(DP, BK, 0, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(flash_fwd_bf16_kernel<DP, BK>, kSmemLimit, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kWarpRows * rw;
  const dim3 grid(B * H, (Sq + rows - 1) / rows);
  flash_fwd_bf16_kernel<DP, BK><<<grid, 32 * rw * ks, smem, stream>>>(
      q, k, v, kv_len, out, lse, H, Sq, Sk, D, causal, sm_scale, ks, vec);
  return static_cast<int>(cudaGetLastError());
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

// The bfloat16 form: bf16 q, k, v and out, fp32 lse; the same plans (with
// fwd_smem_bf16's bytes) and the same return codes.
extern "C" int mxtt_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, float* lse, int B, int H,
                                   int Sq, int Sk, int D, int causal,
                                   float sm_scale, int BK, int rw, int ks,
                                   int vec, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
#define MXTT_FWD_BF16(DP)                                                   \
  (BK == kWideBK                                                            \
       ? launch_bf16<DP, kWideBK>(qb, kb, vb, kv_len, ob, lse, B, H, Sq,    \
                                  Sk, D, causal, sm_scale, rw, ks, vec,     \
                                  smem, st)                                 \
       : launch_bf16<DP, kSplitBK>(qb, kb, vb, kv_len, ob, lse, B, H, Sq,   \
                                   Sk, D, causal, sm_scale, rw, ks, vec,    \
                                   smem, st))
  if (D <= 0 || D > 128 || (BK != kWideBK && BK != kSplitBK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return MXTT_FWD_BF16(32);
  if (D <= 64) return MXTT_FWD_BF16(64);
  if (D <= 96) return MXTT_FWD_BF16(96);
  return MXTT_FWD_BF16(128);
#undef MXTT_FWD_BF16
}
