"""Kernels of the serving and training paths, each beside its plain
version.

Counterpart of `mxnet_tpu/ops/pallas_kernels.py`:

  * `flash_attention` — every attention of the model, forward and
    backward, as a `torch.autograd.Function`. Its forward launches
    `csrc/flash_fwd.cu` (replaces `_flash_fwd_kernel`; fp32: split TF32
    on the tensor cores, 16 query rows a warp and 4 warps a block, or,
    where the rows alone would leave the card idle, fewer rows a block
    and up to 8 warps splitting the keys; bf16 and fp16: persistent
    blocks on wgmma fed by a TMA ring, 64 query rows a warpgroup and two
    a block taking turns at the tensor cores, or one where that would
    leave the card idle: `flash_fwd_plan`) and keeps q,
    k, v, the output and the row log-sum-exp; its backward launches
    `csrc/flash_bwd.cu` (replaces `_flash_bwd_dkv_kernel` and
    `_flash_bwd_dq_kernel`): one fused dQ/dK/dV kernel when the keys fit
    one block (`flash_bwd_plan`: Sk <= 128 at D <= 64, every attention
    of the TransformerNMT training step), else that kernel for dK/dV and
    a dQ kernel after it (BERT at S = 512). `flash_attention_fwd` /
    `flash_attention_bwd` are the two halves on their own; the backward
    takes delta = rowsum(dO * O) as an input, which its caller computes.
    Heads wider than 128 (any width) go to `csrc/flash_wide.cu` instead:
    a forward, a dK/dV and a dQ kernel (counters `flash_wide_fwd`,
    `flash_wide_bwd_dkv`, `flash_wide_bwd_dq`), as `flash_wide_plan`
    says; in bf16 and fp16 the forward and dK/dV kernels run on wgmma,
    in chunks of 256 output columns.
  * `ragged_paged_attention` — the decode step's self-attention over
    the paged KV cache: four kernels of `csrc/ragged_paged_attention.cu`
    — one query row per slot (replaces `_rpa_kernel`; one block per
    (slot, head), each warp loading its positions' K / V rows into
    registers a chunk ahead, as `rpa_plan` says) or any W >= 2 rows
    (replaces `_rpa_multi_kernel`; the same design over groups of 4
    rows, as `rpa_multi_plan` says), over float32 pages or int8 pages
    with per-page scales (their `quant=True` paths). Its plain versions
    share `single_query_cached_attention` with the decoder's
    cross-attention, as the JAX package's lax path does.
  * `fused_layer_norm` — LayerNorm over the last axis as a
    `torch.autograd.Function`: the forward launches `csrc/layer_norm.cu`
    (replaces `_ln_kernel`; any width, one warp a row up to D = 1024 and
    one block a row above; fp32, bf16 or fp16 x, with fp32 gamma / beta
    or, for the 16-bit forms, gamma / beta in x's dtype, and bf16 gamma
    / beta for fp32 x), the backward is the closed
    form of `_fused_ln_vjp_bwd` in plain torch on both devices (it was
    XLA in the JAX package).
  * `conv1x1_bn_stats` — a 1x1 convolution as an (M, K) @ (K, N)
    product with BatchNorm's per-column mean and mean square of y in its
    epilogue: `csrc/conv1x1_bn_stats.cu` (replaces
    `_conv1x1_stats_kernel` and the probe kernel of
    `tools/probe_fused_convbn.py`), on the tensor cores through wgmma:
    bf16, or fp32 in split TF32; the statistics in a fixed order, so
    repeated calls agree bit for bit (`conv1x1_plan`). As in the JAX
    package it is an entry of its own: no model calls it.

A wrapper takes the plain version only because the tensors it was given
lie on the CPU. On CUDA tensors it launches its kernel or raises: there
is no fallback. Each launch adds one to `LAUNCHES[name]`, so a run can
show that its path went through the kernels.

Masking follows the JAX package: masked scores are the finite -1e30, and
the softmax runs in fp32. The causal mask is `attention_reference`'s
top-left one, kj <= qi in absolute indices, for any Sq and Sk. A row with no visible key (a key length of 0)
is zeros in both the kernels and the plain versions — the convention of
the TPU kernels (`pallas_kernels.py:287-291`) — and its backward is
zeros too, because the backward masks p itself rather than relying on
exp(-1e30 - lse) underflowing. The JAX `attention_reference` instead
averages V over such a row; that divergence is recorded in ROADMAP.md,
and parity tests use lengths >= 1.

Dtypes. The flash kernels take float32, bfloat16 or float16 q / k / v
(one dtype, heads of any width D > 0) and the LayerNorm kernel float32,
bfloat16 or float16 x
(gamma / beta float32 or x's dtype; bfloat16 with float32 x), as the JAX
kernels read their inputs in the model's dtype. The 16-bit forms have
kernels of their own (`mxtt_*_bf16`, `mxtt_*_f16`, counted under
`*_bf16` and `*_f16` names; one CUDA template each, on one launch plan,
since both types are 2 bytes) with 16-bit operands and fp32 accumulators
on the tensor cores; they and their plain versions round where the JAX
kernels do, in the input dtype: S = Q K^T in fp32, P rounded before P V,
the output rounded once (lse fp32); in the backward delta = rowsum(dO *
O) in fp32, the dK / dV kernel takes P rounded for dV and for dS, the dQ
kernel P in fp32 and dS rounded (`pallas_kernels.py:455-461, 521-526`);
LayerNorm's statistics are fp32 and y is in x's dtype. Any other dtype
raises on both devices.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_fwd_plan", "flash_bwd_plan", "flash_wide_plan",
           "flash_block_attention",
           "single_query_cached_attention", "ragged_paged_attention",
           "rpa_plan",
           "fused_layer_norm", "layer_norm_fwd",
           "conv1x1_bn_stats", "conv1x1_plan",
           "LAUNCHES", "reset_launch_counts"]

_MASKED = -1e30

# kernel launches per wrapper; bumped only where a kernel is launched
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dq": 0,
            "flash_fwd_bf16": 0, "flash_bwd_bf16": 0,
            "flash_bwd_dq_bf16": 0, "flash_fwd_f16": 0, "flash_bwd_f16": 0,
            "flash_bwd_dq_f16": 0, "flash_block": 0, "flash_block_bf16": 0,
            "flash_block_f16": 0,
            "flash_wide_fwd": 0, "flash_wide_bwd_dkv": 0,
            "flash_wide_bwd_dq": 0, "flash_wide_fwd_bf16": 0,
            "flash_wide_bwd_dkv_bf16": 0, "flash_wide_bwd_dq_bf16": 0,
            "flash_wide_fwd_f16": 0, "flash_wide_bwd_dkv_f16": 0,
            "flash_wide_bwd_dq_f16": 0,
            "ragged_paged_attention": 0, "ragged_paged_attention_int8": 0,
            "ragged_paged_attention_multi": 0,
            "ragged_paged_attention_multi_int8": 0, "layer_norm": 0,
            "layer_norm_bf16": 0, "layer_norm_f16": 0,
            "conv1x1_bn_stats": 0, "conv1x1_bn_stats_bf16": 0, "rtc": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_of(*tensors):
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise MXNetError(
            f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError(f"unsupported device {dev}")
    return dev


def _check(cond, what):
    if not cond:
        raise MXNetError(what)


# the kernel-name and counter suffix of each dtype's form (float32's
# counters have none, its kernels `_f32`)
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}


def _suffix(dtype):
    """The kernel-name and counter suffix of a dtype's form."""
    return _SUFFIX[dtype]


def _launched(name, rc):
    """Raise on a refused launch (a launch that never ran is not
    reported by `synchronize`); count the one that went out."""
    if rc != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain attention (CPU path; the yardstick of both kernels)
# ---------------------------------------------------------------------------
def _masked_softmax(s, allowed):
    """Row softmax of fp32 scores `s` whose hidden entries are already
    -1e30; rows where `allowed` (bool, broadcastable) is all False are
    zeros — the kernels' convention."""
    p = torch.softmax(s, dim=-1)
    if allowed is not None:
        p = p * allowed.any(dim=-1, keepdim=True)
    return p


def _attention_scores(q, k, causal, sm_scale, keep):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    allowed = keep
    if causal:
        sq, sk = s.shape[-2:]
        tri = (torch.arange(sq, device=s.device)[:, None]
               >= torch.arange(sk, device=s.device)[None, :])
        allowed = tri if allowed is None else allowed & tri
    if allowed is not None:
        s = torch.where(allowed, s, torch.full_like(s, _MASKED))
    return s, allowed


def _flash_plain(q, k, v, causal, sm_scale, kv_lengths):
    """The plain version of the flash kernel: (out, lse (B*H, Sq)). In
    bfloat16 and float16 it rounds where the kernels do: p = exp(s -
    rowmax) in fp32 is rounded to the input dtype for P V (fp32 sums), l
    sums the unrounded p, and out = (P V) / l is rounded once."""
    b, h, sq, _ = q.shape
    keep = None
    if kv_lengths is not None:
        pos = torch.arange(k.shape[2], device=k.device)
        keep = (pos[None, :] < kv_lengths.long()[:, None])[:, None, None, :]
    s, allowed = _attention_scores(q, k, causal, sm_scale, keep)
    lse = torch.logsumexp(s, dim=-1).reshape(b * h, sq)
    if q.dtype == torch.float32:
        p = _masked_softmax(s, allowed).to(v.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", p, v), lse
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if allowed is not None:
        p = torch.where(allowed, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (pv / l).to(v.dtype), lse


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------
_ATTN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# head widths: the narrow kernels (flash_fwd.cu, flash_bwd.cu) take D <=
# 128, the wide ones (flash_wide.cu) any wider head
_NARROW_MAX_D = 128


def _tile_row(dp):
    """Bytes of one shared-memory row of an fp32 flash kernel's tile: DP
    floats and a pad of 4 (`tf32_mma.cuh` pitch_of), so fragment loads
    of 8 rows hit different banks."""
    return 4 * (dp + 4)


def _flash_args(q, k, v, kv_lengths):
    """What the kernel takes, checked on either device (so the CPU tests
    catch a layout the card would refuse): (B, H, Sq, Sk, D)."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check(k.shape == (b, h, sk, d) and v.shape == k.shape,
           f"flash_attention shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
           f" v {tuple(v.shape)} do not agree")
    _check(q.dtype in _ATTN_DTYPES and k.dtype == q.dtype
           and v.dtype == q.dtype,
           f"flash_attention kernel takes float32, bfloat16 or float16 "
           f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _check(all(t.is_contiguous() for t in (q, k, v)),
           "flash_attention kernel takes contiguous q/k/v")
    _check(d > 0, f"flash_attention kernel takes D > 0, got {d}")
    _check(b * h > 0 and sq > 0 and sk > 0, "flash_attention: empty input")
    if kv_lengths is not None:
        _check(kv_lengths.dtype == torch.int32 and kv_lengths.shape == (b,)
               and kv_lengths.is_contiguous(),
               "kv_lengths must be a contiguous (B,) int32 tensor")
    return b, h, sq, sk, d


# query rows a warp owns, row warps and warps a block holds at most, keys
# of a warp's tile without a key split and with one (`csrc/flash_fwd.cu`
# kWarpRows, kMaxRowWarps, kMaxWarps, kWideBK, kSplitBK)
_FWD_WARP_ROWS, _FWD_MAX_ROW_WARPS, _FWD_MAX_WARPS = 16, 4, 8
_FWD_WIDE_BK, _FWD_SPLIT_BK = 32, 16
# the H100's streaming multiprocessors, and its dynamic shared memory a
# block at most
_CARD_SMS, _SMEM_LIMIT = 132, 227 * 1024


def flash_fwd_smem(rw, ks, bk, dp):
    """The fp32 forward kernel's dynamic shared bytes (`fwd_smem` of
    `csrc/flash_fwd.cu`): 16 * rw Q rows and two buffers of ks K and V
    tiles of bk rows. (The bf16 kernel's are `_fwd_bf16_plan`'s.)"""
    return (_FWD_WARP_ROWS * rw + 4 * ks * bk) * _tile_row(dp)


# the bf16 kernel (wgmma, TMA): query rows of a consumer warpgroup, row
# warpgroups of a full block, stages of its ring of key tiles
# (`csrc/flash_fwd.cu` kBf16WgRows, kBf16RowWgs, kBf16Stages)
_BF16_FWD_WG_ROWS, _BF16_FWD_ROW_WGS, _BF16_FWD_STAGES = 64, 2, 3


def _fwd_bf16_plan(dp, rw):
    """The 16-bit forward's launch plan (bf16 and fp16, both 2 bytes, on
    one kernel template) for one block shape: rw consumer
    warpgroups of 64 rows (ks = 1: every warpgroup walks every key tile)
    and the producer; key tiles of 128 where two warpgroups share them
    at DP = 64, else 64 (`fwd_bf16_bk`); the shared bytes are
    `fwd_smem_bf16`'s: 1024 to align the swizzled tiles, two buffers of
    the block's Q rows and one of its O rows, the ring's K and V tiles,
    its full and empty mbarriers and a full and an empty one for each Q
    buffer."""
    stages = _BF16_FWD_STAGES
    rows = _BF16_FWD_WG_ROWS * rw
    bk = 128 if dp == 64 and rw == _BF16_FWD_ROW_WGS else 64
    smem = 1024 + 2 * (3 * rows * dp + 2 * stages * bk * dp) \
        + 8 * (2 * stages + 4)
    return dict(dp=dp, bk=bk, rw=rw, ks=1, rows=rows, threads=128 * (rw + 1),
                stages=stages, smem=smem)


def _flash_fwd_plan_bf16(bh, sq, d):
    """`flash_fwd_plan` in bfloat16 or float16: the wgmma kernel's tiles
    in the 128-byte swizzle, so D pads to 64 or 128 (one or two swizzle
    atoms).
    Items of two consumer warpgroups (128 rows, taking turns at the
    tensor cores, sharing key tiles of 128 at DP = 64) where that many
    items cover the card; else, the small grids (the serving prefill,
    the training step's S = 64), items of one warpgroup of 64 rows with
    64-key tiles, two blocks an SM at DP = 64. Either way the blocks are
    persistent: as many as stay resident, walking the items."""
    dp = 64 if d <= 64 else 128
    wide = sq > _BF16_FWD_WG_ROWS and bh * -(-sq // (
        _BF16_FWD_WG_ROWS * _BF16_FWD_ROW_WGS)) >= _CARD_SMS
    return _fwd_bf16_plan(dp, _BF16_FWD_ROW_WGS if wide else 1)


def flash_fwd_plan(bh, sq, sk, d, dtype=torch.float32):
    """The launch plan of the flash forward kernel in `dtype` (float32,
    bfloat16 or float16) for B*H = `bh` slices of Sq queries over Sk keys
    of width D. bfloat16 and float16: `_flash_fwd_plan_bf16` (dp, bk, rw
    consumer warpgroups of 64 rows, ks = 1, stages, smem).
    float32:

      dp     D zero-padded in shared memory (32, 64, 96 or 128)
      rw     row warps a block, 16 query rows each: 4, halved while the
             grid (bh x ceil(Sq / rows)) would leave SMs of the card
             without a block
      ks     warps each row group's keys are split over: 1 at 4 row
             warps; else up to 8 warps a block in all, fewer when half
             of them already cover Sk or their tiles would not fit the
             block's shared memory. Warp w walks tiles w, w + ks, ...,
             and the ks warps merge their softmax state at the end
      bk     keys of a warp's tile: 32, or 16 under a key split (shorter
             walks where the rows alone leave the card idle)
      warps  rw x ks
      rows   query rows a block (16 x rw)
      smem   dynamic shared bytes (the Q rows and two buffers of ks K and
             V tiles, `flash_fwd_smem`); the kernel recomputes them and
             refuses a plan that disagrees.
    """
    _check(0 < d <= 128 and bh > 0 and sq > 0 and sk > 0,
           f"flash forward takes 0 < D <= 128 and a non-empty input, got "
           f"D {d}, B*H {bh}, Sq {sq}, Sk {sk}")
    _check(dtype in _ATTN_DTYPES, f"flash forward has no {dtype} form")
    if dtype != torch.float32:
        return _flash_fwd_plan_bf16(bh, sq, d)
    dp = 32 * -(-d // 32)
    rw = _FWD_MAX_ROW_WARPS
    while rw > 1 and bh * -(-sq // (_FWD_WARP_ROWS * rw)) < _CARD_SMS:
        rw //= 2
    rows = _FWD_WARP_ROWS * rw
    if rw == _FWD_MAX_ROW_WARPS:
        ks, bk = 1, _FWD_WIDE_BK
    else:
        ks, bk = _FWD_MAX_WARPS // rw, _FWD_SPLIT_BK

    def smem(ks):
        return flash_fwd_smem(rw, ks, bk, dp)
    while ks > 1 and (bk * ks // 2 >= sk or smem(ks) > _SMEM_LIMIT):
        ks //= 2
    return dict(dp=dp, rw=rw, ks=ks, bk=bk, warps=rw * ks, rows=rows,
                smem=smem(ks))


def _flash_cuda(q, k, v, causal, sm_scale, kv_lengths, plan):
    """The forward kernel on the arguments `flash_attention_fwd` checked,
    launched as `plan` says."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    sfx = _suffix(q.dtype)
    fn = getattr(lib, "mxtt_flash_fwd" + (sfx or "_f32"))
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_lengths is None else kv_lengths.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, sq, k.shape[2], d,
            int(causal), float(sm_scale), plan["bk"], plan["rw"],
            plan["ks"], _vec_copies(d, q, k, v), plan["smem"],
            torch.cuda.current_stream().cuda_stream)
    _launched("flash_fwd" + sfx, rc)
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None,
                        kv_lengths=None):
    """Attention forward with its per-row log-sum-exp: (out (B, H, Sq,
    D), lse (B*H, Sq) fp32). q: (B, H, Sq, D); k, v: (B, H, Sk, D);
    kv_lengths: optional (B,) int32 — key positions >= kv_lengths[b]
    are masked. `causal` masks kj > qi in absolute indices (top-left),
    for any Sq and Sk. On the card one launch as `flash_fwd_plan`
    says, or of the wide forward kernel for D > 128
    (`flash_wide_plan`)."""
    dev = _device_of(q, k, v, kv_lengths)
    b, h, sq, sk, d = _flash_args(q, k, v, kv_lengths)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if dev.type != "cuda":
        return _flash_plain(q, k, v, causal, sm_scale, kv_lengths)
    if d > _NARROW_MAX_D:
        return _flash_wide_fwd_cuda(q, k, v, causal, sm_scale, kv_lengths)
    return _flash_cuda(q, k, v, causal, sm_scale, kv_lengths,
                       flash_fwd_plan(b * h, sq, sk, d, q.dtype))


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
def _flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale, kv_lengths):
    """The plain version of the backward kernels: p = exp(s - lse)
    where the mask allows it and 0 elsewhere, dS = p (dP - delta) scale;
    returns (dQ, dK, dV). In bfloat16 and float16, as the kernels, with
    r() the rounding to the input dtype: dV = r(p)^T dO and dK = r(r(p)
    (dP - delta) scale)^T Q, dQ = r(p (dP - delta) scale) K, fp32 sums,
    each gradient rounded once."""
    b, h, sq, _ = q.shape
    keep = None
    if kv_lengths is not None:
        pos = torch.arange(k.shape[2], device=k.device)
        keep = (pos[None, :] < kv_lengths.long()[:, None])[:, None, None, :]
    s, allowed = _attention_scores(q, k, causal, sm_scale, keep)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if allowed is not None:
        p = torch.where(allowed, p, torch.zeros_like(p))
    dof = do.float()
    if q.dtype == torch.float32:
        pk = p
    else:
        pk = p.to(q.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", pk, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float()) \
        - delta.reshape(b, h, sq, 1)
    ds = pk * dp * sm_scale
    if q.dtype == torch.float32:
        dsq = ds
    else:
        ds, dsq = (t.to(q.dtype).float() for t in (ds, p * dp * sm_scale))
    dq = torch.einsum("bhqk,bhkd->bhqd", dsq, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_args(q, k, v, do, lse, delta, kv_lengths):
    b, h, sq, sk, d = _flash_args(q, k, v, kv_lengths)
    _check(do.shape == q.shape and do.dtype == q.dtype
           and do.is_contiguous(),
           f"flash_attention_bwd takes a contiguous dO shaped as q, of q's "
           f"dtype {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(t.shape == (b * h, sq) and t.dtype == torch.float32
               and t.is_contiguous(),
               f"flash_attention_bwd takes a contiguous float32 {name} of "
               f"shape (B*H, Sq) = {(b * h, sq)}")
    return b, h, sq, sk, d


def _bwd_pointers(q, k, v, do, lse, delta, kv_lengths):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if kv_lengths is None else kv_lengths.data_ptr())


# query rows per tile of the fused backward kernel; query rows per block
# and keys per tile of the dQ kernel (`csrc/flash_bwd.cu` kBQ, kDqBQ,
# kDqBK)
_BWD_BQ = 32
_BWD_DQ_TILE = 64
# the bf16 kernels (wgmma): query rows per tile of the dK/dV kernel, keys
# per dK/dV block at most (64 a warpgroup), keys per tile and queries per
# block (one warpgroup) of the dQ kernel (`csrc/flash_bwd.cu` kBf16BQ,
# kBf16MaxBK, kBf16DqBK, kBf16DqBQ)
_BF16_BWD_BQ = 64
_BF16_BWD_MAX_BK = 128
_BF16_DQ_BK = 64
_BF16_DQ_BQ = 64


def _flash_bwd_plan_bf16(sk, d):
    """`flash_bwd_plan` in bfloat16 or float16 (one kernel template, both
    2 bytes): the wgmma kernels' tiles in the
    128-byte swizzle, so D pads to 64 or 128 (one or two swizzle atoms);
    a warpgroup owns 64 keys of a dK/dV block, two of them at DP = 64
    and one at DP = 128 (its dK and dV accumulators take 128 registers a
    thread), and a dQ block is one warpgroup of 64 queries; the rings
    hold three tiles at DP = 64 and two at DP = 128 (`bf16_stages`)."""
    dp = 64 if d <= 64 else 128
    bk_max = _BF16_BWD_MAX_BK if dp == 64 else 64
    fused = sk <= bk_max
    bk = 64 * -(-sk // 64) if fused else bk_max
    bq, stages = _BF16_BWD_BQ, 3 if dp == 64 else 2
    bars = 8 * (2 * stages + 1)   # the rings' full / empty mbarriers + one
    # 1024 to align the swizzled tiles; K and V; the ring's Q and dO
    # tiles and fp32 lse and delta (slots of bq + 32 entries: a TMA box
    # starts on a 16-byte boundary and lands on a 128-byte one); fused,
    # the tile's bf16 dS
    smem = 1024 + 2 * (2 * bk * dp + 2 * stages * bq * dp
                       + (bq * bk if fused else 0)) \
        + 4 * 2 * stages * (bq + 32) + bars
    # 1024; the block's Q and dO rows; the ring's K and V tiles
    dq_smem = None if fused else 1024 + 2 * (
        2 * _BF16_DQ_BQ * dp + 2 * stages * _BF16_DQ_BK * dp) + bars
    return dict(path="fused" if fused else "split", dp=dp, bk=bk, bq=bq,
                warpgroups=bk // 64, stages=stages, smem=smem,
                dq_smem=dq_smem)


def flash_bwd_plan(sk, d, dtype=torch.float32):
    """The launch plan of the flash backward kernels in `dtype` (float32,
    bfloat16 or float16) for Sk keys of width D (it does not depend on
    Sq):

      dp     D zero-padded in shared memory (fp32: 32, 64, 96 or 128;
             bf16 and fp16: 64 or 128)
      bk     keys per fused block (fp32: one warp per 16; bf16 and fp16:
             one warpgroup per 64)
      bq     query rows per tile of the fused kernel
      path   "fused" when Sk <= the largest block (128 keys for
             D <= 64, else 64): one block holds every key of its (b, h)
             and one launch writes dQ, dK and dV; "split" above that:
             the fused kernel writes dK and dV, then the dQ kernel runs
      smem, dq_smem   dynamic shared bytes of the fused kernel and of
             the dQ kernel (None on the fused path): their K / V / Q / dO
             tiles (rows of `_tile_row`; bf16: 128-byte swizzled rows of
             DP and 1024 bytes to align them), fp32 lse and delta, and the
             fused kernel's dS (queries x keys + pad, fp32; 16-bit in
             the bfloat16 and float16 forms); the kernels recompute them
             and refuse a plan that disagrees.
      16-bit only: warpgroups (bk / 64) and stages (of the ring the
             query tiles, or the dQ kernel's key tiles, stream through)
    """
    _check(0 < d <= 128 and sk > 0,
           f"flash backward takes 0 < D <= 128 and Sk > 0, got {d}, {sk}")
    _check(dtype in _ATTN_DTYPES, f"flash backward has no {dtype} form")
    if dtype != torch.float32:
        return _flash_bwd_plan_bf16(sk, d)
    dp = 32 * -(-d // 32)
    row = _tile_row(dp)
    bk_max = 128 if dp <= 64 else 64
    fused = sk <= bk_max
    bk = 16 * -(-sk // 16) if fused else bk_max
    smem = (2 * bk + 4 * _BWD_BQ) * row + 4 * 4 * _BWD_BQ \
        + (4 * _BWD_BQ * (bk + 4) if fused else 0)
    dq_smem = None if fused else 6 * _BWD_DQ_TILE * row \
        + 4 * 2 * _BWD_DQ_TILE
    return dict(path="fused" if fused else "split", dp=dp, bk=bk,
                bq=_BWD_BQ, smem=smem, dq_smem=dq_smem)


def _vec_copies(d, *tensors):
    """The kernels copy rows in 16-byte pieces (the 16-bit flash forms:
    by TMA) when a row is a whole number of them (D % 4 == 0 in fp32, D %
    8 == 0 in bf16 and fp16) and every base address is 16-byte aligned,
    else element by element."""
    return int(d * tensors[0].element_size() % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _flash_bwd_fused_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                          kv_lengths, plan):
    """The fused kernel on the arguments `flash_attention_bwd` checked:
    (dQ, dK, dV) on the plan's fused path, (None, dK, dV) on its split
    path."""
    b, h, sq, d = q.shape
    with_dq = plan["path"] == "fused"
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq = torch.empty_like(q) if with_dq else None
    lib = _build.library()
    sfx = _suffix(q.dtype)
    fn = getattr(lib, "mxtt_flash_bwd" + (sfx or "_f32"))
    with torch.cuda.device(q.device):
        rc = fn(
            *_bwd_pointers(q, k, v, do, lse, delta, kv_lengths),
            None if dq is None else dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, k.shape[2], d, int(causal),
            float(sm_scale), plan["bk"], int(with_dq),
            _vec_copies(d, q, k, v, do), plan["smem"],
            torch.cuda.current_stream().cuda_stream)
    _launched("flash_bwd" + sfx, rc)
    return dq, dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                       kv_lengths, plan):
    """The dQ kernel of the plan's split path, on the arguments
    `flash_attention_bwd` checked."""
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    lib = _build.library()
    sfx = _suffix(q.dtype)
    fn = getattr(lib, "mxtt_flash_bwd_dq" + (sfx or "_f32"))
    with torch.cuda.device(q.device):
        rc = fn(
            *_bwd_pointers(q, k, v, do, lse, delta, kv_lengths),
            dq.data_ptr(), b, h, sq, k.shape[2], d, int(causal),
            float(sm_scale), _vec_copies(d, q, k, v, do), plan["dq_smem"],
            torch.cuda.current_stream().cuda_stream)
    _launched("flash_bwd_dq" + sfx, rc)
    return dq


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None, kv_lengths=None):
    """Attention backward from the forward's saved lse: (dQ, dK, dV).
    do: (B, H, Sq, D) output gradient; lse, delta: (B*H, Sq) fp32, with
    delta = rowsum(dO * O) (a caller may shift it, as the JAX package's
    `flash_block_attention` does to fold in an lse gradient). The dK and
    dV rows of keys at or past kv_lengths[b] are exactly 0. On the card
    one fused launch writes all three when Sk fits one block
    (`flash_bwd_plan`), else the fused kernel writes dK / dV and the dQ
    kernel follows; heads wider than 128 launch the wide dK/dV kernel,
    then the wide dQ kernel (`csrc/flash_wide.cu`)."""
    dev = _device_of(q, k, v, do, lse, delta, kv_lengths)
    _, _, _, sk, d = _flash_bwd_args(q, k, v, do, lse, delta, kv_lengths)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if dev.type != "cuda":
        return _flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale,
                                kv_lengths)
    if d > _NARROW_MAX_D:
        return _flash_wide_bwd_cuda(q, k, v, do, lse, delta, causal,
                                    sm_scale, kv_lengths)
    args = (q, k, v, do, lse, delta, causal, sm_scale, kv_lengths,
            flash_bwd_plan(sk, d, q.dtype))
    dq, dk, dv = _flash_bwd_fused_cuda(*args)
    if dq is None:
        dq = _flash_bwd_dq_cuda(*args)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wide heads (D > 128, any width): csrc/flash_wide.cu
# ---------------------------------------------------------------------------
# the wgmma forms (bf16, fp16): threads a block (two consumer
# warpgroups), query rows of a forward block, keys of a forward or dQ
# tile and of a dK/dV block, queries of a dK/dV tile and of a dQ block,
# 64-column swizzle atoms of a resident tile and of a chunk of output
# columns, ring stages at most (`csrc/flash_wide.cu` kTcThreads, kTcRows,
# kTcBK, kTcBQ, kTcAtoms, kTcMaxStages); the fp32 forms (split TF32 on
# mma.sync): warps a block (16 rows each), keys of a forward or dQ tile,
# queries of a dK/dV tile, columns of a piece of D and of a chunk of
# output columns (kF32Warps, kF32BK, kF32BQ, kF32PW, kF32DC)
_WIDE_TC_THREADS, _WIDE_TC_ROWS, _WIDE_TC_BK, _WIDE_TC_BQ = 256, 128, 64, 64
_WIDE_TC_ATOMS, _WIDE_TC_MAX_STAGES = 4, 6
_WIDE_F32_WARPS, _WIDE_F32_BK, _WIDE_F32_BQ = 4, 32, 32
_WIDE_F32_PW, _WIDE_F32_DC = 64, 128
# the fp32 forward keeps its Q rows in shared memory to this D
# (`csrc/flash_wide.cu` kF32QResMaxD)
_WIDE_F32_QRES_MAX_D = 320
_ATOM_ELEMS = 64 * 64    # elements of a 64-row atom


def _wide_tc_smem(fixed, stage, stages):
    """`tc_smem`: 1024 bytes to align the swizzled tiles, the fixed
    buffers, the ring's stages, a full and an empty mbarrier a stage and
    one more (the forward's Q, the dK/dV kernel's K and V, the dQ
    kernel's Q and dO)."""
    return 1024 + fixed + stages * stage + 8 * (2 * stages + 1)


def _wide_tc_plan(d, kind, bh, rows, causal=False):
    """The wgmma kernel's plan (`tc_mode`, `tc_fwd_plan` / `tc_dkv_plan`
    / `tc_dq_plan`): "resident" while D fits four atoms (every tile holds
    all of D, zero-padded to 256), "split" to eight (the forward's Q
    rows, the dK/dV kernel's K and V rows, the dQ kernel's Q and dO rows
    stay; the other side comes in pieces), "streamed" above (an atom of
    each side a stage); the output's columns in chunks of four atoms; the
    most stages (up to 6) that fit 227 KB. A causal resident forward
    splits the keys (`key_split`): a block owns 64 query rows and its
    warpgroups walk alternate key tiles, merging at the end, so the
    causal grid's longest blocks take half as long."""
    la = -(-d // 64)
    mode = "resident" if la <= _WIDE_TC_ATOMS else (
        "split" if la <= 2 * _WIDE_TC_ATOMS else "streamed")
    tile = 2 * 64 * 64 * _WIDE_TC_ATOMS          # bytes of 64 rows x 4 atoms
    key_split = kind == "fwd" and causal and mode == "resident"
    if kind == "fwd":
        # Q's 128 rows (the key split: 64): resident 4 atoms, split 8,
        # streamed none; a stage: resident K and V, split half of K's
        # atoms or the chunk's V, streamed Q's and K's atom (128 + 64
        # rows) or the chunk's V
        fixed = dict(resident=2 * tile, split=4 * tile, streamed=0)[mode]
        if key_split:
            fixed //= 2
        stage = dict(resident=2 * tile, split=tile, streamed=2 * max(
            (_WIDE_TC_ROWS + _WIDE_TC_BK) * 64,
            _WIDE_TC_BK * 64 * _WIDE_TC_ATOMS))[mode]
        block = _WIDE_TC_ROWS // 2 if key_split else _WIDE_TC_ROWS
        # O: 64 rows x 4 atoms of fp32 over a warpgroup's 128 threads
        regs = dict(o=64 * 64 * _WIDE_TC_ATOMS // 128)
    else:
        # dK/dV: two buffers each of P^T and dS^T (64 x 64 of the type);
        # dQ: the p exchange (64 x 64 fp32) and dS (64 x 64 of the type);
        # then the resident side's 64 rows (dK/dV: K and V; dQ: Q and
        # dO): resident 4 atoms, split 8, streamed none; a stage:
        # resident the other side (dK/dV: a query tile's Q and dO; dQ: a
        # key tile's K and V), split two atoms of each, streamed an atom
        # of K, Q, V and dO, or the chunk's columns of dK/dV's Q and dO
        # (a warpgroup's half a stage) or of dQ's K
        pt = 2 * 2 * 2 * _ATOM_ELEMS if kind == "dkv" \
            else (4 + 2) * _ATOM_ELEMS
        fixed = pt + dict(resident=2 * tile, split=4 * tile,
                          streamed=0)[mode]
        stage = 2 * tile if mode == "resident" else 2 * 4 * _ATOM_ELEMS
        # a dK/dV block's keys, a dQ block's queries
        block = _WIDE_TC_BK if kind == "dkv" else _WIDE_TC_BQ
        # each warpgroup its half (two atoms) of dK and of dV, or of dQ
        half = 64 * 64 * _WIDE_TC_ATOMS // 2 // 128
        regs = dict(dk=half, dv=half) if kind == "dkv" else dict(dq=half)
    stages = _WIDE_TC_MAX_STAGES
    while stages > 1 and _wide_tc_smem(fixed, stage, stages) > _SMEM_LIMIT:
        stages -= 1
    chunks = -(-la // _WIDE_TC_ATOMS)
    return dict(kind="wgmma", mode=mode, key_split=key_split, atoms=la,
                chunks=chunks, stages=stages,
                smem=_wide_tc_smem(fixed, stage, stages),
                threads=_WIDE_TC_THREADS,
                grid=(bh, -(-rows // block), chunks), regs=regs)


def _wide_f32_plan(d, kind, bh, rows):
    """The fp32 kernel's plan (`f32_ok`): 64 rows (keys) a block of four
    warps, chunks of 128 output columns; shared rows of a piece (64
    columns) and of a chunk (128) padded by 4 floats (`pitch_of`): the
    forward its 64 Q rows (D padded to whole pieces; above D = 320 a
    piece of them), a piece of a 32-key tile's K rows and the tile's V
    rows in the chunk's columns, the dK/dV kernel a piece of its 64 K and
    V rows and of a 32-query tile's Q and dO rows, the dQ kernel a piece
    of its 64 Q and dO rows and of a 32-key tile's K and V rows; no
    ring."""
    rows_b = 16 * _WIDE_F32_WARPS
    pp, cp = _WIDE_F32_PW + 4, _WIDE_F32_DC + 4
    chunks = -(-d // _WIDE_F32_DC)
    if kind == "fwd":
        qp = _WIDE_F32_PW * -(-d // _WIDE_F32_PW) + 4 \
            if d <= _WIDE_F32_QRES_MAX_D else pp
        smem = 4 * (rows_b * qp + _WIDE_F32_BK * pp + _WIDE_F32_BK * cp)
        # O: 16 rows x 128 columns of fp32 over a warp's 32 lanes
        regs = dict(o=16 * _WIDE_F32_DC // 32)
    elif kind == "dkv":
        smem = 4 * 2 * (rows_b + _WIDE_F32_BQ) * pp
        regs = dict(dk=16 * _WIDE_F32_DC // 32, dv=16 * _WIDE_F32_DC // 32)
    else:
        smem = 4 * 2 * (rows_b + _WIDE_F32_BK) * pp
        regs = dict(dq=16 * _WIDE_F32_DC // 32)
    return dict(kind="mma", piece=_WIDE_F32_PW, chunks=chunks, stages=0,
                smem=smem, threads=32 * _WIDE_F32_WARPS,
                grid=(bh, -(-rows // rows_b), chunks), regs=regs)


def flash_wide_plan(d, dtype=torch.float32, bh=1, sq=1, sk=1, causal=False):
    """The launch plans of the wide kernels (`csrc/flash_wide.cu`) for
    B*H = `bh` slices of `sq` queries over `sk` keys, heads of width `d`
    (any D > 0; `flash_attention` sends them D > 128), `causal` or not,
    in `dtype`:
    {"fwd": ..., "dkv": ..., "dq": ...}, each with

      kind    "wgmma" (bf16 and fp16: TMA rings, two warpgroups) or "mma"
              (fp32: split TF32 on mma.sync, D in pieces of 64 columns)
      chunks  blocks a row block's output columns split over (the grid's
              z axis): four atoms (256 columns) a chunk on wgmma, 128
              columns in fp32; each chunk recomputes S (and dP) over D
      stages  the TMA ring's stages (0 in fp32)
      smem    dynamic shared bytes; the kernel recomputes chunks, stages
              and bytes and refuses a plan that disagrees
      threads, grid
      regs    fp32 accumulator registers a thread: the forward's O (D / 2
              at D = 256 on wgmma, 64 for fp32's 128 columns), dK and dV
              (each warpgroup's halves, 64 + 64), dQ (64: a warpgroup's
              half of a wgmma chunk, a warp's 16 rows of an fp32 one)
      wgmma only: mode ("resident" to D = 256, "split" to 512, else
              "streamed"), atoms (ceil(D / 64)), key_split (the causal
              resident forward: 64 rows a block, the keys split between
              its warpgroups)

    The dQ kernel's block is 64 queries, the heaviest causal blocks
    launched first: on wgmma warpgroup 0 computes S, warpgroup 1 dP, p
    goes to 1 in fp32 and dS back as 16-bit through shared memory, and
    each adds dS K into its half of the chunk's columns; in fp32 each
    warp its 16 rows' S, dP and dS K in registers.
    """
    _check(d > 0 and bh > 0 and sq > 0 and sk > 0,
           f"flash_wide_plan takes D > 0 and a non-empty input, got D {d}, "
           f"B*H {bh}, Sq {sq}, Sk {sk}")
    _check(dtype in _ATTN_DTYPES, f"the wide kernels have no {dtype} form")
    if dtype == torch.float32:
        return dict(fwd=_wide_f32_plan(d, "fwd", bh, sq),
                    dkv=_wide_f32_plan(d, "dkv", bh, sk),
                    dq=_wide_f32_plan(d, "dq", bh, sq))
    return dict(fwd=_wide_tc_plan(d, "fwd", bh, sq, causal),
                dkv=_wide_tc_plan(d, "dkv", bh, sk),
                dq=_wide_tc_plan(d, "dq", bh, sq))


def _wide_fn(lib, name, dtype):
    return getattr(lib, name + (_suffix(dtype) or "_f32"))


def _wide_plan_args(plan, vec):
    """What an entry takes after its tensors and sizes: chunks, stages,
    vec, shared bytes."""
    return plan["chunks"], plan["stages"], vec, plan["smem"]


def _flash_wide_fwd_cuda(q, k, v, causal, sm_scale, kv_lengths):
    """The wide forward kernel on the arguments `flash_attention_fwd`
    checked, launched as `flash_wide_plan` says."""
    b, h, sq, d = q.shape
    plan = flash_wide_plan(d, q.dtype, b * h, sq, k.shape[2], causal)["fwd"]
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    fn = _wide_fn(_build.library(), "mxtt_flash_wide_fwd", q.dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_lengths is None else kv_lengths.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, h, sq, k.shape[2], d,
                int(causal), float(sm_scale),
                *_wide_plan_args(plan, _vec_copies(d, q, k, v)),
                torch.cuda.current_stream().cuda_stream)
    _launched("flash_wide_fwd" + _suffix(q.dtype), rc)
    return out, lse


def _flash_wide_bwd_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                         kv_lengths):
    """The wide dK/dV kernel, then the wide dQ kernel, on the arguments
    `flash_attention_bwd` checked, as `flash_wide_plan` says."""
    b, h, sq, d = q.shape
    plans = flash_wide_plan(d, q.dtype, b * h, sq, k.shape[2])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lib = _build.library()
    ptrs = _bwd_pointers(q, k, v, do, lse, delta, kv_lengths)
    sfx = _suffix(q.dtype)
    vec = _vec_copies(d, q, k, v, do)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _wide_fn(lib, "mxtt_flash_wide_bwd_dkv", q.dtype)(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2], d,
            int(causal), float(sm_scale),
            *_wide_plan_args(plans["dkv"], vec), stream)
        _launched("flash_wide_bwd_dkv" + sfx, rc)
        rc = _wide_fn(lib, "mxtt_flash_wide_bwd_dq", q.dtype)(
            *ptrs, dq.data_ptr(), b, h, sq, k.shape[2], d, int(causal),
            float(sm_scale), *_wide_plan_args(plans["dq"], vec), stream)
        _launched("flash_wide_bwd_dq" + sfx, rc)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward, keeping what the backward needs;
    backward: delta in torch, then `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale,
                                       kv_lengths)
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lengths = ctx.saved_tensors
        b, h, sq, _ = q.shape
        # autograd hands back views (the heads merge is a transpose)
        do = dout.contiguous()
        delta = (out.float() * do.float()).sum(-1).reshape(b * h, sq)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta,
                                         ctx.causal, ctx.sm_scale,
                                         kv_lengths)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, kv_lengths=None):
    """Fused attention, differentiable in q, k and v. q: (B, H, Sq, D);
    k, v: (B, H, Sk, D) -> (B, H, Sq, D). See `flash_attention_fwd`.
    Under `torch.no_grad()` (serving) only the forward kernel runs."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, kv_lengths, causal, sm_scale)


# ---------------------------------------------------------------------------
# flash block attention: (out, lse) with gradients through both
# ---------------------------------------------------------------------------
def _block_plain_fwd(q, k, v, causal, sm_scale):
    """The plain block forward in bfloat16 / float16, rounded where the
    JAX package's `_block_fwd_xla` rounds: S and lse in fp32, p = exp(s -
    lse) rounded to the input dtype for P V (fp32 sums), out rounded
    once; (out, lse (B*H, Sq)). A row with no visible key is zeros, as
    in the kernels."""
    b, h, sq, _ = q.shape
    s, allowed = _attention_scores(q, k, causal, sm_scale, None)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if allowed is not None:
        p = p * allowed.any(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), lse.reshape(b * h, sq)


class _FlashBlock(torch.autograd.Function):
    """Forward: the flash forward, keeping its lse as an output; backward:
    the flash backward with delta = rowsum(dO * O) - g_lse. Since
    d lse / d s = p, an lse cotangent adds g_lse * p to dS = p (dP -
    delta), which is the same as shifting delta by -g_lse (the JAX
    package's `delta_shift`, `pallas_kernels.py:563-566`). On the card
    every dtype runs the flash kernels (their rounding points); on the
    CPU bfloat16 and float16 round where `_block_fwd_xla` /
    `_block_bwd_xla` do: the forward `_block_plain_fwd`, the backward the
    fp32 plain version on the widened inputs, each gradient cast once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        b, h, sq, _ = q.shape
        dev = _device_of(q, k, v)
        _flash_args(q, k, v, None)
        on_card = dev.type == "cuda"
        if on_card or q.dtype == torch.float32:
            out, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        else:
            out, lse = _block_plain_fwd(q, k, v, causal, sm_scale)
        if on_card:
            LAUNCHES["flash_block" + _suffix(q.dtype)] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse.view(b, h, sq)

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # a cotangent the loss does not reach arrives as zeros (Ulysses
        # drops lse; a ring of one rank gives it a zero gradient), and
        # autograd may hand back a view
        do = dout.contiguous()
        delta = (out.float() * do.float()).sum(-1).reshape(lse.shape) \
            - dlse.float().reshape(lse.shape)
        if _device_of(q, k, v).type == "cuda" or q.dtype == torch.float32:
            dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta,
                                             ctx.causal, ctx.sm_scale)
        else:
            _flash_bwd_args(q, k, v, do, lse, delta, None)
            dq, dk, dv = (g.to(q.dtype) for g in _flash_bwd_plain(
                q.float(), k.float(), v.float(), do.float(), lse, delta,
                ctx.causal, ctx.sm_scale, None))
        return dq, dk, dv, None, None


def flash_block_attention(q, k, v, causal=False, sm_scale=None):
    """Attention of q over ONLY these keys, with its row log-sum-exp:
    (out (B, H, Sq, D), lse (B, H, Sq) fp32), differentiable through
    both. q: (B, H, Sq, D); k, v: (B, H, Sk, D), contiguous, of one
    dtype (float32, bfloat16 or float16): out in q's dtype, lse fp32.
    Partials over disjoint key sets merge exactly:

        lse = logaddexp(lse_a, lse_b)
        out = out_a * exp(lse_a - lse) + out_b * exp(lse_b - lse)

    the combine of `parallel.ring_attention`. On the card the forward is
    one launch of the flash forward in q's dtype (`csrc/flash_fwd.cu`,
    or `flash_wide.cu` above D = 128) and the backward the flash backward
    kernels (`flash_bwd_plan`); each forward on the card adds one to
    `LAUNCHES["flash_block"]` (`flash_block_bf16`, `flash_block_f16` in
    16 bits). On the CPU the plain versions run (the
    counterparts of `_block_fwd_xla` / `_block_bwd_xla`, rounding where
    they round in bfloat16 and float16).

    A row with no visible key is zeros here (the kernels' convention),
    where the JAX package's XLA form spreads p uniformly (ROADMAP.md,
    Queue 3 #4). Neither caller makes such a row: a ring's causal block
    is its diagonal one, whose query i sees key i, and the blocks past
    it are skipped."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashBlock.apply(q, k, v, causal, sm_scale)


# ---------------------------------------------------------------------------
# single-query cached attention + ragged paged attention
# ---------------------------------------------------------------------------
def single_query_cached_attention(qh, kc, vc, mask=None):
    """Attention of a single query token over a cached context — the
    decode-path math the paged self-attention (plain version) and the
    cross-attention share.

    qh: (B, H, 1, dh); kc/vc: (B, H, L, dh); mask: boolean broadcastable
    to (B, H, 1, L), True = attend (None = attend everywhere). Returns
    (B, H, 1, dh). fp32 scores and softmax, output in the value dtype."""
    dh = qh.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kc).float() / math.sqrt(dh)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = _masked_softmax(s, mask).to(vc.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vc)


def _dequant_gathered(pages, page_tables, scales, dtype):
    """Gather (S, npages, psize, H, dh) pages; with per-page (P, H)
    `scales` (int8 pages) dequantize the gathered context — never the
    whole pool — into `dtype`."""
    idx = page_tables.long()
    ctx = pages[idx]
    if scales is not None:
        ctx = ctx.to(dtype) * scales[idx][:, :, None, :, None]
    return ctx


def _gathered_context(q, k_pages, v_pages, page_tables, k_scales,
                      v_scales):
    """Each slot's pages as dense (S, H, L, dh) K and V contexts."""
    S, H, dh = q.shape[0], q.shape[-2], q.shape[-1]
    L = page_tables.shape[1] * k_pages.shape[1]
    kc = _dequant_gathered(k_pages, page_tables, k_scales, q.dtype) \
        .reshape(S, L, H, dh).transpose(1, 2)
    vc = _dequant_gathered(v_pages, page_tables, v_scales, q.dtype) \
        .reshape(S, L, H, dh).transpose(1, 2)
    return kc, vc, L


def _paged_attention_plain(q, k_pages, v_pages, page_tables, lengths,
                           k_scales=None, v_scales=None):
    """Plain version of the 1-wide paged kernels: gather each slot's
    pages into a dense context (dequantized with the (P, H) scales for
    int8 pages), then the shared single-query math. q: (S, H, dh);
    k_pages/v_pages: (P, psize, H, dh); page_tables: (S, npages) int32;
    lengths: (S,) int32 visible positions (the current token included).
    Returns (S, H, dh)."""
    kc, vc, L = _gathered_context(q, k_pages, v_pages, page_tables,
                                  k_scales, v_scales)
    pos = torch.arange(L, device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    return single_query_cached_attention(q[:, :, None, :], kc, vc,
                                         mask)[:, :, 0]


def _paged_attention_plain_multi(q, k_pages, v_pages, page_tables, lengths,
                                 k_scales=None, v_scales=None):
    """Plain version of the widened paged kernels: the gathered context
    of `_paged_attention_plain` and one more query axis. q: (S, W, H,
    dh), any W query tokens per slot at consecutive positions; query i
    sees `lengths + i` keys. Returns (S, W, H, dh)."""
    W = q.shape[1]
    kc, vc, L = _gathered_context(q, k_pages, v_pages, page_tables,
                                  k_scales, v_scales)
    vis = lengths.long()[:, None] + torch.arange(W, device=q.device)[None]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < vis[:, :, None])[:, None, :, :]          # (S, 1, W, L)
    out = single_query_cached_attention(q.transpose(1, 2), kc, vc, mask)
    return out.transpose(1, 2)


def _rpa_args(q, k_pages, v_pages, page_tables, lengths, k_scales,
              v_scales):
    """What the kernels take, checked on either device: (S, W, H, dh,
    psize, page / row / head strides); W is 1 for a 3-D q."""
    _check((k_scales is None) == (v_scales is None),
           "k_scales and v_scales must be given together")
    _check(q.dim() in (3, 4) and k_pages.dim() == 4,
           "ragged_paged_attention takes q (S, H, dh) or (S, W, H, dh) and "
           "pages (P, psize, H, dh)")
    S, H, dh = q.shape[0], q.shape[-2], q.shape[-1]
    W = q.shape[1] if q.dim() == 4 else 1
    P, psize = k_pages.shape[:2]
    _check(k_pages.shape == (P, psize, H, dh)
           and v_pages.shape == k_pages.shape
           and v_pages.stride() == k_pages.stride(),
           f"page pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do "
           f"not match q {tuple(q.shape)}")
    _check(page_tables.dim() == 2 and page_tables.shape[0] == S
           and page_tables.dtype == torch.int32
           and page_tables.is_contiguous(),
           "page_tables must be a contiguous (S, npages) int32 tensor")
    _check(lengths.shape == (S,) and lengths.dtype == torch.int32
           and lengths.is_contiguous(),
           "lengths must be a contiguous (S,) int32 tensor")
    quant = k_scales is not None
    page_dtype = torch.int8 if quant else torch.float32
    _check(q.dtype == torch.float32 and k_pages.dtype == page_dtype
           and v_pages.dtype == page_dtype,
           "ragged_paged_attention kernel takes float32 q, and float32 "
           "pages or int8 pages with k_scales / v_scales")
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check(t.shape == (P, H) and t.dtype == torch.float32
                   and t.is_contiguous(),
                   f"{name} must be a contiguous ({P}, {H}) float32 tensor")
    _check(q.is_contiguous(), "ragged_paged_attention takes a contiguous q")
    _check(W >= 1,
           f"ragged_paged_attention takes W >= 1 query rows per slot, got "
           f"{W}")
    _check(0 < dh <= 128 and dh % 4 == 0,
           f"ragged_paged_attention kernel takes dh % 4 == 0, dh <= 128, "
           f"got {dh}")
    # the kernels load 4 elements at a time: a float4 (16 bytes) or, for
    # int8 pages, a char4 (4 bytes); strides in elements must keep every
    # row's start aligned to that
    sp, so, sh, sd = k_pages.stride()
    _check(sd == 1 and sp % 4 == 0 and so % 4 == 0 and sh % 4 == 0
           and k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
           "page pools need unit stride on dh and rows aligned to 4 "
           "elements")
    _check(S * H > 0 and page_tables.shape[1] > 0,
           "ragged_paged_attention: empty input")
    return S, W, H, dh, psize, sp, so, sh


# the 1-wide kernels (`csrc/ragged_paged_attention.cu` kPosLanes,
# kMaxBlockWarps): lanes scoring one position, warps a block at most; a
# warp takes 32 / kPosLanes positions of a chunk
_RPA_POS_LANES, _RPA_MAX_WARPS = 8, 8
_RPA_WARP_POSITIONS = 32 // _RPA_POS_LANES


def rpa_plan(s, h, dh, psize, npages):
    """The launch plan of the 1-wide paged kernels for S = `s` slots of
    `h` heads of width `dh` over tables of `npages` pages of `psize`
    positions; a function of these only, so a shape always takes the
    same order of sums:

      blocks  one per (slot, head)
      warps   the fewest (a power of two, at most 8) whose chunk of 4
              positions a warp covers the table's npages * psize
      smem    dynamic shared bytes (the kernel's `rpa1_smem`): the warps'
              (m, l) and accumulators for the merge; the kernel refuses a
              plan that disagrees
    """
    cap = npages * psize
    warps = 1
    while warps < _RPA_MAX_WARPS and _RPA_WARP_POSITIONS * warps < cap:
        warps *= 2
    return dict(blocks=s * h, warps=warps, smem=4 * warps * (2 + dh))


# the widened kernels (`csrc/ragged_paged_attention.cu` kGroupRows): query
# rows a block scores together
_RPA_GROUP_ROWS = 4


def rpa_multi_plan(s, w, h, dh, psize, npages):
    """The launch plan of the widened paged kernels for S = `s` slots of
    a window of `w` >= 2 query rows, `h` heads of width `dh`, over tables
    of `npages` pages of `psize` positions; a function of these only:

      blocks  (s * h, groups): one per (slot, head, group of 4 rows), the
              window's groups on the grid's y axis
      warps   `rpa_plan`'s: each row of a group sums as the 1-wide
              kernel does
      smem    dynamic shared bytes (the kernel's `rpa_multi_smem`): the
              warps' (m, l) and accumulators of a group's rows; the
              kernel refuses a plan that disagrees
    """
    warps = rpa_plan(s, h, dh, psize, npages)["warps"]
    groups = -(-w // _RPA_GROUP_ROWS)
    return dict(blocks=(s * h, groups), warps=warps,
                smem=4 * warps * _RPA_GROUP_ROWS * (2 + dh))


def _rpa_cuda(q, k_pages, v_pages, page_tables, lengths, sm_scale,
              k_scales, v_scales):
    """Launch the one of the four kernels that the query window and the
    page type select: a window of one row (a 3-D q, or a 4-D q with W =
    1) the 1-wide kernel, as `rpa_plan` says; W >= 2 the widened one, as
    `rpa_multi_plan` says."""
    S, W, H, dh, psize, sp, so, sh = _rpa_args(
        q, k_pages, v_pages, page_tables, lengths, k_scales, v_scales)
    out = torch.empty_like(q)
    lib = _build.library()
    quant = k_scales is not None
    wide = W > 1
    npages = page_tables.shape[1]
    name = "ragged_paged_attention" + ("_multi" if wide else "") \
        + ("_int8" if quant else "")
    fn = getattr(lib, "mxtt_rpa" + ("_multi" if wide else "")
                 + ("_i8" if quant else "_f32"))
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr()]
    if wide:
        p = rpa_multi_plan(S, W, H, dh, psize, npages)
        dims, plan = [S, W, H], [p["warps"], p["smem"]]
    else:
        # a contiguous (S, 1, H, dh) q and out are (S, H, dh) in memory
        p = rpa_plan(S, H, dh, psize, npages)
        dims, plan = [S, H], [p["warps"], p["smem"]]
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, *dims, dh, psize, npages, sp, so, sh,
                float(sm_scale), *plan,
                torch.cuda.current_stream().cuda_stream)
    _launched(name, rc)
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_tables, lengths,
                           sm_scale=None, k_scales=None, v_scales=None):
    """One shared attention launch per decode step over a paged KV cache.

    q: (S, H, dh) — one query token per decode slot — or (S, W, H, dh):
    any W >= 1 query tokens per slot at consecutive positions (speculative
    verification), where query i of a slot sees `lengths + i` keys and
    rows past a slot's real window compute values nobody reads.
    k_pages/v_pages: (P, psize, H, dh) page pools, float32, or int8 with
    `k_scales`/`v_scales` (P, H) float32 per-page/per-head dequant
    scales; page_tables: (S, npages) int32 page ids per slot (unused
    entries point at the reserved null page 0); lengths: (S,) int32
    visible positions per slot INCLUDING the current (first) token.
    Returns (S, H, dh) or (S, W, H, dh).

    On CUDA tensors one of four kernels launches (1-wide, for a 3-D q or
    W = 1, or widened; float32 or int8 pages); on CPU tensors the plain
    versions run."""
    dev = _device_of(q, k_pages, v_pages, page_tables, lengths, k_scales,
                     v_scales)
    if dev.type == "cuda":
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(q.shape[-1])
        return _rpa_cuda(q, k_pages, v_pages, page_tables, lengths,
                         sm_scale, k_scales, v_scales)
    _rpa_args(q, k_pages, v_pages, page_tables, lengths, k_scales, v_scales)
    if sm_scale is not None:
        q = q * (sm_scale * math.sqrt(q.shape[-1]))
    plain = _paged_attention_plain_multi if q.dim() == 4 \
        else _paged_attention_plain
    return plain(q, k_pages, v_pages, page_tables, lengths, k_scales,
                 v_scales)


# ---------------------------------------------------------------------------
# fused layer norm
# ---------------------------------------------------------------------------
def _ln_plain(x2, gamma, beta, eps):
    """The plain version of the LayerNorm kernel over (rows, D): mean
    first, then the centred variance, fp32 statistics (the formula of
    `_ln_kernel`), y in fp32 rounded once to x's dtype. Returns (y, mean
    (rows,), rstd (rows,))."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xc * rstd) * gamma.float() + beta.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


# x's dtype -> the gamma / beta dtypes its form reads: fp32, or the
# 16-bit type (bf16 weights after cast with fp32 activations; x's own
# type for the 16-bit forms)
_LN_DTYPES = {torch.float32: (torch.float32, torch.bfloat16),
              torch.bfloat16: (torch.float32, torch.bfloat16),
              torch.float16: (torch.float32, torch.float16)}


def _ln_args(x, gamma, beta):
    """What the kernel takes, checked on either device: (rows, D)."""
    _check(x.dim() >= 1 and x.numel() > 0, "layer norm: empty input")
    d = x.shape[-1]
    _check(gamma.shape == (d,) and beta.shape == (d,),
           f"layer norm: gamma {tuple(gamma.shape)} / beta "
           f"{tuple(beta.shape)} must be ({d},)")
    _check(gamma.dtype in _LN_DTYPES.get(x.dtype, ())
           and beta.dtype == gamma.dtype,
           f"layer norm kernel takes float32 x with float32 or bfloat16 "
           f"gamma / beta, or bfloat16 x or float16 x with float32 gamma / "
           f"beta or gamma / beta of x's dtype (gamma and beta of one "
           f"dtype), got {x.dtype}, {gamma.dtype}, {beta.dtype}")
    _check(all(t.is_contiguous() for t in (x, gamma, beta)),
           "layer norm kernel takes contiguous x / gamma / beta")
    return x.numel() // d, d


def _ln_cuda(x2, gamma, beta, eps):
    rows, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    lib = _build.library()
    # gamma / beta in bf16 for the fp32 form, in x's dtype for the others
    ptrs = (x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
            int(gamma.dtype != torch.float32))
    stream = torch.cuda.current_stream().cuda_stream
    sfx = _suffix(x2.dtype)
    with torch.cuda.device(x2.device):
        if x2.dtype == torch.float32:
            rc = lib.mxtt_layer_norm_f32(*ptrs, stream)
        else:
            rc = getattr(lib, "mxtt_layer_norm" + sfx)(
                *ptrs, _vec_copies(d, x2, y, gamma, beta), stream)
    _launched("layer_norm" + sfx, rc)
    return y, mean, rstd


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with its statistics: (y shaped as x,
    mean (rows,), rstd (rows,)), rows = x.numel() / D, fp32 statistics.
    The kernel and the plain version take any rows and any D: float32 x
    (the fp32 kernel) with float32 or bfloat16 gamma / beta (bf16 after
    `cast`, read as fp32), bfloat16 x (the bf16 kernel) with float32 or
    bfloat16, float16 x (the fp16 kernel) with float32 (AMP's) or float16
    (after `cast`); y is in x's dtype."""
    dev = _device_of(x, gamma, beta)
    rows, d = _ln_args(x, gamma, beta)
    x2 = x.reshape(rows, d)
    run = _ln_cuda if dev.type == "cuda" else _ln_plain
    y, mean, rstd = run(x2, gamma, beta, eps)
    return y.reshape(x.shape), mean, rstd


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: the LayerNorm kernel; backward: the closed form of
    `_fused_ln_vjp_bwd` in plain torch (XLA in the JAX package)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        d = x.shape[-1]
        x2 = x.reshape(-1, d).float()
        xhat = (x2 - mean[:, None]) * rstd[:, None]
        dyf = dy.reshape(-1, d).float()
        dgamma = (dyf * xhat).sum(dim=0)
        dbeta = dyf.sum(dim=0)
        dxhat = dyf * gamma.float()
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = (dxhat - m1 - xhat * m2) * rstd[:, None]
        return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis, differentiable in x, gamma and beta:
    the hand-written kernel's forward on the card, its plain version on
    the CPU; the backward is plain torch on both."""
    return _FusedLayerNorm.apply(x, gamma, beta, float(eps))


# ---------------------------------------------------------------------------
# 1x1 convolution with BatchNorm statistics
# ---------------------------------------------------------------------------
_CONV1X1_DTYPES = (torch.float32, torch.bfloat16)
# `csrc/conv1x1_bn_stats.cu`: 8 warps a block as two warpgroups, each 64
# rows x BN columns of y on wgmma (kWarps, kBM). fp32 (split TF32): K
# chunks of 32, 3 ring stages of raw tiles, raw x rows of 32 + 4 and w
# rows of BN + 8 floats (kF32*). bf16: K chunks of 64, 5 stages (kBF16*)
_C1_WARPS, _C1_BM = 8, 128
_C1_F32 = dict(bk=32, stages=3, pad_a=4, pad_b=8)
_C1_BF16 = dict(bk=64, stages=5)


def _conv1x1_smem(bf16, bn):
    """The kernel's `conv_smem`: 1024 bytes to align the swizzled tiles;
    fp32: the ring of raw x and w tiles and the four split planes (x hi /
    lo, w^T hi / lo: BM or BN rows of 128 bytes); bf16: the ring of
    swizzled x and w tiles (128-byte rows); both: the y staging (8 rows
    of BN + 8 a warp) and the warps' column sums (a row each 16 rows)."""
    if bf16:
        c, esize = _C1_BF16, 2
        tiles = c["stages"] * (_C1_BM + bn) * 128
    else:
        c, esize = _C1_F32, 4
        tiles = (4 * c["stages"] * (_C1_BM * (c["bk"] + c["pad_a"])
                                    + c["bk"] * (bn + c["pad_b"]))
                 + 2 * (_C1_BM + bn) * 128)
    return (1024 + tiles + esize * _C1_WARPS * 8 * (bn + 8)
            + 2 * (_C1_BM // 16) * bn * 4)


def conv1x1_plan(m, k, n, dtype):
    """The launch plan of the conv1x1 kernel for x (M, K) @ w (K, N) in
    `dtype`, a function of the shape and dtype only (so a shape always
    sums its statistics in the same order):

      bn      columns a block: 64 or 128 (x is read ceil(N / 128) times,
              from L2 mostly: the blocks of a row tile run side by side)
      bm      rows a block's tile: 128, two warpgroups of 64
      bk      K chunk through shared memory; stages, the cp.async ring
      tiles_n column blocks, ceil(N / bn)
      grid_m  row-tile groups: block (bx, by) walks row tiles bx, bx +
              grid_m, ...; as many as keep grid_m * tiles_n within the
              card's 132 SMs (one block an SM: the plan's shared memory),
              at most the row tiles. Also the scratch's rows
      vec     16-byte copies and stores: K and N multiples of 16 bytes'
              worth of elements (the wrapper also needs aligned bases)
      smem    the block's dynamic shared bytes (the kernel's formula)
    """
    bf16 = dtype == torch.bfloat16
    bn = 64 if n <= 64 else 128
    bm = _C1_BM
    cfg = _C1_BF16 if bf16 else _C1_F32
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    epv = 8 if bf16 else 4
    return dict(bn=bn, bm=bm, bk=cfg["bk"], stages=cfg["stages"],
                tiles_n=tiles_n,
                grid_m=max(1, min(tiles_m, _CARD_SMS // tiles_n)),
                vec=k % epv == 0 and n % epv == 0,
                smem=_conv1x1_smem(bf16, bn))


def _conv1x1_stats_plain(x2d, w):
    """The plain version: the product in fp32, the statistics from the
    fp32 y, then the cast (`pallas_kernels.py:1334-1339`)."""
    yf = x2d.float() @ w.float()
    return yf.to(x2d.dtype), yf.mean(0), (yf * yf).mean(0)


def _conv1x1_args(x2d, w):
    """What the kernel takes, checked on either device: (M, K, N)."""
    _check(x2d.dim() == 2 and w.dim() == 2,
           "conv1x1_bn_stats takes x (M, K) and w (K, N)")
    m, k = x2d.shape
    _check(w.shape[0] == k,
           f"conv1x1_bn_stats: x {tuple(x2d.shape)} and w {tuple(w.shape)} "
           f"do not agree on K")
    _check(x2d.dtype == w.dtype and x2d.dtype in _CONV1X1_DTYPES,
           f"conv1x1_bn_stats takes float32 or bfloat16 x and w of one "
           f"dtype, got {x2d.dtype} and {w.dtype}")
    _check(x2d.is_contiguous() and w.is_contiguous(),
           "conv1x1_bn_stats takes contiguous (row-major) x and w")
    _check(m > 0 and k > 0 and w.shape[1] > 0,
           "conv1x1_bn_stats: empty input")
    return m, k, w.shape[1]


def _conv1x1_cuda(x2d, w):
    m, k, n = _conv1x1_args(x2d, w)
    plan = conv1x1_plan(m, k, n, x2d.dtype)
    grid_m = plan["grid_m"]
    vec = (plan["vec"] and x2d.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    dev = x2d.device
    y = torch.empty((m, n), dtype=x2d.dtype, device=dev)
    part = torch.empty((2, grid_m, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    bf16 = x2d.dtype == torch.bfloat16
    lib = _build.library()
    fn = lib.mxtt_conv1x1_stats_bf16 if bf16 else lib.mxtt_conv1x1_stats_f32
    with torch.cuda.device(dev):
        rc = fn(x2d.data_ptr(), w.data_ptr(), y.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), m, k, n, plan["bn"], grid_m, int(vec),
                plan["smem"], torch.cuda.current_stream().cuda_stream)
    _launched("conv1x1_bn_stats" + ("_bf16" if bf16 else ""), rc)
    return y, stats[0], stats[1]


def conv1x1_bn_stats(x2d, w, bm=1024):
    """A 1x1 convolution as x2d (M, K) @ w (K, N), with BatchNorm's batch
    statistics of the result: (y (M, N) in x's dtype, mean (N,) fp32,
    meansq (N,) fp32), the statistics taken from the fp32 product before
    y is cast. x and w are both float32 or both bfloat16, contiguous.
    `bm` is the JAX signature's row block; the CUDA kernel tiles by
    `conv1x1_plan` and ignores it."""
    dev = _device_of(x2d, w)
    if dev.type == "cuda":
        return _conv1x1_cuda(x2d, w)
    _conv1x1_args(x2d, w)
    return _conv1x1_stats_plain(x2d, w)
