"""Kernels of the serving and training paths, each beside its plain
version.

Counterpart of `mxnet_tpu/ops/pallas_kernels.py`:

  * `flash_attention` — every attention of the model, forward and
    backward, as a `torch.autograd.Function`. Its forward launches
    `csrc/flash_fwd.cu` (replaces `_flash_fwd_kernel`) and keeps q, k, v,
    the output and the row log-sum-exp; its backward launches the two
    kernels of `csrc/flash_bwd.cu` (replace `_flash_bwd_dkv_kernel` and
    `_flash_bwd_dq_kernel`). `flash_attention_fwd` / `flash_attention_bwd`
    are the two halves on their own; the backward takes
    delta = rowsum(dO * O) as an input, which its caller computes.
  * `ragged_paged_attention` — the decode step's self-attention over
    the paged KV cache: four kernels of `csrc/ragged_paged_attention.cu`
    — one query row per slot (replaces `_rpa_kernel`) or W rows
    (replaces `_rpa_multi_kernel`), over float32 pages or int8 pages
    with per-page scales (their `quant=True` paths). Its plain versions
    share `single_query_cached_attention` with the decoder's
    cross-attention, as the JAX package's lax path does.
  * `fused_layer_norm` — LayerNorm over the last axis as a
    `torch.autograd.Function`: the forward launches `csrc/layer_norm.cu`
    (replaces `_ln_kernel`), the backward is the closed form of
    `_fused_ln_vjp_bwd` in plain torch on both devices (it was XLA in
    the JAX package).

A wrapper takes the plain version only because the tensors it was given
lie on the CPU. On CUDA tensors it launches its kernel or raises: there
is no fallback. Each launch adds one to `LAUNCHES[name]`, so a run can
show that its path went through the kernels.

Masking follows the JAX package: masked scores are the finite -1e30, and
the softmax runs in fp32. A row with no visible key (a key length of 0)
is zeros in both the kernels and the plain versions — the convention of
the TPU kernels (`pallas_kernels.py:287-291`) — and its backward is
zeros too, because the backward masks p itself rather than relying on
exp(-1e30 - lse) underflowing. The JAX `attention_reference` instead
averages V over such a row; that divergence is recorded in ROADMAP.md,
and parity tests use lengths >= 1.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "single_query_cached_attention", "ragged_paged_attention",
           "fused_layer_norm", "layer_norm_fwd", "LAUNCHES",
           "reset_launch_counts"]

_MASKED = -1e30

# kernel launches per wrapper; bumped only where a kernel is launched
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
            "ragged_paged_attention": 0, "ragged_paged_attention_int8": 0,
            "ragged_paged_attention_multi": 0,
            "ragged_paged_attention_multi_int8": 0, "layer_norm": 0}


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
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
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
    """The plain version of the flash kernel: (out, lse (B*H, Sq))."""
    b, h, sq, _ = q.shape
    keep = None
    if kv_lengths is not None:
        pos = torch.arange(k.shape[2], device=k.device)
        keep = (pos[None, :] < kv_lengths.long()[:, None])[:, None, None, :]
    s, allowed = _attention_scores(q, k, causal, sm_scale, keep)
    p = _masked_softmax(s, allowed).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------
def _flash_args(q, k, v, causal, kv_lengths):
    """What the kernel takes, checked on either device (so the CPU tests
    catch a layout the card would refuse): (B, H, Sq, Sk, D)."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check(k.shape == (b, h, sk, d) and v.shape == k.shape,
           f"flash_attention shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
           f" v {tuple(v.shape)} do not agree")
    _check(all(t.dtype == torch.float32 for t in (q, k, v)),
           "flash_attention kernel takes float32 q/k/v")
    _check(all(t.is_contiguous() for t in (q, k, v)),
           "flash_attention kernel takes contiguous q/k/v")
    _check(0 < d <= 128,
           f"flash_attention kernel takes 0 < D <= 128, got {d}")
    _check(b * h > 0 and sq > 0 and sk > 0, "flash_attention: empty input")
    _check(not causal or sq == sk, "causal flash_attention needs Sq == Sk")
    if kv_lengths is not None:
        _check(kv_lengths.dtype == torch.int32 and kv_lengths.shape == (b,)
               and kv_lengths.is_contiguous(),
               "kv_lengths must be a contiguous (B,) int32 tensor")
    return b, h, sq, sk, d


def _flash_cuda(q, k, v, causal, sm_scale, kv_lengths):
    b, h, sq, sk, d = _flash_args(q, k, v, causal, kv_lengths)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.mxtt_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_lengths is None else kv_lengths.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, int(causal),
            float(sm_scale), torch.cuda.current_stream().cuda_stream)
    _launched("flash_fwd", rc)
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None,
                        kv_lengths=None):
    """Attention forward with its per-row log-sum-exp: (out (B, H, Sq,
    D), lse (B*H, Sq) fp32). q: (B, H, Sq, D); k, v: (B, H, Sk, D);
    kv_lengths: optional (B,) int32 — key positions >= kv_lengths[b]
    are masked. Causal requires Sq == Sk."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dev = _device_of(q, k, v, kv_lengths)
    if dev.type == "cuda":
        return _flash_cuda(q, k, v, causal, sm_scale, kv_lengths)
    _flash_args(q, k, v, causal, kv_lengths)
    return _flash_plain(q, k, v, causal, sm_scale, kv_lengths)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
def _flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale, kv_lengths):
    """The plain version of the two backward kernels: p = exp(s - lse)
    where the mask allows it and 0 elsewhere, dS = p (dP - delta) scale;
    returns (dQ, dK, dV)."""
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
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_args(q, k, v, do, lse, delta, causal, kv_lengths):
    b, h, sq, sk, d = _flash_args(q, k, v, causal, kv_lengths)
    _check(do.shape == q.shape and do.dtype == torch.float32
           and do.is_contiguous(),
           "flash_attention_bwd takes a contiguous float32 dO shaped as q")
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


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                        kv_lengths):
    b, h, sq, sk, d = _flash_bwd_args(q, k, v, do, lse, delta, causal,
                                      kv_lengths)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.mxtt_flash_bwd_dkv_f32(
            *_bwd_pointers(q, k, v, do, lse, delta, kv_lengths),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, int(causal),
            float(sm_scale), torch.cuda.current_stream().cuda_stream)
    _launched("flash_bwd_dkv", rc)
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                       kv_lengths):
    b, h, sq, sk, d = _flash_bwd_args(q, k, v, do, lse, delta, causal,
                                      kv_lengths)
    dq = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.mxtt_flash_bwd_dq_f32(
            *_bwd_pointers(q, k, v, do, lse, delta, kv_lengths),
            dq.data_ptr(), b, h, sq, sk, d, int(causal), float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _launched("flash_bwd_dq", rc)
    return dq


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None, kv_lengths=None):
    """Attention backward from the forward's saved lse: (dQ, dK, dV).
    do: (B, H, Sq, D) output gradient; lse, delta: (B*H, Sq) fp32, with
    delta = rowsum(dO * O) (a caller may shift it, as the JAX package's
    `flash_block_attention` does to fold in an lse gradient). The dK and
    dV rows of keys at or past kv_lengths[b] are exactly 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dev = _device_of(q, k, v, do, lse, delta, kv_lengths)
    if dev.type == "cuda":
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                     sm_scale, kv_lengths)
        dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                                kv_lengths)
        return dq, dk, dv
    _flash_bwd_args(q, k, v, do, lse, delta, causal, kv_lengths)
    return _flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale,
                            kv_lengths)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward, keeping what the backward needs;
    backward: delta in torch, then the dK/dV and dQ launches."""

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
    dh), W query tokens per slot at consecutive positions; query i sees
    `lengths + i` keys. Returns (S, W, H, dh)."""
    W = q.shape[1]
    kc, vc, L = _gathered_context(q, k_pages, v_pages, page_tables,
                                  k_scales, v_scales)
    vis = lengths.long()[:, None] + torch.arange(W, device=q.device)[None]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < vis[:, :, None])[:, None, :, :]          # (S, 1, W, L)
    out = single_query_cached_attention(q.transpose(1, 2), kc, vc, mask)
    return out.transpose(1, 2)


# the widest query window the widened kernels take (speculative_k <= 7)
_RPA_MAX_W = 8


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
    _check(1 <= W <= _RPA_MAX_W,
           f"ragged_paged_attention takes 1 <= W <= {_RPA_MAX_W} query rows "
           f"per slot, got {W}")
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


def _rpa_cuda(q, k_pages, v_pages, page_tables, lengths, sm_scale,
              k_scales, v_scales):
    """Launch the one of the four kernels that the form of q and the
    page type select."""
    S, W, H, dh, psize, sp, so, sh = _rpa_args(
        q, k_pages, v_pages, page_tables, lengths, k_scales, v_scales)
    out = torch.empty_like(q)
    lib = _build.library()
    quant = k_scales is not None
    wide = q.dim() == 4
    name = "ragged_paged_attention" + ("_multi" if wide else "") \
        + ("_int8" if quant else "")
    fn = getattr(lib, "mxtt_rpa" + ("_multi" if wide else "")
                 + ("_i8" if quant else "_f32"))
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr()]
    dims = [S, W, H] if wide else [S, H]
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, *dims, dh, psize, page_tables.shape[1], sp, so, sh,
                float(sm_scale), torch.cuda.current_stream().cuda_stream)
    _launched(name, rc)
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_tables, lengths,
                           sm_scale=None, k_scales=None, v_scales=None):
    """One shared attention launch per decode step over a paged KV cache.

    q: (S, H, dh) — one query token per decode slot — or (S, W, H, dh):
    W query tokens per slot at consecutive positions (speculative
    verification), where query i of a slot sees `lengths + i` keys and
    rows past a slot's real window compute values nobody reads.
    k_pages/v_pages: (P, psize, H, dh) page pools, float32, or int8 with
    `k_scales`/`v_scales` (P, H) float32 per-page/per-head dequant
    scales; page_tables: (S, npages) int32 page ids per slot (unused
    entries point at the reserved null page 0); lengths: (S,) int32
    visible positions per slot INCLUDING the current (first) token.
    Returns (S, H, dh) or (S, W, H, dh).

    On CUDA tensors one of four kernels launches (1-wide or widened,
    float32 or int8 pages); on CPU tensors the plain versions run."""
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
# the one width the kernel is built for: transformer_base's units
_LN_D = 512


def _ln_plain(x2, gamma, beta, eps):
    """The plain version of the LayerNorm kernel over (rows, D): mean
    first, then the centred variance, fp32 statistics (the formula of
    `_ln_kernel`). Returns (y, mean (rows,), rstd (rows,))."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xc * rstd) * gamma.float() + beta.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def _ln_args(x, gamma, beta):
    """What the kernel takes, checked on either device: (rows, D)."""
    _check(x.dim() >= 1 and x.numel() > 0, "layer norm: empty input")
    d = x.shape[-1]
    _check(gamma.shape == (d,) and beta.shape == (d,),
           f"layer norm: gamma {tuple(gamma.shape)} / beta "
           f"{tuple(beta.shape)} must be ({d},)")
    _check(all(t.dtype == torch.float32 for t in (x, gamma, beta)),
           "layer norm kernel takes float32 x / gamma / beta")
    _check(all(t.is_contiguous() for t in (x, gamma, beta)),
           "layer norm kernel takes contiguous x / gamma / beta")
    return x.numel() // d, d


def _ln_cuda(x2, gamma, beta, eps):
    rows, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        rc = lib.mxtt_layer_norm_f32(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _launched("layer_norm", rc)
    return y, mean, rstd


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with its statistics: (y shaped as x,
    mean (rows,), rstd (rows,)), rows = x.numel() / D, fp32 statistics.
    The kernel takes D = 512 only; the plain version any D."""
    dev = _device_of(x, gamma, beta)
    rows, d = _ln_args(x, gamma, beta)
    if dev.type == "cuda":
        _check(d == _LN_D,
               f"layer norm kernel takes D = {_LN_D}, got {d}; other widths "
               f"come with the model slices that need them (ROADMAP.md, "
               f"Queue 2: _ln_kernel)")
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
