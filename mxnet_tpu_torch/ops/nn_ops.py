"""Convolution, pooling and BatchNorm over tensors (counterpart of
`mxnet_tpu/ops/nn_ops.py:79` `convolution`, `:116` `stem_conv_s2d`,
`:180-267` `_bn_train` and `batch_norm`, `:303` `pooling`, `:350`
`global_pooling`), and the dtype rules of a product: the AMP autocast
(`amp_cast`, `:42-55`) and `jnp.matmul`'s promotion (`promote`).

The JAX package computes all of them outside any Pallas kernel (XLA), so
here they are PyTorch: the convolution is `F.conv2d` (cuDNN on the
card) and pooling `F.max_pool2d` / `F.avg_pool2d`. BatchNorm keeps the
JAX package's numerics as a `torch.autograd.Function`: a one-pass
forward shifted by the running mean, and the hand-fused two-pass
backward of `_bn_train_vjp_bwd`. With a process group (`group=`, or
the one `sync_batch_norm(group)` installs) the statistics are the global
batch's: each rank's sums of x - shift, of its square and its row count
are all-reduced in the forward, and the backward's two sums (of dy and
of dy * xhat) before dx; the gradients of gamma and beta stay this
rank's own, for the caller's gradient reduction to sum. Which path uses
which statistics: `parallel.make_train_step` over a mesh synchronises
them (the JAX step is one global-view program); the eager store path
and the captured step over a store keep them per rank, as MXNet's
multi-device training and the JAX `shard_map` step do.

Layouts are the JAX package's: data `NCHW` or `NHWC`, and a weight
`(O, I, kh, kw)` for NCHW or `(O, kh, kw, I)` for NHWC. NHWC tensors
reach torch as channels-last views (a permute, no copy), and the
gradients come back in the stored layout. Only 2-D windows are ported;
1-D and 3-D wait with the rest of `conv_layers.py` (ROADMAP.md).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["amp_cast", "promote", "convolution", "stem_conv_s2d",
           "pooling", "global_pooling", "batch_norm", "sync_batch_norm",
           "sync_group"]

# the process group BatchNorm layers synchronise their statistics over
# (`sync_batch_norm`), or None
_SYNC = [None]


@contextlib.contextmanager
def sync_batch_norm(group):
    """Within the block, training-mode BatchNorm layers take their batch
    statistics over every rank of `group` (None: per rank)."""
    prev, _SYNC[0] = _SYNC[0], group
    try:
        yield
    finally:
        _SYNC[0] = prev


def sync_group():
    """The group `sync_batch_norm` installed, or None."""
    return _SYNC[0]


def _all_reduce(t, group):
    from ..parallel import _comm
    return _comm.all_reduce(t, group)

_LAYOUTS = ("NCHW", "NHWC")


def _check_layout(x, layout):
    if layout not in _LAYOUTS:
        raise MXNetError(f"layout {layout!r}: only 2-D NCHW and NHWC are "
                         f"ported (ROADMAP.md, Queue 1: the rest of "
                         f"conv_layers.py)")
    if x.dim() != 4:
        raise MXNetError(f"{layout} data must be 4-D, got shape "
                         f"{tuple(x.shape)}")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _to_nchw(x, layout):
    return x.permute(0, 3, 1, 2) if layout == "NHWC" else x


def _from_nchw(y, layout):
    return y.permute(0, 2, 3, 1) if layout == "NHWC" else y


def amp_cast(x, weight):
    """The op-level AMP autocast (`amp.init()`): with AMP on, an fp32
    operand of a product or a convolution goes to the AMP target dtype,
    either side, so a bf16 activation meeting an fp32 master weight does
    not promote the product back to fp32. No-op when AMP is off."""
    from ..amp import autocast_dtype
    dt = autocast_dtype()
    if dt is None:
        return x, weight
    if x.dtype == torch.float32:
        x = x.to(dt)
    if weight.dtype == torch.float32:
        weight = weight.to(dt)
    return x, weight


def promote(x, w):
    """Both operands in their promoted dtype, as `jnp.matmul` computes a
    product of two dtypes: fp32 with bf16 gives fp32, and the gradient
    of the cast operand comes back in its own dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1,
                num_group=1, layout="NCHW"):
    """2-D convolution. x: (N, C, H, W) or (N, H, W, C); weight (O, I/g,
    kh, kw) or (O, kh, kw, I/g) to match; bias (O,). After the AMP
    autocast the weight is cast to x's dtype, as in the JAX package."""
    layout = layout or "NCHW"
    _check_layout(x, layout)
    if weight.dim() != 4:
        raise MXNetError(f"a 2-D convolution weight is 4-D, got "
                         f"{tuple(weight.shape)}")
    x, weight = amp_cast(x, weight)
    w = weight.permute(0, 3, 1, 2) if layout == "NHWC" else weight
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = F.conv2d(_to_nchw(x, layout), w,
                 None if bias is None else bias.to(x.dtype),
                 stride=_pair(stride), padding=_pair(pad),
                 dilation=_pair(dilate), groups=num_group)
    return _from_nchw(y, layout)


def stem_conv_s2d(x, weight):
    """The 7x7 / stride-2 / pad-3 NHWC convolution of the ResNet stem
    computed through space-to-depth (`mxnet_tpu/ops/nn_ops.py:116-148`):
    x (N, H, W, C) becomes (N, H/2, W/2, 4C), the (O, 7, 7, C) weight is
    repacked to (O, 4, 4, 4C), and a stride-1 convolution with padding
    (2, 1) on each spatial axis gives the same (N, H/2, W/2, O). The
    convolution is cuDNN's on the card, as the JAX package leaves it to
    XLA; the weight's gradient flows back through the repack. H and W
    must be even."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"stem_conv_s2d needs even spatial dims, got {(h, w)}; use "
            "convolution(..., stride=2, pad=3) for odd sizes")
    o = weight.shape[0]
    xs = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(n, h // 2, w // 2, 4 * c)
    # w2[o, ka, kb, (p * 2 + q) * C + c] = w[o, 2 ka + p - 1, 2 kb + q - 1,
    # c]: the 7x7 kernel padded to 8x8 at the top and left, cut in 2x2
    wp = F.pad(weight, (0, 0, 1, 0, 1, 0))                  # (O, 8, 8, C)
    w2 = wp.reshape(o, 4, 2, 4, 2, c).permute(0, 1, 3, 2, 4, 5)
    w2 = w2.reshape(o, 4, 4, 4 * c).permute(0, 3, 1, 2).to(x.dtype)
    y = F.conv2d(F.pad(xs.permute(0, 3, 1, 2), (2, 1, 2, 1)), w2)
    return y.permute(0, 2, 3, 1)


def pooling(x, kernel, pool_type="max", stride=None, pad=0, layout="NCHW",
            count_include_pad=True):
    """Max or average pooling over 2-D windows. Max pads with -inf; the
    average divides by the whole window (`count_include_pad=True`) or by
    its elements inside the input."""
    layout = layout or "NCHW"
    _check_layout(x, layout)
    kernel = _pair(kernel)
    stride = _pair(stride or kernel)
    pad = _pair(pad)
    if any(2 * p > k for p, k in zip(pad, kernel)):
        raise MXNetError(f"pooling pad {pad} must be at most half the "
                         f"window {kernel}")
    xc = _to_nchw(x, layout)
    if pool_type == "max":
        y = F.max_pool2d(xc, kernel, stride, pad)
    elif pool_type == "avg":
        y = F.avg_pool2d(xc, kernel, stride, pad,
                         count_include_pad=count_include_pad)
    else:
        raise MXNetError(f"pool_type {pool_type!r}: max and avg are ported")
    return _from_nchw(y, layout)


def global_pooling(x, pool_type="avg", layout="NCHW", keepdims=True):
    """Max or mean over every spatial axis."""
    _check_layout(x, layout)
    axes = (2, 3) if layout == "NCHW" else (1, 2)
    if pool_type == "max":
        return x.amax(dim=axes, keepdim=keepdims)
    if pool_type == "avg":
        return x.mean(dim=axes, keepdim=keepdims)
    raise MXNetError(f"pool_type {pool_type!r}: max and avg are ported")


def _bn_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = -1
    return shape, tuple(i for i in range(x.dim()) if i != axis)


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm (`_bn_train`): y and the batch mean and
    biased variance, fp32 statistics. The variance is one pass over x
    shifted by `shift` (the running mean): E[(x-s)^2] - E[x-s]^2 keeps
    its precision when |mean| >> std, where E[x^2] - E[x]^2 would not
    (docs/PERF.md "Variance numerics"); clamped at 0. The statistics
    carry no gradient; the backward is the closed form of
    `_bn_train_vjp_bwd`, not autograd of the forward. `group` (a process
    group of more than one rank, or None) makes the statistics the
    global batch's (module docstring)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, shift, axis, eps, group=None):
        shape, axes = _bn_shape(x, axis)
        xf = x.float()
        sf = shift.detach().float().reshape(shape)
        xc = xf - sf
        if group is None:
            n = x.numel() // x.shape[axis]
            m1 = xc.mean(dim=axes)
            m2 = (xc * xc).mean(dim=axes)
        else:
            c = x.shape[axis]
            sums = torch.cat([xc.sum(dim=axes), (xc * xc).sum(dim=axes),
                              xc.new_full((1,), x.numel() // c)])
            _all_reduce(sums, group)
            n = sums[-1]
            m1, m2 = sums[:c] / n, sums[c:2 * c] / n
        var = (m2 - m1 * m1).clamp_min(0.0)
        mean = m1 + sf.reshape(-1)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(shape)) * inv.reshape(shape)
             * gamma.float().reshape(shape) + beta.float().reshape(shape))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axis, ctx.group, ctx.n = axis, group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        shape, axes = _bn_shape(x, ctx.axis)
        n = ctx.n
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        sb, sg = dbeta, dgamma
        if ctx.group is not None:
            both = _all_reduce(torch.cat([dbeta, dgamma]), ctx.group)
            sb, sg = both[:dbeta.numel()], both[dbeta.numel():]
        k = (gamma.float() * inv / n).reshape(shape)
        dx = k * (n * dyf - sb.reshape(shape) - xhat * sg.reshape(shape))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None, None)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, training=True, axis=1, group=None):
    """BatchNorm over every axis but `axis`. Returns (y, new_moving_mean,
    new_moving_var); in inference mode the moving statistics normalise
    and come back unchanged. The new moving statistics are detached.
    `group`: the process group whose ranks share the batch statistics
    (None, or a group of one rank: this rank's batch alone)."""
    axis = axis % x.dim()
    if group is not None:
        import torch.distributed as dist
        if dist.get_world_size(group) == 1:
            group = None
    if training:
        y, mean, var = _BNTrain.apply(x, gamma, beta, moving_mean, axis,
                                      float(eps), group)
        with torch.no_grad():
            new_mean = (momentum * moving_mean.float()
                        + (1 - momentum) * mean).to(moving_mean.dtype)
            new_var = (momentum * moving_var.float()
                       + (1 - momentum) * var).to(moving_var.dtype)
        return y, new_mean, new_var
    shape, _ = _bn_shape(x, axis)
    inv = torch.rsqrt(moving_var.float() + eps)
    scale = (gamma.float() * inv).reshape(shape)
    shift = (beta.float() - gamma.float() * moving_mean.float()
             * inv).reshape(shape)
    y = (x.float() * scale + shift).to(x.dtype)
    return y, moving_mean, moving_var
