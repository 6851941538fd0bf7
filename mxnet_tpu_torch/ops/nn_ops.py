"""Convolution, pooling and BatchNorm over tensors (counterpart of
`mxnet_tpu/ops/nn_ops.py:79` `convolution`, `:180-267` `_bn_train` and
`batch_norm`, `:303` `pooling`, `:350` `global_pooling`).

The JAX package computes all four outside any Pallas kernel (XLA), so
here they are PyTorch: the convolution is `F.conv2d` (cuDNN on the
card) and pooling `F.max_pool2d` / `F.avg_pool2d`. BatchNorm keeps the
JAX package's numerics as a `torch.autograd.Function`: a one-pass
forward shifted by the running mean, and the hand-fused two-pass
backward of `_bn_train_vjp_bwd`.

Layouts are the JAX package's: data `NCHW` or `NHWC`, and a weight
`(O, I, kh, kw)` for NCHW or `(O, kh, kw, I)` for NHWC. NHWC tensors
reach torch as channels-last views (a permute, no copy), and the
gradients come back in the stored layout. Only 2-D windows are ported;
1-D and 3-D wait with the rest of `conv_layers.py` (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["convolution", "pooling", "global_pooling", "batch_norm"]

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


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1,
                num_group=1, layout="NCHW"):
    """2-D convolution. x: (N, C, H, W) or (N, H, W, C); weight (O, I/g,
    kh, kw) or (O, kh, kw, I/g) to match; bias (O,). The weight is cast
    to x's dtype, as in the JAX package."""
    layout = layout or "NCHW"
    _check_layout(x, layout)
    if weight.dim() != 4:
        raise MXNetError(f"a 2-D convolution weight is 4-D, got "
                         f"{tuple(weight.shape)}")
    w = weight.permute(0, 3, 1, 2) if layout == "NHWC" else weight
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = F.conv2d(_to_nchw(x, layout), w,
                 None if bias is None else bias.to(x.dtype),
                 stride=_pair(stride), padding=_pair(pad),
                 dilation=_pair(dilate), groups=num_group)
    return _from_nchw(y, layout)


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
    `_bn_train_vjp_bwd`, not autograd of the forward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, shift, axis, eps):
        shape, axes = _bn_shape(x, axis)
        xf = x.float()
        sf = shift.detach().float().reshape(shape)
        xc = xf - sf
        m1 = xc.mean(dim=axes)
        var = ((xc * xc).mean(dim=axes) - m1 * m1).clamp_min(0.0)
        mean = m1 + sf.reshape(-1)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(shape)) * inv.reshape(shape)
             * gamma.float().reshape(shape) + beta.float().reshape(shape))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        shape, axes = _bn_shape(x, ctx.axis)
        n = x.numel() // x.shape[ctx.axis]
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        k = (gamma.float() * inv / n).reshape(shape)
        dx = k * (n * dyf - dbeta.reshape(shape)
                  - xhat * dgamma.reshape(shape))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, training=True, axis=1):
    """BatchNorm over every axis but `axis`. Returns (y, new_moving_mean,
    new_moving_var); in inference mode the moving statistics normalise
    and come back unchanged. The new moving statistics are detached."""
    axis = axis % x.dim()
    if training:
        y, mean, var = _BNTrain.apply(x, gamma, beta, moving_mean, axis,
                                      float(eps))
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
