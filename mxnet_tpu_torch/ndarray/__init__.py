"""mx.nd — the imperative NDArray namespace (counterpart of
`mxnet_tpu/ndarray/`): the NDArray type, its creation functions,
`save` / `load` / `load_frombuffer` (`utils`), and the operators the
Gluon layers of this slice call."""
from __future__ import annotations

import torch

from ..ops import nn_ops
from .ndarray import NDArray, _apply, array, ones, zeros
from .utils import load, load_frombuffer, save

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load",
           "load_frombuffer", "FullyConnected", "Embedding", "Activation",
           "Convolution", "StemConvS2D", "relu"]

# "gelu" is the tanh approximation, as the JAX package's `jax.nn.gelu`
# with its default approximate=True (mxnet_tpu/ops/nn_ops.py:364);
# "erf_gelu" the exact form
_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": torch.nn.functional.softplus,
         "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
         "erf_gelu": torch.nn.functional.gelu}


def _fully_connected(x, w, b, flatten):
    """x @ w^T + b with `jnp.matmul`'s dtype rule
    (`mxnet_tpu/ops/nn_ops.py:58-67`): after the AMP autocast, both
    operands go to their promoted dtype (fp32 x with a bf16 weight, as a
    cast model's activations meet its weights, computes in fp32) and the
    bias to y's."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    x, w = nn_ops.promote(*nn_ops.amp_cast(x, w))
    y = x @ w.T
    return y if b is None else y + b.to(y.dtype)


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x W^T + b, weight (num_hidden, in_units); `flatten=True`
    collapses every axis after the first."""
    if no_bias or bias is None:
        return _apply(lambda x, w: _fully_connected(x, w, None, flatten),
                      [data, weight])
    return _apply(lambda x, w, b: _fully_connected(x, w, b, flatten),
                  [data, weight, bias])


def Embedding(data, weight, input_dim=None, output_dim=None):
    """Rows of `weight` gathered at the integer indices `data` (float
    indices are cast, as in the reference)."""
    def gather(i, w):
        if i.is_floating_point():
            i = i.to(torch.int64)
        return w[i]
    return _apply(gather, [data, weight])


def Activation(data, act_type="relu"):
    if act_type not in _ACTS:
        raise ValueError(f"unknown act_type {act_type!r}: {sorted(_ACTS)}")
    return _apply(_ACTS[act_type], [data])


def relu(data):
    return Activation(data, "relu")


def Convolution(data, weight, bias=None, kernel=None, stride=1, dilate=1,
                pad=0, num_filter=None, num_group=1, no_bias=False,
                layout="NCHW"):
    """2-D convolution (`ops.nn_ops.convolution`): weight (O, I/g, kh,
    kw) for NCHW data, (O, kh, kw, I/g) for NHWC."""
    def conv(x, w, *b):
        return nn_ops.convolution(x, w, b[0] if b else None, stride, pad,
                                  dilate, num_group, layout)
    inputs = [data, weight] + ([] if no_bias or bias is None else [bias])
    return _apply(conv, inputs)


def StemConvS2D(data, weight, **kwargs):
    """The 7x7 / stride-2 / pad-3 NHWC stem convolution through
    space-to-depth (`ops.nn_ops.stem_conv_s2d`); weight (O, 7, 7, C)."""
    return _apply(nn_ops.stem_conv_s2d, [data, weight])
