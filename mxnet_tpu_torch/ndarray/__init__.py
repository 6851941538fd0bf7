"""mx.nd — the imperative NDArray namespace (counterpart of
`mxnet_tpu/ndarray/`): the NDArray type, its creation functions, and the
operators the Gluon layers of this slice call."""
from __future__ import annotations

import torch

from ..ops import nn_ops
from .ndarray import NDArray, _apply, array, ones, zeros

__all__ = ["NDArray", "array", "zeros", "ones", "FullyConnected",
           "Embedding", "Activation", "Convolution", "relu"]

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": torch.nn.functional.softplus}


def _fully_connected(x, w, b, flatten):
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = x @ w.T
    return y if b is None else y + b


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

