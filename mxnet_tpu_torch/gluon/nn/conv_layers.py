"""Gluon 2-D convolution and pooling layers (counterpart of
`mxnet_tpu/gluon/nn/conv_layers.py:28-256`).

Both layouts of the JAX package: `NCHW` (the reference's default), with
a weight `(O, I/g, kh, kw)`, and `NHWC`, with a weight `(O, kh, kw,
I/g)`, so a parameter file crosses between the two packages one to one.
The 1-D and 3-D layers, the transposed convolutions and the padding
layers are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from ...ndarray.ndarray import _apply
from ...ops import nn_ops
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _tuple(x, n):
    return (x,) * n if isinstance(x, int) else tuple(x)


class Conv2D(HybridBlock):
    """2-D convolution, weight (O, I/g, kh, kw) for NCHW and (O, kh, kw,
    I/g) for NHWC; `in_channels=0` defers I to the first forward."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tuple(kernel_size, 2)
        self._strides = _tuple(strides, 2)
        self._padding = _tuple(padding, 2)
        self._dilation = _tuple(dilation, 2)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._channel_first = layout.index("C") == 1
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None

    def _weight_shape(self, in_channels):
        ig = in_channels // self._groups if in_channels else 0
        if self._channel_first:
            return (self._channels, ig) + self._kernel
        return (self._channels,) + self._kernel + (ig,)

    def _infer_shapes(self, x):
        in_c = x.shape[self._layout.index("C")]
        self.weight._finish_deferred_init(self._weight_shape(in_c))
        self._in_channels = in_c

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._strides, pad=self._padding,
                            dilate=self._dilation, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None,
                            layout=self._layout)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._in_channels} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, pool_type, layout=None,
                 count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kernel = _tuple(pool_size, 2)
        self._strides = _tuple(strides if strides is not None else pool_size,
                               2)
        self._padding = _tuple(padding, 2)
        self._pool_type = pool_type
        self._layout = layout or "NCHW"
        self._count_include_pad = count_include_pad

    def hybrid_forward(self, F, x):
        return _apply(lambda a: nn_ops.pooling(
            a, self._kernel, self._pool_type, self._strides, self._padding,
            self._layout, self._count_include_pad), [x])

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, "max", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, "avg", **kwargs)


class _GlobalPool(HybridBlock):
    def __init__(self, pool_type, layout=None, keep_dims=True, **kwargs):
        super().__init__(**kwargs)
        self._pool_type = pool_type
        self._layout = layout or "NCHW"
        self._keep = keep_dims

    def hybrid_forward(self, F, x):
        return _apply(lambda a: nn_ops.global_pooling(
            a, self._pool_type, self._layout, keepdims=self._keep), [x])


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, **kwargs):
        super().__init__("max", **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, **kwargs):
        super().__init__("avg", **kwargs)
