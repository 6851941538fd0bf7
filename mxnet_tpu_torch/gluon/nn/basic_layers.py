"""Gluon basic layers (counterpart of `mxnet_tpu/gluon/nn/
basic_layers.py`): the ones TransformerNMT and ResNet training need."""
from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ndarray.ndarray import _apply
from ...ops import nn_ops
from ...ops.kernels import fused_layer_norm
from ..block import Block, HybridBlock, _report_aux_update

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "LayerNorm", "BatchNorm", "BatchNormReLU",
           "Activation", "Flatten", "Identity"]


class _SequentialContainer:
    """Container behaviour shared by Sequential and HybridSequential."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)()
            for b in items[key]:
                net.register_child(b)
            return net
        return items[key]

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialContainer, Block):
    """Stack of Blocks run in order."""


class HybridSequential(_SequentialContainer, HybridBlock):
    """Stack of HybridBlocks run in order."""


class Dense(HybridBlock):
    """Fully-connected layer y = act(x W^T + b), W (units, in_units);
    `in_units=0` defers W's shape to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def _infer_shapes(self, x):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    """Zeroes each element with probability `rate` and scales the rest
    by 1/(1 - rate), in training mode only (inside `record()` or
    `train_mode()`). The mask comes from the seeded generator of the
    input's device (`mx.random.seed`); `axes` share one draw along the
    listed axes."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if not autograd.is_training() or self._rate <= 0:
            return x
        keep = 1.0 - self._rate

        def drop(a):
            shape = list(a.shape)
            for ax in self._axes:
                shape[ax] = 1
            mask = torch.rand(shape, device=a.device,
                              generator=_random.generator(a.device)) < keep
            return torch.where(mask, a / keep, torch.zeros_like(a))
        return _apply(drop, [x])


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    """LayerNorm over the last axis through `ops.kernels.
    fused_layer_norm`: the hand-written kernel on the card, its plain
    version on the CPU (`mxnet_tpu/gluon/nn/basic_layers.py:589-596`).
    Only the last axis is ported."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        if axis != -1:
            raise MXNetError("LayerNorm over an axis other than the last "
                             "is not ported yet (ROADMAP.md, Queue 1: "
                             "training slice)")
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def _infer_shapes(self, x):
        c = x.shape[-1]
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        eps = self._epsilon
        return _apply(lambda a, g, b: fused_layer_norm(a, g, b, eps),
                      [x, gamma, beta])


class BatchNorm(HybridBlock):
    """Batch normalisation over every axis but `axis` (1 for NCHW, 3 for
    NHWC), through `ops.nn_ops.batch_norm`. In training mode (inside
    `autograd.record()` or `train_mode()`, `use_global_stats=False`) it
    normalises with the batch statistics and moves `running_mean` /
    `running_var` towards them; otherwise the running statistics
    normalise. The running statistics are `grad_req="null"` parameters,
    so the Trainer never updates them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 beta_initializer="zeros", gamma_initializer="ones",
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._use_global_stats = use_global_stats
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,), init="zeros",
                allow_deferred_init=True, grad_req="null")
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,), init="ones",
                allow_deferred_init=True, grad_req="null")

    def _infer_shapes(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and not self._use_global_stats
        new = {}

        def bn(a, g, b, mm, mv):
            y, new["mean"], new["var"] = nn_ops.batch_norm(
                a, g, b, mm, mv, self._epsilon, self._momentum, training,
                self._axis)
            return y
        out = _apply(bn, [x, gamma, beta, running_mean, running_var])
        if training:
            _report_aux_update(self.running_mean, new["mean"])
            _report_aux_update(self.running_var, new["var"])
        return out

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}, in_channels={self.in_channels})")


class BatchNormReLU(BatchNorm):
    """BatchNorm followed by a ReLU."""

    def hybrid_forward(self, F, x, *args, **kwargs):
        return F.relu(super().hybrid_forward(F, x, *args, **kwargs))


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return x.flatten()

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x
