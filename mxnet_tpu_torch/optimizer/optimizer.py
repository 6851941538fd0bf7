"""Optimizers (counterpart of `mxnet_tpu/optimizer/optimizer.py`).

The update rules are plain tensor code, as they were XLA in the JAX
package: no kernel of their own. Each update writes the weight and the
optimizer state in place (under `torch.no_grad()`), where the JAX
package rebinds new arrays; the arithmetic is the JAX package's.

A weight that is not float32 (bfloat16 after `Block.cast`) updates in
its own dtype with states of that dtype, unless the optimizer has
`multi_precision=True`: then its state is [fp32 master, the states of
the master], the rule runs on the master in fp32 and the weight gets the
master rounded to its dtype (`mxnet_tpu/optimizer/optimizer.py:130-180`).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}: {sorted(_REGISTRY)} "
                         f"are ported (ROADMAP.md, Queue 1: training slice)")
    return _REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer: per-parameter lr / wd multipliers, `rescale_grad`
    (the Trainer sets it to 1/batch_size), `clip_gradient`, and an
    optional `lr_scheduler(num_update) -> lr`."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, param_dict=None,
                 multi_precision=False):
        self.multi_precision = multi_precision
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.idx2name = {}

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr * self.lr_mult.get(index, self.lr_mult.get(
            self.idx2name.get(index, index), 1.0))

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd * self.wd_mult.get(index, self.wd_mult.get(
            self.idx2name.get(index, index), 1.0))

    def set_learning_rate(self, lr):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def create_state(self, index, weight):
        """The optimizer state of one parameter (NDArrays on its device)."""
        return ()

    def _master_of(self, weight):
        return self.multi_precision and weight._data.dtype != torch.float32

    def create_state_multi_precision(self, index, weight):
        """With `multi_precision` and a weight that is not float32:
        [fp32 master copy, `create_state` of the master] (momentum and
        variance in fp32); else `create_state(index, weight)`."""
        if self._master_of(weight):
            master = NDArray(weight._data.detach().float().clone())
            return [master, self.create_state(index, master)]
        return self.create_state(index, weight)

    def _preprocess(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        return g

    def _step(self, w, g, state, lr, wd):
        """The update rule over tensors: writes `w` and `state` in place.
        `g` is a fresh tensor the rule may overwrite."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(grad._data.to(weight._data.dtype))
            self._step(weight._data, g, state, lr, wd)

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or with a master (`create_state_multi_precision`)
        the rule on the master in fp32 from the fp32 gradient, and the
        weight set to the master rounded to its dtype."""
        if not self._master_of(weight):
            self.update(index, weight, grad, state)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        master, inner = state
        with torch.no_grad():
            g = self._preprocess(grad._data.float())
            self._step(master._data, g, inner, lr, wd)
            weight._data.copy_(master._data)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: m = momentum*m + (g + wd*w),
    w -= lr*m (`mxnet_tpu/optimizer/optimizer.py:186-203`)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if not self.momentum:
            return ()
        return (NDArray(torch.zeros_like(weight._data,
                                         requires_grad=False)),)

    def _step(self, w, g, state, lr, wd):
        if wd:
            g.add_(w, alpha=wd)
        if self.momentum:
            m = state[0]._data
            m.mul_(self.momentum).add_(g)
            g = m
        w.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with bias correction and a per-parameter step count t
    (`mxnet_tpu/optimizer/optimizer.py:219-240`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        # [mean, variance, t]: t is a host int, so the bias correction
        # needs no device scalar
        def zeros():
            return NDArray(torch.zeros_like(weight._data,
                                            requires_grad=False))
        return [zeros(), zeros(), 0]

    def _step(self, w, g, state, lr, wd):
        m, v = state[0]._data, state[1]._data
        state[2] += 1
        t = state[2]
        if wd:
            g.add_(w, alpha=wd)
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        w.sub_(lr * mhat / (vhat.sqrt_() + self.epsilon))
