"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`).

Each initializer is a callable `init(name, shape, dtype, device) ->
torch.Tensor`. Its randomness comes from `random.generator(device)`, so
deferred Gluon initialisation is reproducible under `mx.random.seed`.
As in the reference, the name decides first: parameters ending in
`gamma` start at 1, those ending in `bias` or `beta` at 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, torch_dtype

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "register", "create"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs):
    if initializer is None:
        return Uniform(0.07)
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        aliases = {"zeros": "zero", "ones": "one", "gaussian": "normal",
                   "glorot": "xavier"}
        name = aliases.get(name, name)
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {initializer!r}; "
                             f"registered: {sorted(_REGISTRY)}")
        return _REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {type(initializer)}")


class Initializer:
    """Base initializer. Subclasses implement `_init(shape, dtype,
    device)`."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def init_array(self, name, shape, dtype, device):
        dtype = torch_dtype(dtype)
        if name.endswith(("gamma", "running_var", "moving_var")):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            return torch.zeros(shape, dtype=dtype, device=device)
        return self._init(tuple(shape), dtype, device)

    def _init(self, shape, dtype, device):
        raise NotImplementedError

    def __call__(self, name, shape, dtype, device):
        return self.init_array(name, shape, dtype, device)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init(self, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


@register
class One(Initializer):
    def _init(self, shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init(self, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


@register
class Uniform(Initializer):
    """Uniform in [-scale, scale]: the default of every parameter that
    names no initializer (`mxnet_tpu/gluon/parameter.py:83-85`)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init(self, shape, dtype, device):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        out.uniform_(-self.scale, self.scale,
                     generator=_random.generator(device))
        return out.to(dtype)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init(self, shape, dtype, device):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        out.normal_(0.0, self.sigma, generator=_random.generator(device))
        return out.to(dtype)


@register
class Xavier(Initializer):
    """Glorot init: uniform or gaussian, fans averaged, in or out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init(self, shape, dtype, device):
        hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_out = shape[0] * hw
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        out = torch.empty(shape, dtype=torch.float32, device=device)
        gen = _random.generator(device)
        if self.rnd_type == "uniform":
            out.uniform_(-scale, scale, generator=gen)
        else:
            out.normal_(0.0, scale, generator=gen)
        return out.to(dtype)
