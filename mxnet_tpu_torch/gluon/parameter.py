"""Gluon Parameter / ParameterDict (counterpart of
`mxnet_tpu/gluon/parameter.py`).

A Parameter owns one NDArray, whose tensor is a leaf that requires a
gradient unless `grad_req="null"`, and a gradient buffer of the same
shape that `autograd.backward` writes into. A Parameter created with an
unknown dimension (0) initialises at the first forward, once its layer
has inferred the shape. `initialize(ctx=None)` means `mx.gpu(0)`, which
raises without a card; pass `ctx=mx.cpu()` for the CPU.

`dtype` is a numpy dtype, or torch.bfloat16 for "bfloat16" (numpy has
none; the JAX package reports ml_dtypes' numpy bfloat16 there).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import initializer as _initializer
from ..base import MXNetError, dtype_of, from_numpy, torch_dtype
from ..context import resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A deferred-init parameter's data was read before the first
    forward inferred its shape."""


def _as_tensor(data):
    if isinstance(data, NDArray):
        return data._data
    if isinstance(data, torch.Tensor):
        return data
    return None


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_of(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None            # NDArray
        self._grad = None            # NDArray
        self._deferred_init = None   # (initializer, device) awaiting shape

    # ------------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        self._grad_req = req
        if self._data is not None:
            self._data._data.requires_grad_(req != "null")
            if req == "null":
                self._grad = None
                self._data._grad = None
                self._data._grad_req = "null"
            else:
                self._init_grad()

    def _shape_is_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Draw the value on `ctx` (None = `mx.gpu(0)`): this parameter's
        own initializer first, else `default_init`, else Uniform(0.07).
        A shape with an unknown dimension defers the draw to the first
        forward."""
        device = resolve_device(ctx[0] if isinstance(ctx, (list, tuple))
                                else ctx)
        if self._data is not None and not force_reinit:
            return
        if init is None:
            init = self.init if self.init is not None else default_init
        init = _initializer.create(init)
        if not self._shape_is_known():
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"Cannot initialize Parameter {self.name!r}: unknown "
                    f"shape {self.shape} and deferred init not allowed")
            self._deferred_init = (init, device)
            return
        self._finish_init(init, device)

    def _finish_init(self, init, device):
        val = init(self.name, self.shape, self.dtype, device)
        self._data = NDArray(val.requires_grad_(self._grad_req != "null"))
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = NDArray(torch.zeros_like(self._data._data,
                                              requires_grad=False))
        self._data._grad = self._grad
        self._data._grad_req = self._grad_req

    def _finish_deferred_init(self, inferred_shape):
        """Called by a layer at its first forward with the full shape."""
        if self._deferred_init is None:
            return
        shape = tuple(inferred_shape)
        if self.shape is not None:
            for have, got in zip(self.shape, shape):
                if have > 0 and got > 0 and have != got:
                    raise MXNetError(
                        f"shape mismatch for {self.name}: declared "
                        f"{self.shape}, inferred {shape}")
            shape = tuple(h if h > 0 else g
                          for h, g in zip(self.shape, shape))
        self.shape = shape
        init, device = self._deferred_init
        self._finish_init(init, device)

    # ------------------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name!r} has deferred init; run a "
                    f"forward pass first")
            raise MXNetError(f"Parameter {self.name!r} has not been "
                             f"initialized. Call .initialize()")
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad is None:
            raise MXNetError(f"Parameter {self.name!r} has no gradient "
                             f"(grad_req={self._grad_req!r})")
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None:
            return [self._deferred_init[1]] if self._deferred_init else []
        return [self._data.context]

    def set_data(self, data):
        """Set the value. An initialised parameter keeps its device, dtype
        and tensor (the value is copied in place); an uninitialised one
        takes `data` as it is, or, for a numpy array, a float32 copy on
        its deferred device (`mx.gpu(0)` when it has none)."""
        src = _as_tensor(data)
        if self._data is None:
            if src is None:
                dev = self._deferred_init[1] if self._deferred_init \
                    else resolve_device(None)
                src = from_numpy(data).to(dev)
            src = src.detach().to(torch_dtype(self.dtype)).clone()
            if self.shape is not None and len(self.shape) == src.dim():
                for have, got in zip(self.shape, src.shape):
                    if have > 0 and have != got:
                        raise MXNetError(
                            f"shape mismatch for {self.name}: declared "
                            f"{self.shape}, got {tuple(src.shape)}")
            self.shape = tuple(src.shape)
            self._data = NDArray(src.requires_grad_(
                self._grad_req != "null"))
            self._deferred_init = None
            if self._grad_req != "null":
                self._init_grad()
            return
        if src is None:
            src = from_numpy(data)
        if tuple(src.shape) != self._data.shape:
            raise MXNetError(f"shape mismatch for {self.name}: parameter "
                             f"{self._data.shape}, data {tuple(src.shape)}")
        with torch.no_grad():
            self._data._data.copy_(src)

    def cast(self, dtype):
        """Cast the value and the gradient buffer to `dtype`, the
        gradient still bound to the value (`mxnet_tpu/gluon/parameter.py:
        193-199`); a parameter not yet initialised takes the dtype when
        it is."""
        self.dtype = dtype_of(dtype)
        if self._data is None:
            return
        dt = torch_dtype(dtype)
        self._data._data = self._data._data.detach().to(dt) \
            .requires_grad_(self._grad_req != "null")
        if self._grad is not None:
            self._grad._data = self._grad._data.to(dt)
            self._data._grad = self._grad

    def _struct_sig(self):
        """What the Trainer's bucket layout depends on: the materialised
        shape and dtype, the gradient's dtype and grad_req, so deferred
        init, `cast` and grad_req flips rebuild the buckets
        (`mxnet_tpu/gluon/parameter.py:201-210`)."""
        return (self.name,
                None if self._data is None
                else (self._data.shape, str(self._data._data.dtype)),
                None if self._grad is None else str(self._grad._data.dtype),
                self._grad_req)

    def zero_grad(self):
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def reset_ctx(self, ctx):
        """Move the value and the gradient buffer to `ctx`."""
        dev = resolve_device(ctx)
        if self._data is None:
            if self._deferred_init is not None:
                self._deferred_init = (self._deferred_init[0], dev)
            return
        if self._data.context == dev:
            return
        self._data._data = self._data._data.detach().to(dev) \
            .requires_grad_(self._grad_req != "null")
        if self._grad is not None:
            self._grad._data = self._grad._data.to(dev)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class ParameterDict:
    """Ordered name -> Parameter mapping with a shared prefix."""

    def __init__(self, prefix="", shared=None):
        self.prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        lines = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict({self.prefix}\n{lines}\n)"

    def get(self, name, **kwargs):
        """Retrieve or create the parameter `self.prefix + name`."""
        full = self.prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)
