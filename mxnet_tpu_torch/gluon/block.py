"""Gluon Block / HybridBlock (counterpart of `mxnet_tpu/gluon/block.py`).

`Block` is a `torch.nn.Module`, and so is `HybridBlock`: child blocks
are nn.Module children, so torch's module walks see the tree. Their
weights are Gluon `Parameter`s with MXNet's name scopes, prefixes,
deferred initialisation and `grad_req`; `named_parameters()` yields
their tensors under the structural names for torch code that wants them.

Structural names (`_collect_params_with_prefix`, the attribute path
such as `encoder.layers.0.attn.qkv.weight`) key `save_parameters` /
`load_parameters`, in the JAX package's npz format, so a file crosses
between the two packages in both directions.

`hybridize()` is accepted and the block runs eagerly: CUDA-graph
capture of a step is ROADMAP.md Queue 1 item 3, and there is no symbol
path. Every call runs with torch's grad mode on only while
`autograd.record()` is active.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..context import resolve_device
from .parameter import DeferredInitializationError, Parameter, \
    ParameterDict

__all__ = ["Block", "HybridBlock"]


def _report_aux_update(param, new_value):
    """Write a layer's new auxiliary state (BatchNorm's running
    statistics) into its parameter, in place and outside autograd: the
    JAX package rebinds the array, and its traced path returns the
    update instead (`mxnet_tpu/gluon/block.py:154`)."""
    with torch.no_grad():
        param.data()._data.copy_(new_value)


class _NameManager:
    _lock = threading.Lock()
    _counters = {}

    @classmethod
    def get(cls, hint):
        with cls._lock:
            n = cls._counters.get(hint, 0)
            cls._counters[hint] = n + 1
        return f"{hint}{n}"


class _BlockScope:
    """Hierarchical name scoping: a child made inside a parent's
    `name_scope()` gets the parent's prefix plus `{hint}{count}_`."""
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NameManager.get(hint) + "_"
            return prefix, ParameterDict(prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        full_prefix = current._block.prefix + prefix
        return full_prefix, ParameterDict(full_prefix, params)

    def __enter__(self):
        if self._block.prefix:
            self._old = getattr(_BlockScope._current, "value", None)
            _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block.prefix:
            _BlockScope._current.value = self._old


class Block(nn.Module):
    """Base building block. Subclasses implement `forward(*args)`."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix, self._params = _BlockScope.create(
            prefix, params, type(self).__name__.lower())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self._modules[name] = block

    # ---------------------------------------------------------- parameters
    def collect_params(self, select=None):
        """This block's and its descendants' parameters, optionally those
        whose full name matches the regular expression `select`."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            import re
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Structural names (attribute paths) -> Parameter; the same for
        every instance of an architecture, whatever its name prefixes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        """(structural name, tensor) of every initialised parameter."""
        seen = set()
        for name, p in self._collect_params_with_prefix(prefix).items():
            if p._data is None or (remove_duplicate and id(p) in seen):
                continue
            seen.add(id(p))
            yield name, p._data._data

    def parameters(self, recurse=True):
        for _, t in self.named_parameters():
            yield t

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on `ctx` (None = `mx.gpu(0)`, which
        raises without a card; `ctx=mx.cpu()` for the CPU)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)
        return self

    def hybridize(self, active=True, **kwargs):
        """Accepted; the block runs eagerly (ROADMAP.md Queue 1 item 3:
        CUDA-graph capture)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # ------------------------------------------------------- serialisation
    def save_parameters(self, filename):
        """npz keyed by structural name (the JAX package's format)."""
        arrays = {name: p.data().asnumpy() for name, p in
                  self._collect_params_with_prefix().items()
                  if p._data is not None}
        # through a file object: np.savez(str) would append ".npz"
        with open(filename, "wb") as f:
            np.savez(f, **arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a `save_parameters` file (from either package) onto `ctx`
        (None = `mx.gpu(0)`)."""
        with np.load(filename) as f:
            arrays = {k: f[k] for k in f.keys()}
        self._load_arrays(arrays, ctx, allow_missing, ignore_extra,
                          source=filename)

    def _load_arrays(self, arrays, ctx, allow_missing, ignore_extra,
                     source="arrays"):
        device = resolve_device(ctx)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            missing = sorted(set(params) - set(arrays))
            if missing:
                raise MXNetError(f"parameters missing in {source}: "
                                 f"{missing}")
        if not ignore_extra:
            extra = sorted(set(arrays) - set(params))
            if extra:
                raise MXNetError(f"extra parameters in {source}: {extra}")
        for name, p in params.items():
            if name not in arrays:
                continue
            value = np.asarray(arrays[name])
            if p._data is not None and p._data.shape != value.shape:
                raise MXNetError(f"shape mismatch for {name}: parameter "
                                 f"{p._data.shape}, {source} "
                                 f"{value.shape}")
            p.reset_ctx(device)
            p.set_data(torch.tensor(value, device=device))

    # ----------------------------------------------------------- execution
    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """A block whose computation is `hybrid_forward(F, x, *args,
    **params)`: F is `mx.nd` and params are the block's own registered
    parameters as NDArrays."""

    def _infer_shapes(self, *args):
        """Layers with deferred-init parameters override this."""

    def forward(self, *args, **kwargs):
        from .. import ndarray as F
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_shapes(*args)
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init(p.shape)
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
