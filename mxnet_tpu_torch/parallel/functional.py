"""A Gluon block as a function of its parameters (counterpart of
`mxnet_tpu/parallel/functional.py`).

`functional_call(block, params, args)` runs `block.forward` with every
parameter's value replaced by the tensor `params` gives under its name,
as `torch.func.functional_call` does for a module's parameters. Gluon
parameters are not `nn.Parameter`s (their names are the JAX package's,
with prefixes), so the swap is made on the Parameters themselves and
undone after the call. The auxiliary updates (BatchNorm's running
statistics) come back in a dict instead of being written, as the JAX
package's `aux` does.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import random as _random
from ..gluon import block as _block
from ..ndarray.ndarray import NDArray

__all__ = ["param_values", "functional_call", "collect_params_ordered"]


def collect_params_ordered(block):
    """(name, Parameter) of a block tree, in `collect_params()` order."""
    return list(block.collect_params().items())


def param_values(block, dtype=None):
    """{name: tensor} of the current parameter values (the Parameters'
    own tensors, detached); with `dtype`, floating ones cast to it."""
    out = {}
    for name, p in collect_params_ordered(block):
        v = p.data()._data.detach()
        if dtype is not None and v.is_floating_point() and v.dtype != dtype:
            v = v.to(dtype)
        out[name] = v
    return out


def functional_call(block, params, args, training=False, rng=None):
    """`block.forward(*args)` with each parameter's value `params[name]`
    (a tensor; autograd flows into it): returns (output tensor or tuple
    of tensors, {name: new auxiliary value}). Runs with grad mode on and
    `training` as the layers' mode. `rng`, an int, seeds the port's
    generator first (None leaves it as it is)."""
    plist = collect_params_ordered(block)
    saved = [(p, p._data) for _, p in plist]
    sink = {}
    if rng is not None:
        _random.seed(int(rng))
    prev_sink, _block._aux_sink[0] = _block._aux_sink[0], sink
    try:
        for name, p in plist:
            p._data = NDArray(params[name])
        with autograd.record(train_mode=training), torch.enable_grad():
            out = block.forward(*[a if isinstance(a, NDArray)
                                  else NDArray(a) for a in args])
    finally:
        _block._aux_sink[0] = prev_sink
        for p, d in saved:
            p._data = d
    names = {id(p): n for n, p in plist}
    aux = {names[id(p)]: v for p, v in sink.items() if id(p) in names}
    if isinstance(out, (tuple, list)):
        return tuple(o._data for o in out), aux
    return out._data, aux
