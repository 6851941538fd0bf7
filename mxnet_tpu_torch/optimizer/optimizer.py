"""Optimizers (counterpart of `mxnet_tpu/optimizer/optimizer.py`).

The update rules are plain tensor code, as they were XLA in the JAX
package: no kernel of their own. Each update writes the weight and the
optimizer state in place (under `torch.no_grad()`), where the JAX
package rebinds new arrays; the arithmetic is the JAX package's.

Every rule has two forms:

  * `_step(w, g, sv, lr, wd)`, one parameter at a time with Python
    floats: the per-parameter path (`Trainer(fused=False)`) and the
    yardstick of the fused one;
  * `_multi_step(ws, gs, svs, lr, wd)`, a list of parameters at once
    over `torch._foreach_*`, with `lr` and `wd` either Python floats or
    0-d tensors on the weights' device (the fused Trainer path and the
    captured step fill a device buffer, so an lr schedule never changes
    the launched work).

The state is the JAX package's tuple: SGD with momentum (m,), Adam (m, v,
t) with t a 0-d int32 tensor on the weight's device, so the step count
and Adam's bias correction live on the device (a captured step would
freeze a host count). A weight that is not float32 (bfloat16 after
`Block.cast`) updates in its own dtype with states of that dtype, unless
the optimizer has `multi_precision=True`: then its state is (fp32
master, *the states of the master), the rule runs on the master in fp32
and the weight gets the master rounded to its dtype
(`mxnet_tpu/optimizer/optimizer.py:130-180`).

`fused_sgd_mom_kernel`, `multi_sgd_mom_update` and `multi_sgd_update`
are the reference's multi-tensor SGD (`:534-618`), over foreach lists in
fp32 instead of the JAX package's one flat vector.
"""
from __future__ import annotations

import torch

from .. import profiler
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Adam", "create", "register",
           "fused_sgd_mom_kernel", "multi_sgd_mom_update",
           "multi_sgd_update"]

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


def _tensors(state):
    """The tensors of a state tuple of NDArrays (() for none)."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state._data,)
    return tuple(s._data for s in state)


class Optimizer:
    """Base optimizer: per-parameter lr / wd multipliers, `rescale_grad`
    (the Trainer sets it to 1/batch_size), `clip_gradient`, and an
    optional `lr_scheduler(num_update) -> lr`."""

    # True when the rule is elementwise over the weight (no whole-tensor
    # reduction): what `capture(sharded_update=True)` needs to update a
    # block of rows alone; subclasses opt in, as in the JAX package
    elementwise = False

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

    # -- state -------------------------------------------------------------
    def init_state(self, w):
        """The state tensors of weight tensor `w`, a tuple."""
        return ()

    def create_state(self, index, weight):
        """The optimizer state of one parameter: a tuple of NDArrays on
        its device."""
        return tuple(NDArray(s) for s in self.init_state(weight._data))

    def _master_of(self, weight):
        return self.multi_precision and weight._data.dtype != torch.float32

    def create_state_multi_precision(self, index, weight):
        """With `multi_precision` and a weight that is not float32:
        (fp32 master copy, *`create_state` of the master), so momentum
        and variance live in fp32; else `create_state(index, weight)`."""
        if self._master_of(weight):
            master = NDArray(weight._data.detach().float().clone())
            return (master,) + tuple(self.create_state(index, master))
        return self.create_state(index, weight)

    # -- the per-parameter path ---------------------------------------------
    def _preprocess(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        return g

    def _step(self, w, g, sv, lr, wd):
        """The rule on one parameter's tensors: writes `w` and the state
        tensors `sv` in place. `g` is a fresh tensor it may overwrite."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        profiler.record_dispatch("opt_update")
        with torch.no_grad():
            g = self._preprocess(grad._data.to(weight._data.dtype))
            self._step(weight._data, g, _tensors(state), lr, wd)

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or with a master (`create_state_multi_precision`)
        the rule on the master in fp32 from the fp32 gradient, and the
        weight set to the master rounded to its dtype."""
        if not self._master_of(weight):
            self.update(index, weight, grad, state)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        master, rest = state[0]._data, _tensors(state[1:])
        profiler.record_dispatch("opt_update_mp")
        with torch.no_grad():
            g = self._preprocess(grad._data.float())
            self._step(master, g, rest, lr, wd)
            weight._data.copy_(master)

    # -- the multi-tensor path ----------------------------------------------
    def _multi_step(self, ws, gs, svs, lr, wd):
        """The rule on lists: `ws` weights, `gs` fresh gradients it may
        overwrite, `svs` each weight's state tensors; `lr` and `wd` are
        floats or 0-d tensors of the weights' device and dtype. Writes
        `ws` and the states in place. `wd` is not applied when it is the
        float 0 (the caller decides, as `_step` does on its value)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


def _add_wd(gs, ws, wd):
    """g += wd * w, as two rounded steps on both forms of wd."""
    if isinstance(wd, torch.Tensor) or wd:
        torch._foreach_add_(gs, torch._foreach_mul(ws, wd))


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: m = momentum*m + (g + wd*w),
    w -= lr*m (`mxnet_tpu/optimizer/optimizer.py:186-203`)."""

    elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def init_state(self, w):
        if not self.momentum:
            return ()
        return (torch.zeros_like(w, requires_grad=False),)

    def _step(self, w, g, sv, lr, wd):
        if wd:
            g.add_(w, alpha=wd)
        if self.momentum:
            m = sv[0]
            m.mul_(self.momentum).add_(g)
            g = m
        w.sub_(lr * g)

    def _multi_step(self, ws, gs, svs, lr, wd):
        _add_wd(gs, ws, wd)
        if self.momentum:
            ms = [sv[0] for sv in svs]
            torch._foreach_mul_(ms, self.momentum)
            torch._foreach_add_(ms, gs)
            gs = ms
        torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))


@register
class Adam(Optimizer):
    """Adam with bias correction and a per-parameter step count t on the
    device (`mxnet_tpu/optimizer/optimizer.py:219-240`): t += 1, then
    m / (1 - beta1^t) and v / (1 - beta2^t), the corrections taken in
    float64 on the device."""

    elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, w):
        return (torch.zeros_like(w, requires_grad=False),
                torch.zeros_like(w, requires_grad=False),
                torch.zeros((), dtype=torch.int32, device=w.device))

    def _corrections(self, ts):
        """t += 1 on every count; (1 - beta1^t, 1 - beta2^t) per count,
        0-d float64 tensors (a weight reads them in its dtype: fp32's
        1 - 0.999 would carry 5e-5 of relative error, the JAX package's
        beta^t in fp32)."""
        torch._foreach_add_(ts, 1)
        tf = [t.double() for t in ts]
        out = []
        for beta in (self.beta1, self.beta2):
            c = torch._foreach_pow(beta, tf)
            torch._foreach_neg_(c)
            torch._foreach_add_(c, 1.0)
            out.append(c)
        return out

    def _step(self, w, g, sv, lr, wd):
        m, v, t = sv
        (c1,), (c2,) = self._corrections([t])
        if wd:
            g.add_(w, alpha=wd)
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        mhat = m / c1
        vhat = v / c2
        w.sub_(lr * mhat / (vhat.sqrt_() + self.epsilon))

    def _multi_step(self, ws, gs, svs, lr, wd):
        ms, vs, ts = ([sv[k] for sv in svs] for k in range(3))
        c1, c2 = self._corrections(ts)
        _add_wd(gs, ws, wd)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - self.beta2)
        # the corrections differ per weight and are 0-d: the list forms
        # broadcast them one tensor at a time
        mhat = torch._foreach_div(ms, c1)
        vhat = torch._foreach_div(vs, c2)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, self.epsilon)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, vhat)
        torch._foreach_sub_(ws, mhat)


# ---------------------------------------------------------------------------
# the reference's multi-tensor SGD (src/operator/optimizer_op.cc
# multi_sgd_update / multi_sgd_mom_update): one pass over many parameters
# ---------------------------------------------------------------------------
def fused_sgd_mom_kernel(params, moms, grads, lr, momentum=0.9, wd=0.0,
                         rescale_grad=1.0):
    """Pure form: params / grads (and moms, or None without momentum) are
    matching lists of tensors; returns (new_params, new_moms), each in its
    input's dtype. The arithmetic is in fp32 (g = g*rescale + wd*w;
    m = momentum*m + g; w -= lr*m), as the JAX package's one flat fp32
    vector; lr, momentum, wd and rescale_grad are floats or 0-d fp32
    tensors."""
    p32 = [p.detach().to(torch.float32, copy=True) for p in params]
    g32 = [g.detach().to(torch.float32, copy=True) for g in grads]
    torch._foreach_mul_(g32, rescale_grad)
    torch._foreach_add_(g32, torch._foreach_mul(p32, wd))
    m32 = None
    upd = g32
    if moms is not None:
        m32 = [m.detach().to(torch.float32, copy=True) for m in moms]
        torch._foreach_mul_(m32, momentum)
        torch._foreach_add_(m32, g32)
        upd = m32
    torch._foreach_sub_(p32, torch._foreach_mul(upd, lr))
    new_p = [a.to(p.dtype) for a, p in zip(p32, params)]
    if moms is None:
        return new_p, None
    return new_p, [a.to(m.dtype) for a, m in zip(m32, moms)]


def multi_sgd_mom_update(weights, grads, moms, lr, momentum=0.9, wd=0.0,
                         rescale_grad=1.0):
    """Imperative multi-tensor SGD with momentum (reference:
    mx.nd.multi_sgd_mom_update): every weight and momentum NDArray is
    written in place; each keeps its dtype."""
    with torch.no_grad():
        new_p, new_m = fused_sgd_mom_kernel(
            [w._data for w in weights], [m._data for m in moms],
            [g._data for g in grads], lr, momentum, wd, rescale_grad)
        torch._foreach_copy_([w._data for w in weights], new_p)
        torch._foreach_copy_([m._data for m in moms], new_m)
    return weights


def multi_sgd_update(weights, grads, lr, wd=0.0, rescale_grad=1.0):
    """Momentum-free form (reference: mx.nd.multi_sgd_update)."""
    with torch.no_grad():
        new_p, _ = fused_sgd_mom_kernel(
            [w._data for w in weights], None, [g._data for g in grads], lr,
            0.0, wd, rescale_grad)
        torch._foreach_copy_([w._data for w in weights], new_p)
    return weights
