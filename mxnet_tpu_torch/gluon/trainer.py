"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py:46-450`).

Applies an optimizer to a set of Parameters after `backward()`, one
parameter at a time, behind the guard of `mxnet_tpu/gluon/trainer.py:
403-419`: with float16 AMP's loss scaler, unscale, judge the overflow,
move the scale and skip the update on an overflow; without one,
`skip_nonfinite` skips on inf / nan (`amp.grads_nonfinite`). Every
parameter lives once, on its own device, so
the `"device"`, `"local"` and `None` key-value stores are the same no-op
store and `allreduce_grads()` has nothing to do. The distributed
stores, updates on the store, gradient compression, the captured step
and sharding raise, naming their ROADMAP.md item.
"""
from __future__ import annotations

from .. import amp, profiler
from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


def _unported(what, item):
    return MXNetError(f"Trainer: {what} is not ported yet (ROADMAP.md, "
                      f"{item})")


class Trainer:
    """`Trainer(params, optimizer, optimizer_params)`; `step(batch_size)`
    rescales the gradients by 1/batch_size and updates every parameter
    whose grad_req is not "null". `skip_nonfinite=True` skips the whole
    update when any gradient holds an inf or a nan; under float16 AMP
    the loss scaler's guard does (`update`)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, skip_nonfinite=False):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or a list of "
                             "Parameter")
        if kvstore not in _LOCAL_STORES:
            raise _unported(f"kvstore={kvstore!r}",
                            "Queue 1 [5b]: distribution and sharding")
        if update_on_kvstore:
            raise _unported("update_on_kvstore=True",
                            "Queue 1 [5b]: distribution and sharding")
        if compression_params:
            raise _unported("gradient compression",
                            "Queue 1 [5b]: distribution and sharding")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
        self._params = list(params)
        param_dict = {i: p for i, p in enumerate(self._params)}
        self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)
        self.skip_nonfinite = skip_nonfinite

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Aggregate gradients across devices: nothing to do, every
        parameter lives once."""

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by 1/batch_size and apply one update."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply one update with rescale_grad 1/batch_size, unless the
        guard (`_guard_says_skip`) skips it."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        pairs = self._updatable_pairs(ignore_stale_grad)
        if self._guard_says_skip():
            return
        for i, p in pairs:
            self._updater(i, p.grad(), p.data())

    def _guard_says_skip(self):
        """With AMP's loss scaler: unscale the gradients, judge the
        overflow, move the scale, and skip on an overflow. Without one,
        skip on inf / nan if `skip_nonfinite`. One `nonfinite_guard`
        dispatch either way."""
        scaler = amp.scaler()
        if scaler is not None:
            profiler.record_dispatch("nonfinite_guard")
            amp.unscale(self)
            overflow = scaler.has_overflow(self._params)
            scaler.update_scale(overflow)
            return overflow
        if self.skip_nonfinite:
            profiler.record_dispatch("nonfinite_guard")
            return amp.grads_nonfinite(self._params)
        return False

    def _updatable_pairs(self, ignore_stale_grad):
        pairs = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if p._grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(f"Parameter {p.name} has no gradient; run "
                                 f"backward first or set ignore_stale_grad")
            pairs.append((i, p))
        return pairs

    def capture(self, *args, **kwargs):
        raise _unported("capture() (one captured step)",
                        "Queue 1 item 3: CUDA-graph capture")

    def shard(self, *args, **kwargs):
        raise _unported("shard()", "Queue 1 [5b]: distribution and sharding")
