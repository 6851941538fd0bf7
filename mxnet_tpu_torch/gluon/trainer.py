"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py`).

Applies an optimizer to a set of Parameters after `backward()`. By
default (`fused=True`, as in the JAX package) the parameters are grouped
into dtype-homogeneous buckets of at most `engine.get_bulk_size()`
gradient bytes and each bucket is updated in one fused multi-tensor
dispatch (`optimizer/multi_tensor.py`); `fused=False`, or an optimizer
whose update the fused rule cannot reproduce (`multi_tensor.supports`),
takes the per-parameter path.

The guard is the JAX package's (`:403-419`, `:473-530`): with float16
AMP's loss scaler, judge the overflow, move the scale and skip the
update on an overflow, the gradients unscaled either way; without one,
`skip_nonfinite` skips on inf / nan (`amp.grads_nonfinite`). Each skip
counts into `trainer_steps_skipped` and the streak
`consecutive_skipped_steps`; more than `max_skipped_steps` in a row
raise. The `grad.nan` fault point poisons every gradient in `step`.

`capture(loss_fn)` returns the whole step as one `cachedop.CachedStep`
(a CUDA graph on the card). Every parameter lives once, on its own
device, so the `"device"`, `"local"` and `None` key-value stores are the
same no-op store and `allreduce_grads()` has nothing to do. The
distributed stores, updates on the store, gradient compression, sharded
updates and `shard()` raise, naming their ROADMAP.md item.
"""
from __future__ import annotations

import pickle
import time

import torch

from .. import amp, engine, profiler
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..fault import injection as _finj
from ..ndarray.ndarray import NDArray
from ..observability import registry as _obs_registry
from ..observability import tracer as _tracer
from ..optimizer import multi_tensor
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")

_reg = _obs_registry()
_steps_counter = _reg.counter("trainer_steps")
_skips_counter = _reg.counter("trainer_steps_skipped")
_steps_s_gauge = _reg.gauge("trainer_steps_per_s")


def _unported(what, item):
    return MXNetError(f"Trainer: {what} is not ported yet (ROADMAP.md, "
                      f"{item})")


class Trainer:
    """`Trainer(params, optimizer, optimizer_params)`; `step(batch_size)`
    rescales the gradients by 1/batch_size and updates every parameter
    whose grad_req is not "null". `skip_nonfinite=True` skips the whole
    update when any gradient holds an inf or a nan; under float16 AMP
    the loss scaler's guard does. `max_skipped_steps=N` raises after
    more than N skips in a row. `fused` picks the bucketed update
    (default) or the per-parameter one."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, skip_nonfinite=False, fused=True,
                 max_skipped_steps=None):
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
        self._fused = bool(fused) and multi_tensor.supports(self._optimizer)
        self._updater = opt_mod.get_updater(self._optimizer,
                                            fused=self._fused)
        self._buckets = None
        self._bucket_sig = None
        self._last_step_t = None
        self.skip_nonfinite = skip_nonfinite
        self.max_skipped_steps = max_skipped_steps
        self._consecutive_skips = 0

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
        if _tracer.ACTIVE:
            with _tracer.span("Trainer.step", cat="trainer",
                              args={"batch_size": int(batch_size),
                                    "params": len(self._params),
                                    "fused": self._fused}):
                self._step_impl(batch_size, ignore_stale_grad)
        else:
            self._step_impl(batch_size, ignore_stale_grad)
        self._tick_step()

    def _step_impl(self, batch_size, ignore_stale_grad):
        self._optimizer.rescale_grad = 1.0 / batch_size
        if _finj.ENABLED and _finj.should_fire("grad.nan"):
            # the grad.nan fault point: every gradient becomes NaN, so the
            # skip_nonfinite / AMP-overflow guard is testable end to end
            with torch.no_grad():
                for p in self._params:
                    if p._grad is not None:
                        p._grad._data.mul_(float("nan"))
        self.allreduce_grads()
        self._apply_update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply one update with rescale_grad 1/batch_size, behind the
        guard (no allreduce, no step count)."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        self._apply_update(ignore_stale_grad)

    def _tick_step(self):
        """Per-step bookkeeping shared with the captured step: the step
        counter and the steps/s gauge."""
        _steps_counter.inc()
        now = time.perf_counter()
        last, self._last_step_t = self._last_step_t, now
        if last is not None and now > last:
            _steps_s_gauge.set(1.0 / (now - last))

    # ------------------------------------------------ skip-streak limit
    @property
    def consecutive_skipped_steps(self):
        return self._consecutive_skips

    def _note_skip(self, reason):
        self._consecutive_skips += 1
        _skips_counter.inc()
        if self.max_skipped_steps is not None and \
                self._consecutive_skips > self.max_skipped_steps:
            raise MXNetError(
                f"Trainer: {self._consecutive_skips} consecutive skipped "
                f"updates ({reason}) exceeds max_skipped_steps="
                f"{self.max_skipped_steps}: the gradients are persistently "
                f"non-finite; lower the learning rate or restore a "
                f"checkpoint")

    def _note_applied(self):
        self._consecutive_skips = 0

    # ------------------------------------------------------------ update
    def _apply_update(self, ignore_stale_grad):
        if self._fused:
            self._fused_update(ignore_stale_grad)
            return
        if self._guard_says_skip():
            self._note_skip("AMP overflow / nonfinite gradients")
            return
        for i, p in self._updatable_pairs(ignore_stale_grad):
            self._updater(i, p.grad(), p.data())
        self._note_applied()

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

    def _get_buckets(self, pairs):
        """The fused path's bucket layout, rebuilt only when the
        parameters' structure (deferred init, cast, grad_req) or the
        engine's bulk size changes."""
        cap = engine.get_bulk_size()
        sig = (cap, tuple((i, p._struct_sig()) for i, p in pairs))
        if sig != self._bucket_sig:
            self._buckets = multi_tensor.build_buckets(pairs, cap)
            self._bucket_sig = sig
            profiler.record_buckets(
                [sum(multi_tensor._grad_nbytes(p) for _, p in b)
                 for b in self._buckets])
        return self._buckets

    def _fused_update(self, ignore_stale_grad):
        """The update in O(buckets) dispatches: at most one guard, then
        one fused update a bucket with AMP's unscale folded in; the
        gradients outside the buckets are unscaled in one launch."""
        buckets = self._get_buckets(self._updatable_pairs(ignore_stale_grad))
        scaler = amp.scaler()
        if scaler is None and not buckets:
            return
        inv_scale = None
        if scaler is not None:
            # the per-parameter guard's protocol: the overflow is judged
            # and the gradients unscaled at the scale before this step
            profiler.record_dispatch("nonfinite_guard")
            if scaler.has_overflow(self._params):
                amp.unscale(self)
                scaler.update_scale(True)
                self._note_skip("AMP overflow")
                return
            inv_scale = 1.0 / scaler.loss_scale
            scaler.update_scale(False)
            bucketed = {id(p) for b in buckets for _, p in b}
            amp.unscale_arrays([p._grad._data for p in self._params
                                if p._grad is not None
                                and id(p) not in bucketed], inv_scale)
        elif self.skip_nonfinite:
            profiler.record_dispatch("nonfinite_guard")
            if amp.grads_nonfinite(self._params):
                self._note_skip("nonfinite gradients")
                return
        for bi, bucket in enumerate(buckets):
            if _tracer.ACTIVE:
                with _tracer.span("Trainer.fused_bucket", cat="trainer",
                                  args={"bucket": bi,
                                        "params": len(bucket)}):
                    self._updater.update_bucket(bucket, inv_scale=inv_scale)
            else:
                self._updater.update_bucket(bucket, inv_scale=inv_scale)
        self._note_applied()

    # ------------------------------------------------------------ states
    def states_bytes(self):
        """The optimizer state as one bytes blob (what `save_states`
        writes): the update count and each parameter's state tensors, on
        the host."""
        states = {k: tuple(s._data.detach().cpu() for s in v)
                  for k, v in self._updater.states.items()}
        return pickle.dumps({"num_update": self._optimizer.num_update,
                             "states": states})

    def load_states_bytes(self, blob):
        """Inverse of `states_bytes`: each state goes to its parameter's
        device."""
        data = pickle.loads(blob)
        self._optimizer.num_update = data["num_update"]
        states = {}
        for k, v in data["states"].items():
            p = self._params[k] if k < len(self._params) else None
            dev = p._data._data.device if p is not None and \
                p._data is not None else None
            states[k] = tuple(NDArray(t.to(dev) if dev is not None else t)
                              for t in v)
        self._updater.states = states

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self.states_bytes())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.load_states_bytes(f.read())

    # ---------------------------------------------------- captured step
    def capture(self, loss_fn, sharded_update=False, grad_reduce="mean"):
        """The whole training step, `loss_fn(*batch)` forward, backward,
        guard and fused update, as one `cachedop.CachedStep` (one CUDA
        graph a batch signature on the card):

            step = trainer.capture(lambda x, y: lossf(net(x), y).mean())
            for x, y in batches:
                loss = step(x, y)

        `sharded_update=True` raises (Queue 1 [5b])."""
        from ..cachedop import CachedStep
        return CachedStep(self, loss_fn, sharded_update=sharded_update,
                          grad_reduce=grad_reduce)

    def shard(self, *args, **kwargs):
        raise _unported("shard()", "Queue 1 [5b]: distribution and sharding")
