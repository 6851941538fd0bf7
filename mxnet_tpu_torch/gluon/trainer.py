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

The store (`kvstore=`, any kind `kvstore.create` takes, or a KVStore)
carries the gradients across ranks. Each rank's gradient is its own (the
sum or mean over its own rows, as its loss says); on a cross-rank store
('dist_sync', 'ici', ...; one process a card) `allreduce_grads` sums it
over the store's group, one `allreduce_flat` a fused bucket (one a
parameter unfused), and `step(batch_size)` rescales by 1/batch_size, so
the caller passes the global batch size, as with MXNet's dist_sync. On
'local' / 'device', or a group of one, there is nothing to sum. The
eager path keeps BatchNorm's statistics per rank. `update_on_kvstore=
True` runs the optimizer on the store (push the reduced gradient, pull
the weight back; per parameter, as in the JAX package), and
`compression_params` configures the store's gradient compression, which
engages on its stacked pushes (`kvstore.set_gradient_compression`).

`capture(loss_fn)` returns the whole step as one `cachedop.CachedStep`
(a CUDA graph on the card), with the gradient reduction inside the graph
over a store that has a mesh (`KVStore.capture_spec`). `shard()`,
`resize_mesh()` and shard plans raise (ROADMAP.md Queue 1 [5d]).
"""
from __future__ import annotations

import pickle
import time

import torch

from .. import amp, engine, profiler
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..fault import injection as _finj
from ..ndarray.ndarray import NDArray
from ..observability import registry as _obs_registry
from ..observability import tracer as _tracer
from ..optimizer import multi_tensor
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

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
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
        self._params = list(params)
        # int keys for the Trainer's updater, str keys for the store's
        # (it stringifies them): lr_mult / wd_mult hit either way
        param_dict = {i: p for i, p in enumerate(self._params)}
        param_dict.update({str(i): p for i, p in enumerate(self._params)})
        self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._fused = bool(fused) and not bool(update_on_kvstore) and \
            multi_tensor.supports(self._optimizer)
        self._updater = opt_mod.get_updater(self._optimizer,
                                            fused=self._fused)
        self._kvstore = kvs_mod.create(kvstore, device=self._param_device()) \
            if kvstore else None
        if compression_params:
            if self._kvstore is None:
                raise MXNetError("compression_params requires a kvstore")
            self._kvstore.set_gradient_compression(compression_params)
        self._update_on_kvstore = bool(update_on_kvstore)
        if self._update_on_kvstore:
            if self._kvstore is None:
                raise MXNetError("update_on_kvstore=True requires a kvstore")
            self._kvstore.set_optimizer(self._optimizer)
        self._kv_keys = set()
        # set once a captured sharded step keeps only this rank's rows of
        # some optimizer states (`parallel._comm.sharded_leaf`)
        self._zero_states = False
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

    def _param_device(self):
        """The device of the first parameter that has one (its data or
        its deferred initialisation), else None (the card)."""
        for p in self._params:
            if p._data is not None:
                return p._data._data.device
            if p._deferred_init is not None:
                return p._deferred_init[1]
        return None

    def _init_kvstore(self):
        """Give the store a copy of each parameter it does not hold yet
        (incremental: deferred parameters join once they exist). Only a
        store that runs the optimizer holds the weights."""
        if not self._update_on_kvstore:
            return
        for i, p in enumerate(self._params):
            if i not in self._kv_keys and p._data is not None:
                self._kvstore.init(i, p.data())
                self._kv_keys.add(i)

    def _reduces(self):
        """Whether the gradients go through the store's collectives: an
        'ici' store with a process group (of one rank too, where each
        collective is an identity the card still runs)."""
        kv = self._kvstore
        return kv is not None and kv._group()[0] is not None

    def allreduce_grads(self):
        """Sum every gradient over the store's ranks, in place: one
        `allreduce_flat` a fused bucket, one a parameter unfused; nothing
        on a local store or without a process group."""
        if _tracer.ACTIVE:
            with _tracer.span("Trainer.allreduce_grads", cat="trainer"):
                return self._allreduce_grads_impl()
        return self._allreduce_grads_impl()

    def _allreduce_grads_impl(self):
        if not self._reduces():
            return
        if self._fused:
            groups = [[p for _, p in b] for b in
                      self._get_buckets(self._updatable_pairs(True))]
        else:
            groups = [[p] for p in self._params
                      if p.grad_req != "null" and p._grad is not None]
        with torch.no_grad():
            for ps in groups:
                grads = [p._grad._data for p in ps]
                torch._foreach_copy_(grads,
                                     self._kvstore.allreduce_flat(grads))
                if not self._fused:
                    profiler.record_dispatch("allreduce")

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
        self._init_kvstore()
        self.allreduce_grads()
        self._apply_update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply one update with rescale_grad 1/batch_size, behind the
        guard (no allreduce, no step count)."""
        if self._update_on_kvstore:
            raise MXNetError("update() cannot be called when "
                             "update_on_kvstore=True: the store owns the "
                             "optimizer; use step()")
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
        if self._zero_states:
            self._unshard_states()
        if self._fused:
            self._fused_update(ignore_stale_grad)
            return
        if self._guard_says_skip():
            self._note_skip("AMP overflow / nonfinite gradients")
            return
        for i, p in self._updatable_pairs(ignore_stale_grad):
            if self._update_on_kvstore:
                # the gradient is reduced already: a replicated push
                self._kvstore.push(i, [p.grad()], layout="replicated")
                self._kvstore.pull(i, out=p.data())
            else:
                self._updater(i, p.grad(), p.data())
        self._note_applied()

    def _unshard_states(self):
        """Gather the states a captured sharded step left as this rank's
        rows, for an eager update (a collective every rank joins)."""
        from ..parallel import _comm
        for k, v in self._updater.states.items():
            if any(_comm.leaf_shard(s._data) is not None for s in v):
                self._updater.states[k] = tuple(
                    NDArray(_comm.gather_leaf(s._data)) for s in v)
        self._zero_states = False

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
        the host; the store's blob when the store runs the optimizer. A
        ZeRO-sharded state (`capture(sharded_update=True)`) is gathered
        whole first, a collective every rank of its group joins, so the
        blob restores at any number of ranks."""
        if self._update_on_kvstore:
            return self._kvstore.optimizer_states_bytes()
        from ..parallel import _comm
        states = {k: tuple(_comm.gather_leaf(s._data).detach().cpu()
                           for s in v)
                  for k, v in self._updater.states.items()}
        return pickle.dumps({"num_update": self._optimizer.num_update,
                             "states": states})

    def load_states_bytes(self, blob):
        """Inverse of `states_bytes`: each state goes to its parameter's
        device, whole (a captured sharded step takes its rows again at
        its next call)."""
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states_bytes(blob)
            return
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

        Over a store with a mesh (`KVStore.capture_spec`) the batch is
        this rank's rows (`step(..., global_batch=True)` cuts a global
        batch that every rank holds) and the gradients are reduced inside
        the graph (`grad_reduce` 'mean' or 'sum'); `sharded_update=True`
        also shards the update (ZeRO-1) and needs such a store over more
        than one rank."""
        from ..cachedop import CachedStep
        return CachedStep(self, loss_fn, sharded_update=sharded_update,
                          grad_reduce=grad_reduce)

    @property
    def shard_plan(self):
        """The store's rule-driven shard plan: none in the port ([5d])."""
        return None

    def shard(self, *args, **kwargs):
        raise _unported("shard()", "Queue 1 [5d]: rule-driven sharding")

    def resize_mesh(self, *args, **kwargs):
        raise _unported("resize_mesh()", "Queue 1 [5d]: rule-driven sharding")
