"""One training step as one CUDA graph (counterpart of
`mxnet_tpu/cachedop.py`, the whole-step CachedOp).

`Trainer.capture(loss_fn)` (or `mx.jit_step(trainer, loss_fn)`) returns
a `CachedStep`. Calling it with a batch runs the whole step, the
`record` / `backward` / `Trainer.step` triple:

  * `loss_fn(*batch)` forward under `autograd.record()` (BatchNorm's
    running statistics are written in place, so they are carried);
  * `autograd.backward` with the loss scale as the head's cotangent;
  * the guard, under `skip_nonfinite` or float16 AMP's scaler: one
    device pass a dtype counts the non-finite gradients and unscales
    them (`_check_and_unscale`); the update is
    then selected on the device, so a skipped step leaves every weight,
    state and Adam count bit for bit as it was, as the JAX `lax.cond`
    does;
  * the fused multi-tensor update over the Trainer's buckets
    (`optimizer/multi_tensor.py`, the same launches as
    `Trainer(fused=True).step`).

On a card each cache entry is one `torch.cuda.CUDAGraph` over static
batch buffers, in the `CachedStep`'s own memory pool: a trial step on a
side stream (its effects undone) builds gradients, caches and kernels,
then the step is captured, and every call copies the batch in, fills
the step's scalars (rescale, the inverse loss scale with the `grad.nan`
poison, the loss scale, each group's lr and wd: `DeviceScalars`) and
replays the graph. An lr schedule or a moving loss scale never captures
again. Parameters, gradients and states keep their addresses (updates
are in place), and the graph registers the device's dropout generator,
so each replay draws new masks. The host reads one flag after the
replay, only when a guard is active, to move the loss scale and the
skip streak and to roll back the update counts of a skipped step.

On the CPU there is no graph: the same step program runs eagerly
through the same cache (same keys, misses and fallbacks), which is what
the CPU tests hold against the JAX captured step.

The kernel wrappers count their launches on the host
(`ops.kernels.LAUNCHES`), and so does `profiler.record_dispatch`; a
capture launches nothing, so each entry keeps the counts its capture
added and adds them again at every replay (`cudagraph_replays` counts
the replays): N replays count N steps. A batch argument that reaches a
card's step off its device is copied on the step's critical path and
counted (`prefetch_h2d_sync`, `prefetch.record_sync_h2d`).

Entries are keyed on (batch shapes and dtypes, the parameters' structure
and tensors, the states' structure and tensors, the guard's mode, the
hyperparameters and lr / wd groups, the autocast dtype, the clip) and a
miss names the first field that changed (`cachedop_cache_misses{reason=}`).
What cannot be captured falls back to the imperative path, with its
reason on `cachedop_fallbacks{reason=}` and `last_fallback_reason`: an
optimizer the fused update cannot reproduce (`optimizer`), a deferred
initialisation (`deferred_init`), no gradients (`no_grads`), a host
read inside `loss_fn` (`trace_error:CaptureHostRead`, on both devices)
or another failure of the trial step (`trace_error:<type>`), a failed
capture (`compile_error:<type>`), the optimizer on the store
(`update_on_kvstore`), a compressing store (`compression`), a
multi-rank store without a mesh (`multiprocess`), a global batch whose
rows do not split over the mesh (`batch_not_divisible`).

Over a store with a mesh (`KVStore.capture_spec()` not None: an 'ici'
store with a mesh attached, of one rank or more) the step is the JAX
package's `shard_map` step, one process a rank: the batch is this rank's
rows, as `parallel.shard_batch` and a prefetcher staging for the store
hand them out (a tensor does not say which rows it holds, so a global
batch that every rank holds is cut to this rank's rows only when the
call says `global_batch=True`), the default `batch_size` is the global
one (this rank's rows times P), and inside the graph
the loss and every gradient are summed over the `dp` group by NCCL
(`KVStore.graph_allreduce`), times 1/P with `grad_reduce="mean"` (for a
loss that is the mean of this rank's rows), not with "sum". BatchNorm
normalises with each rank's own statistics, and the running statistics
are averaged over the ranks after the backward. `sharded_update=True`
(ZeRO-1, arXiv:2004.13336; needs such a store) reduce-scatters each
eligible gradient along dim 0 (`Optimizer.elementwise`, dim 0 a
multiple of P), updates this rank's block of rows with the optimizer
state it keeps for them (the state leaves become this rank's rows,
marked `parallel._comm.sharded_leaf`, so that `Trainer.states_bytes`
and checkpoints gather them), and all-gathers the weights; the other
parameters take the replicated update in the same graph. The
collectives run once in the trial step, before the capture, so that the
group's communicator exists when the graph is recorded; each replay
counts `kv_collective_bytes{op=in_graph_psum}` (or
`in_graph_reduce_scatter`) with the gradients' bytes. The imperative
fallback over such a store runs the eager store path on this rank's
rows (gradients summed over the ranks; with "mean" the rescale takes
the global batch times P, which makes it the captured step's).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import OrderedDict

import torch

from . import amp, autograd, engine, profiler
from . import prefetch as _prefetch
from . import random as _random
from .base import MXNetError
from .fault import injection as _finj
from .gluon import block as _block
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray
from .observability import registry as _obs_registry
from .observability import tracer as _tracer
from .ops import kernels as _kernels
from .optimizer import multi_tensor
from .parallel import _comm

__all__ = ["CachedStep", "jit_step"]

_reg = _obs_registry()
_hits = _reg.counter("cachedop_cache_hits")
_miss_counters = {}      # reason -> Counter cachedop_cache_misses{reason=}
_fallback_counters = {}  # reason -> Counter cachedop_fallbacks{reason=}

# cache-key layout; positions name a miss's reason
_KEY_FIELDS = ("shape_change", "param_change", "state_change", "scale_mode",
               "hyper_change", "autocast", "mesh", "sharded", "grad_reduce",
               "clip")

# entries kept per CachedStep (an LRU): each holds a graph and its buffers
_CACHE_MAX = 8

# scalar slots of a step: rescale (times the poison without a guard),
# the inverse loss scale (times the poison under a guard), the loss
# scale, the poison (1, or NaN when grad.nan fires); each bucket's group
# scalars follow
_RESCALE, _INV, _LOSS_SCALE, _POISON, _N_FIXED = 0, 1, 2, 3, 4


def _miss(reason):
    c = _miss_counters.get(reason)
    if c is None:
        c = _miss_counters[reason] = _reg.counter("cachedop_cache_misses",
                                                  reason=reason)
    c.inc()


def _fallback(reason):
    c = _fallback_counters.get(reason)
    if c is None:
        c = _fallback_counters[reason] = _reg.counter("cachedop_fallbacks",
                                                      reason=reason)
    c.inc()


class _CaptureUnsupported(Exception):
    """Internal: this call cannot be captured; take the imperative path."""

    def __init__(self, reason):
        self.reason = reason
        super().__init__(reason)


def _flatten(out):
    """NDArray leaves of `loss_fn`'s output (nested lists, tuples and
    dicts), loss first, and a function that rebuilds the structure."""
    if isinstance(out, NDArray):
        return [out], lambda leaves: leaves[0]
    if isinstance(out, (list, tuple)):
        parts = [_flatten(o) for o in out]

        def build(leaves, parts=parts, kind=type(out)):
            res, k = [], 0
            for lv, fn in parts:
                res.append(fn(leaves[k:k + len(lv)]))
                k += len(lv)
            return kind(res)
        return [x for lv, _ in parts for x in lv], build
    if isinstance(out, dict):
        keys = list(out)
        leaves, build = _flatten([out[k] for k in keys])
        return leaves, lambda lv: dict(zip(keys, build(lv)))
    raise MXNetError("capture: loss_fn must return NDArray(s), loss leaf "
                     "first")


def _check_and_unscale(grads, dtype, found, inv, scal):
    """Add 1 to `found` if a gradient of `grads` (one dtype) holds an
    inf or a NaN, then multiply them by `inv` (a 1-element fp32 slot of
    `scal`), on the device. fp32 and float16 take the AMP kernel, which
    checks the values before the product; bfloat16, which it does not
    take, goes through 0 * g (0 where finite, NaN where not) and a sum
    of absolute values that only a NaN can leave nonzero."""
    if dtype in (torch.float32, torch.float16):
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv)
        return
    sums = torch._foreach_norm(torch._foreach_mul(grads, 0.0), 1)
    found.add_(torch.stack(sums).sum().isnan().float())
    torch._foreach_mul_(grads, scal.get(_INV, dtype))


def _sig(t):
    return (tuple(t.shape), str(t.dtype), str(t.device))


_NEEDS_MESH = ("sharded_update=True needs an 'ici' kvstore with a "
               "multi-rank mesh attached (kvstore.set_mesh)")


def _spec_of(trainer):
    """The store's `capture_spec()` (None without a store or a mesh)."""
    kv = trainer._kvstore
    return None if kv is None else kv.capture_spec()


def jit_step(trainer, loss_fn, **kwargs):
    """`trainer.capture(loss_fn, **kwargs)`:

        step = mx.jit_step(trainer, lambda x, y: lossf(net(x), y).mean())
        for x, y in batches:
            loss = step(x, y)
    """
    return CachedStep(trainer, loss_fn, **kwargs)


class _Entry:
    """One cache entry: the step program over static buffers, and on a
    card its CUDA graph and the launch counts one replay adds."""

    def __init__(self):
        self.graph = None
        self.launches = {}
        self.dispatches = {}
        self.seconds = None


class CachedStep:
    """One captured training step (see the module docstring). Calling it
    with a batch runs forward, backward, guard and fused update, and
    returns `loss_fn`'s output (the raw loss first) as NDArrays.

    `grad_reduce` ('mean' or 'sum') states how the in-graph reduction
    over a store's ranks composes with the loss (module docstring)."""

    def __init__(self, trainer, loss_fn, sharded_update=False,
                 grad_reduce="mean"):
        if grad_reduce not in ("mean", "sum"):
            raise MXNetError(f"grad_reduce must be 'mean' or 'sum', got "
                             f"{grad_reduce!r}")
        kv = trainer._kvstore
        if sharded_update and (kv is None or kv.type != "ici"):
            raise MXNetError(_NEEDS_MESH)
        self._sharded = bool(sharded_update)
        self._grad_reduce = grad_reduce
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._cache = OrderedDict()    # LRU: key -> _Entry or reason
        self._last_key = None
        self._warned = set()
        self._pool = None              # the graphs' memory pool
        self.last_fallback_reason = None

    @property
    def cache_size(self):
        return len(self._cache)

    @property
    def last_compile_seconds(self):
        """Wall seconds of the current entry's build (trial step and
        capture), or None."""
        entry = self._cache.get(self._last_key)
        return entry.seconds if isinstance(entry, _Entry) else None

    def __call__(self, *batch, batch_size=None, global_batch=False):
        if _tracer.ACTIVE:
            with _tracer.span("Trainer.captured_step", cat="trainer",
                              args={"params": len(self._trainer._params),
                                    "cache_size": len(self._cache)}):
                return self._call_impl(batch, batch_size, global_batch)
        return self._call_impl(batch, batch_size, global_batch)

    def _call_impl(self, batch, batch_size, global_batch):
        dev = self._device()
        if dev.type == "cuda":
            # a batch off the card is copied on the step's critical path
            # (`prefetch.DevicePrefetcher` delivers it there instead)
            for b in batch:
                t = b._data if isinstance(b, NDArray) else b
                if not (isinstance(t, torch.Tensor) and t.device == dev):
                    _prefetch.record_sync_h2d(
                        t.numel() * t.element_size()
                        if isinstance(t, torch.Tensor) else 0)
        batch_nd = [b if isinstance(b, NDArray) else NDArray(
            torch.as_tensor(b, device=dev)) for b in batch]
        given = batch_size is not None
        if not given:
            if not batch_nd or batch_nd[0].ndim == 0:
                raise MXNetError("capture: pass batch_size= when the first "
                                 "batch argument has no leading batch dim")
            batch_size = int(batch_nd[0].shape[0])
        self.last_fallback_reason = None
        spec = _spec_of(self._trainer)
        try:
            if spec is not None:
                batch_nd, batch_size = self._local_rows(
                    spec, batch_nd, batch_size, given, global_batch)
            return self._captured(batch_nd, batch_size, spec)
        except _CaptureUnsupported as e:
            self.last_fallback_reason = e.reason
            _fallback(e.reason)
            if e.reason not in self._warned:
                self._warned.add(e.reason)
                cause = f": {e.__cause__}" if e.__cause__ is not None \
                    else ""
                warnings.warn(f"CachedStep: falling back to the imperative "
                              f"path ({e.reason}{cause})", RuntimeWarning,
                              stacklevel=3)
            if spec is not None and self._grad_reduce == "mean":
                # the eager store path sums each rank's mean-loss
                # gradient: P times the global mean's
                batch_size *= spec[2]
            return self._imperative(batch_nd, batch_size)

    def _local_rows(self, spec, batch_nd, batch_size, given, global_batch):
        """This rank's rows of each batch argument and the global batch
        size (unless `given`): the batch is this rank's rows (its size
        times P is the global one), or, with `global_batch`, the global
        batch, cut here."""
        mesh, axis, n = spec
        if not global_batch:
            return batch_nd, batch_size if given else batch_size * n
        from .parallel.mesh import Sharding
        sh = Sharding(mesh, (axis,))
        out = []
        for b in batch_nd:
            t = b._data
            if t.dim() == 0 or t.shape[0] % n:
                raise _CaptureUnsupported("batch_not_divisible")
            out.append(NDArray(sh.local_rows(t)))
        return out, batch_size

    def _device(self):
        for p in self._trainer._params:
            if p._data is not None:
                return p._data._data.device
        return torch.device("cpu")

    # --------------------------------------------------- imperative twin
    def _imperative(self, batch_nd, batch_size):
        """The reference semantics: record, backward on the (AMP-scaled)
        loss, `Trainer.step`; returns the raw loss as the captured path
        does."""
        with autograd.record():
            out = self._loss_fn(*batch_nd)
            leaves, _ = _flatten(out)
            sc = amp.scaler()
            head = leaves[0] * sc.loss_scale if sc is not None \
                else leaves[0]
        head.backward()
        self._trainer.step(batch_size)
        return out

    # ------------------------------------------------------ captured path
    def _captured(self, batch_nd, batch_size, spec):
        tr = self._trainer
        opt = tr._optimizer
        kv = tr._kvstore
        if tr._update_on_kvstore:
            raise _CaptureUnsupported("update_on_kvstore")
        if not multi_tensor.supports(opt):
            raise _CaptureUnsupported("optimizer")
        if kv is not None and kv.type == "ici":
            if kv._compression is not None:
                raise _CaptureUnsupported("compression")
            if spec is None and kv._group()[1] > 1:
                raise _CaptureUnsupported("multiprocess")
        if self._sharded and (spec is None or spec[2] <= 1):
            raise MXNetError(_NEEDS_MESH)
        params = tr._params
        if any(p._deferred_init is not None for p in params):
            raise _CaptureUnsupported("deferred_init")
        diff = [(i, p) for i, p in enumerate(params)
                if p.grad_req != "null" and p._data is not None
                and p._grad is not None]
        if not diff:
            raise _CaptureUnsupported("no_grads")
        scaler = amp.scaler()
        scale_mode = ("amp" if scaler is not None
                      else "skip" if tr.skip_nonfinite else "none")
        updater = tr._updater
        state_nds = []
        for i, p in diff:
            if i not in updater.states:
                updater.states[i] = opt.create_state_multi_precision(
                    i, p.data())
            state_nds.append(tuple(updater.states[i]))
        shard_ok = [self._shardable(spec, p, sv)
                    for (_, p), sv in zip(diff, state_nds)]
        if any(shard_ok):
            state_nds = self._shard_states(spec, diff, state_nds, shard_ok)

        key = (
            tuple(_sig(b._data) for b in batch_nd),
            tuple((p._struct_sig(),) + (() if p._data is None else (
                p._data._data.data_ptr(),
                None if p._grad is None else p._grad._data.data_ptr()))
                for p in params),
            tuple(tuple((_sig(s._data), s._data.data_ptr()) for s in sv)
                  for sv in state_nds),
            scale_mode,
            (multi_tensor._hyper_sig(opt),
             tuple(multi_tensor.hyper_groups(opt, [i for i, _ in diff]))),
            str(amp.autocast_dtype()),
            None if spec is None else (spec[0].fingerprint(), spec[1],
                                       spec[2]),
            self._sharded,
            self._grad_reduce,
            None if opt.clip_gradient is None else float(opt.clip_gradient),
        )
        entry = self._cache.get(key)
        if entry is None:
            _miss(self._miss_reason(key))
            profiler.record_jit_cache(False)
            self._last_key = key
            try:
                entry = self._build(batch_nd, diff, state_nds, scale_mode,
                                    spec, shard_ok)
            except _CaptureUnsupported as e:
                # later steps with this signature go straight to the
                # imperative path
                self._store(key, e.reason)
                raise
            self._store(key, entry)
        else:
            self._cache.move_to_end(key)
            self._last_key = key
            if not isinstance(entry, _Entry):
                raise _CaptureUnsupported(entry)
            _hits.inc()
            profiler.record_jit_cache(True)
        return self._dispatch(entry, batch_nd, diff, batch_size, scaler,
                              scale_mode)

    def _shardable(self, spec, p, sv):
        """Whether a parameter takes the sharded update: an elementwise
        rule, dim 0 a multiple of P, and each state leaf the weight's
        shape, 0-d, or this rank's rows of it already."""
        if not self._sharded or spec is None:
            return False
        n = spec[2]
        w = p.data()._data
        if not (type(self._trainer._optimizer).elementwise and w.dim() >= 1
                and w.shape[0] >= n and w.shape[0] % n == 0):
            return False
        rows = (w.shape[0] // n,) + tuple(w.shape[1:])
        return all(tuple(s.shape) == tuple(w.shape) or s.ndim == 0
                   or (tuple(s.shape) == rows
                       and _comm.leaf_shard(s._data) is not None)
                   for s in sv)

    def _shard_states(self, spec, diff, state_nds, shard_ok):
        """Replace each sharded parameter's whole state leaves by this
        rank's rows of them (marked `sharded_leaf`), in the updater."""
        mesh, axis, n = spec
        group, me = mesh.group(axis), mesh.axis_index(axis)
        states = self._trainer._updater.states
        out = []
        for (i, p), sv, ok in zip(diff, state_nds, shard_ok):
            rows = p.data().shape[0] // n
            if ok and any(s.ndim and _comm.leaf_shard(s._data) is None
                          for s in sv):
                sv = tuple(s if s.ndim == 0 or _comm.leaf_shard(s._data)
                           is not None else NDArray(_comm.sharded_leaf(
                               s._data.narrow(0, me * rows, rows).clone(),
                               group, 0)) for s in sv)
                states[i] = sv
                self._trainer._zero_states = True
            out.append(sv)
        return out

    def _store(self, key, entry):
        while len(self._cache) >= _CACHE_MAX:
            self._cache.popitem(last=False)
        self._cache[key] = entry

    def _miss_reason(self, key):
        last = self._last_key
        if last is None:
            return "first"
        for name, a, b in zip(_KEY_FIELDS, key, last):
            if a != b:
                return name
        return "other"

    # ------------------------------------------------------------ build
    def _build(self, batch_nd, diff, state_nds, scale_mode, spec, shard_ok):
        t0 = time.perf_counter()
        tr = self._trainer
        opt = tr._optimizer
        kv = tr._kvstore
        dev = batch_nd[0]._data.device if batch_nd else self._device()
        guard = scale_mode != "none"
        entry = _Entry()
        entry.guard = guard
        entry.static = [NDArray(b._data.detach().clone()) for b in batch_nd]
        mesh = axis = None
        n_rep = 1
        if spec is not None:
            mesh, axis, n_rep = spec
            me = mesh.axis_index(axis)
        mean = self._grad_reduce == "mean"
        # each parameter's update tensors: the weight, or this rank's rows
        # of it (a view) with the reduce-scattered gradient's buffer
        upd_w, upd_g = {}, {}
        for (i, p), ok in zip(diff, shard_ok):
            w, g = p._data._data, p._grad._data
            if ok:
                rows = w.shape[0] // n_rep
                upd_w[i] = w.narrow(0, me * rows, rows)
                upd_g[i] = torch.empty((rows,) + tuple(g.shape[1:]),
                                       dtype=g.dtype, device=g.device)
            else:
                upd_w[i], upd_g[i] = w, g
        cap = engine.get_bulk_size()
        buckets = multi_tensor.build_buckets(diff, cap)
        states_of = {i: st for (i, _), st in zip(diff, state_nds)}
        ups, base = [], _N_FIXED
        for bucket in buckets:
            up = multi_tensor.BucketUpdate(opt, bucket, unscale=False)
            tensors = ([upd_w[i] for i, _ in bucket],
                       [upd_g[i] for i, _ in bucket],
                       [tuple(s._data for s in states_of[i])
                        for i, _ in bucket])
            ups.append((up, tensors, base))
            base += up.n_scalars()
        entry.ups = ups
        entry.scal = multi_tensor.DeviceScalars(base, dev)
        grads = [upd_g[i] for i, _ in diff]
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        targets = [upd_w[i] for i, _ in diff] + \
            [s._data for sv in state_nds for s in sv]
        sharded = [(p._grad._data, upd_g[i], upd_w[i], p._data._data)
                   for (i, p), ok in zip(diff, shard_ok) if ok]
        replicated = [p._grad._data for (_, p), ok in zip(diff, shard_ok)
                      if not ok]
        entry.coll = (0 if spec is None else sum(
            p._grad._data.numel() * p._grad._data.element_size()
            for _, p in diff),
            "in_graph_reduce_scatter" if sharded else "in_graph_psum")
        entry.aux = None        # running statistics, known after the trial
        loss_fn = self._loss_fn
        scal = entry.scal

        def program():
            scal.begin()
            with autograd.record():
                out = loss_fn(*entry.static)
                leaves, build = _flatten(out)
            head = leaves[0]
            cot = None
            if scale_mode == "amp":
                cot = [NDArray(scal.get(_LOSS_SCALE, head._data.dtype)
                               .expand(head._data.shape))]
            autograd.backward([head], cot)
            found = None
            with torch.no_grad():
                if mesh is not None:
                    for g in replicated:
                        kv.graph_allreduce(g, axis, n_rep, mean=mean)
                    for g, gs, _, _ in sharded:
                        kv.graph_reduce_scatter(g, axis, n_rep, mean=mean,
                                                out=gs)
                    kv.graph_allreduce(head._data.detach(), axis, n_rep,
                                       mean=mean)
                    for t in entry.aux or ():
                        kv.graph_allreduce(t, axis, n_rep, mean=True)
                if guard:
                    # the poison marks the step itself: the check sees
                    # the gradients before their product with it
                    found = scal.buf[_POISON:_POISON + 1].isnan().float()
                    inv = scal.buf[_INV:_INV + 1]
                    for dt, gl in by_dtype.items():
                        _check_and_unscale(gl, dt, found, inv, scal)
                    if sharded:
                        # each rank checked its own rows
                        kv.graph_allreduce(found, axis, n_rep)
                    skip = found[0] > 0
                    backup = [t.clone() for t in targets]
                for up, tensors, b in ups:
                    up.run(tensors, scal, _RESCALE, _INV, b)
                if guard:
                    for t, k in zip(targets, backup):
                        torch.where(skip, k, t, out=t)
                for _, _, wl, w in sharded:
                    kv.graph_all_gather(wl, axis, out=w)
            return [x._data for x in leaves], build, found

        entry.program = program
        self._trial(entry, diff, state_nds, dev)
        if dev.type == "cuda":
            self._capture(entry, dev)
        entry.seconds = time.perf_counter() - t0
        return entry

    def _values(self, entry, poison):
        """The step's scalars, from the host's current values."""
        tr = self._trainer
        opt = tr._optimizer
        scaler = amp.scaler()
        rescale = float(opt.rescale_grad)
        inv = 1.0 if scaler is None else 1.0 / float(scaler.loss_scale)
        if entry.guard:
            inv *= poison
        else:
            rescale *= poison
        vals = [rescale, inv,
                1.0 if scaler is None else float(scaler.loss_scale), poison]
        for up, _, _ in entry.ups:
            vals += up.scalar_values(opt)
        return vals

    def _trial(self, entry, diff, state_nds, dev):
        """Run the step once with every effect undone (weights, states,
        gradients, auxiliary writes, the random draws): it builds the
        gradients' and the kernels' first-use work before a capture,
        and a host read inside `loss_fn` shows here, on both devices, as
        `trace_error:CaptureHostRead`. On a card it runs on a side
        stream."""
        tr = self._trainer
        keep = [p._data._data for p in tr._params if p._data is not None]
        keep += [p._grad._data for p in tr._params if p._grad is not None]
        keep += [s._data for sv in state_nds for s in sv]
        saved = [t.detach().clone() for t in keep]
        rng = _random._snapshot()
        entry.scal.fill(self._values(entry, 1.0))
        _block._aux_undo[0] = undo = {}
        _nd._capturing[0] = True
        side = None
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side) if side is not None \
                    else contextlib.nullcontext():
                entry.program()
        except _nd.CaptureHostRead as e:
            raise _CaptureUnsupported(f"trace_error:{type(e).__name__}") \
                from e
        except MXNetError:
            raise
        except Exception as e:
            raise _CaptureUnsupported(f"trace_error:{type(e).__name__}") \
                from e
        finally:
            _nd._capturing[0] = False
            _block._aux_undo[0] = None
            if entry.aux is None:
                entry.aux = [p.data()._data for p, _ in undo.values()]
            if side is not None:
                torch.cuda.current_stream(dev).wait_stream(side)
            with torch.no_grad():
                for t, s in zip(keep, saved):
                    t.copy_(s)
                for p, v in undo.values():
                    p.data()._data.copy_(v)
            _random._restore(rng)

    def _capture(self, entry, dev):
        """Record the step program as one CUDA graph in this step's pool;
        the launch and dispatch counts the capture added are moved to the
        entry, to be added at each replay."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(_random.generator(dev))
        launches = dict(_kernels.LAUNCHES)
        dispatches = {k: c.value for k, c in profiler._dispatch.items()}
        _nd._capturing[0] = True
        # with NCCL collectives in the graph, other threads (the process
        # group's watchdog) keep making CUDA calls while it is captured:
        # only this thread's calls are held to the capture's rules
        mode = "thread_local" if entry.coll[0] else "global"
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode=mode):
                outs = entry.program()
        except _nd.CaptureHostRead as e:
            raise _CaptureUnsupported(f"trace_error:{type(e).__name__}") \
                from e
        except MXNetError:
            raise
        except Exception as e:
            raise _CaptureUnsupported(
                f"compile_error:{type(e).__name__}") from e
        finally:
            _nd._capturing[0] = False
            entry.launches = {k: v - launches.get(k, 0)
                              for k, v in _kernels.LAUNCHES.items()
                              if v != launches.get(k, 0)}
            for k, v in launches.items():
                _kernels.LAUNCHES[k] = v
            for k, c in profiler._dispatch.items():
                n = c.value - dispatches.get(k, 0)
                if n:
                    entry.dispatches[k] = n
                    c.reset()
                    c.inc(dispatches.get(k, 0))
        entry.graph = graph
        entry.outs = outs

    # --------------------------------------------------------- dispatch
    def _dispatch(self, entry, batch_nd, diff, batch_size, scaler,
                  scale_mode):
        tr = self._trainer
        opt = tr._optimizer
        opt.rescale_grad = 1.0 / batch_size
        # the update counts move before the step (the lr schedule reads
        # them) and go back if the guard skips it
        snapshot = (opt.num_update,
                    {i: opt._index_update_count.get(i) for i, _ in diff})
        for i, _ in diff:
            opt._update_count(i)
        poison = (float("nan")
                  if _finj.ENABLED and _finj.should_fire("grad.nan")
                  else 1.0)
        profiler.record_dispatch("captured_step")
        if entry.coll[0]:
            from . import kvstore as _kvs
            _kvs._count_collective(entry.coll[1], entry.coll[0])
        for s, b in zip(entry.static, batch_nd):
            if s._data is not b._data:
                s._data.copy_(b._data)
        entry.scal.fill(self._values(entry, poison))
        if entry.graph is not None:
            entry.graph.replay()
            for k, n in entry.launches.items():
                _kernels.LAUNCHES[k] += n
            for k, n in entry.dispatches.items():
                profiler.record_dispatch(k, n)
            profiler._replays.inc()
            leaves, build, found = entry.outs
            leaves = [x.clone() for x in leaves]
        else:
            leaves, build, found = entry.program()

        applied = True
        if entry.guard:
            overflow = bool(found.item() > 0)   # the one host read
            applied = not overflow
            if scaler is not None:
                scaler.update_scale(overflow)
        if applied:
            tr._note_applied()
        else:
            num_update, counts = snapshot
            opt.num_update = num_update
            for i, c in counts.items():
                if c is None:
                    opt._index_update_count.pop(i, None)
                else:
                    opt._index_update_count[i] = c
            tr._note_skip("AMP overflow" if scale_mode == "amp"
                          else "nonfinite gradients")
        tr._tick_step()
        return build([NDArray(x) for x in leaves])
