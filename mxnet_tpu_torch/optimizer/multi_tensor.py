"""The fused multi-tensor update of the Trainer (counterpart of
`mxnet_tpu/optimizer/multi_tensor.py`).

The per-parameter path launches a handful of kernels for every
parameter (about five for SGD with momentum, about twelve for Adam). The
fused path costs O(buckets) dispatches instead:

  * `build_buckets` groups the parameters into dtype-homogeneous buckets
    of at most `engine.get_bulk_size()` gradient bytes, in declaration
    order (a cap of 0 keeps one parameter a bucket);
  * `FusedUpdater.update_bucket` applies the optimizer to a whole bucket
    in one dispatch: each rule's `_multi_step` over `torch._foreach_*`
    lists, with `multi_precision` masters and the AMP unscale folded in
    (the gradients are unscaled in place, so `p.grad()` sees what the
    per-parameter path leaves behind).

The JAX package compiles one XLA region per bucket. Here a bucket's
update is a fixed sequence of foreach launches, built once per key and
counted by `profiler.record_jit_cache` as the JAX kernel cache is: the
key is (bucket signature, state signature, hyperparameters, unscale,
lr / wd groups), so `opt.momentum = 0` makes a new entry. lr, wd,
rescale and the inverse loss scale reach the launches as 0-d tensors of
one small device vector (`DeviceScalars`) that the host fills before the
update, which is what lets a captured CUDA graph (`cachedop.py`) replay
the same launches under an lr schedule. On a bfloat16 bucket without
masters those scalars are bfloat16, as the foreach kernels read a scalar
tensor in the list's dtype; the per-parameter path multiplies by Python
floats. A hand-written one-launch-a-bucket kernel is ROADMAP.md's
"Kernels the port must add".
"""
from __future__ import annotations

import numpy as np
import torch

from .. import profiler
from ..base import MXNetError
from .optimizer import Optimizer
from .updater import Updater

__all__ = ["FusedUpdater", "DeviceScalars", "build_buckets",
           "bucket_signature", "supports", "flat_layout", "split_flat",
           "apply_param_update", "sparse_update_rows",
           "classify_state_rows"]


def flat_layout(shapes):
    """(sizes, offsets, total) for packing arrays of `shapes` into one
    flat buffer."""
    sizes = [int(np.prod(shp, dtype=np.int64)) if shp else 1
             for shp in shapes]
    offs, total = [], 0
    for sz in sizes:
        offs.append(total)
        total += sz
    return sizes, offs, total


def split_flat(flat, shapes):
    """Inverse of a ravel-and-concatenate pack over arrays of `shapes`
    (views of `flat`)."""
    sizes, offs, _ = flat_layout(shapes)
    return [flat.narrow(0, off, sz).reshape(tuple(shp))
            for off, sz, shp in zip(offs, sizes, shapes)]


def supports(optimizer):
    """True when the optimizer's imperative semantics are its rule's
    (`_step` and its multi-tensor form `_multi_step`), so the fused
    update reproduces the per-parameter path. Subclasses overriding
    `update`, `update_multi_precision`, `create_state_multi_precision`
    or `_preprocess`, or without a `_multi_step`, take the per-parameter
    path."""
    t = type(optimizer)
    return (t.update is Optimizer.update
            and t.update_multi_precision is Optimizer.update_multi_precision
            and t.create_state_multi_precision
            is Optimizer.create_state_multi_precision
            and t._preprocess is Optimizer._preprocess
            and t._multi_step is not Optimizer._multi_step)


# lr / wd / rescale_grad reach the update as scalars and the counts change
# every step; every other scalar of the optimizer (momentum, betas,
# epsilon, clip_gradient, multi_precision) is fixed in the launches and
# keys the cache
_NON_HYPER = frozenset({"lr", "wd", "rescale_grad", "num_update"})


def _hyper_sig(optimizer):
    """The scalar hyperparameters the update fixes, so a change mid-run
    (opt.momentum = 0.0) makes a new cache entry instead of reusing
    stale launches."""
    return tuple(sorted(
        (k, v) for k, v in vars(optimizer).items()
        if k not in _NON_HYPER
        and isinstance(v, (int, float, bool, str, type(None)))))


def _grad_nbytes(p):
    g = p.grad()._data
    return g.numel() * g.element_size()


def build_buckets(pairs, cap_bytes):
    """Group an ordered list of (index, Parameter) into dtype-homogeneous
    buckets of at most `cap_bytes` gradient bytes (cap <= 0: one
    parameter a bucket). A parameter larger than the cap gets a bucket of
    its own. Declaration order within and across buckets."""
    buckets, cur, cur_key, cur_bytes = [], [], None, 0
    for i, p in pairs:
        key = (p.data()._data.dtype, p.grad()._data.dtype)
        nbytes = _grad_nbytes(p)
        if cur and (key != cur_key or cap_bytes <= 0
                    or cur_bytes + nbytes > cap_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur_key = key
        cur.append((i, p))
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _is_master(optimizer, w):
    return bool(optimizer.multi_precision and w.dtype != torch.float32)


def bucket_signature(bucket, optimizer):
    """Static cache key of one bucket: each parameter's shape, dtypes and
    multi-precision role."""
    sig = []
    for _, p in bucket:
        w, g = p.data()._data, p.grad()._data
        sig.append((tuple(w.shape), str(w.dtype), str(g.dtype),
                    _is_master(optimizer, w)))
    return tuple(sig)


def state_signature(states):
    """Shapes and dtypes of each parameter's state tensors (a loaded
    state may differ without the bucket changing)."""
    return tuple(tuple((tuple(s._data.shape), str(s._data.dtype))
                       for s in st) for st in states)


def _mults(optimizer, index):
    """What fixes a parameter's lr and wd against the optimizer's base
    values: its multipliers, and whether its wd is 0."""
    lr_mult = optimizer.lr_mult.get(index, optimizer.lr_mult.get(
        optimizer.idx2name.get(index, index), 1.0))
    wd_mult = optimizer.wd_mult.get(index, optimizer.wd_mult.get(
        optimizer.idx2name.get(index, index), 1.0))
    p = optimizer.param_dict.get(index)
    if p is not None:
        lr_mult *= getattr(p, "lr_mult", 1.0)
        wd_mult *= getattr(p, "wd_mult", 1.0)
    return (lr_mult, wd_mult, optimizer._get_wd(index) == 0)


def hyper_groups(optimizer, indices):
    """Positions of `indices` grouped by equal lr and wd (their
    multipliers), in first-seen order: [(positions, wd_is_zero)]. One
    scalar pair serves each group."""
    groups = {}
    for k, idx in enumerate(indices):
        groups.setdefault(_mults(optimizer, idx), []).append(k)
    return [(tuple(pos), key[2]) for key, pos in groups.items()]


class DeviceScalars:
    """The step's scalars (rescale, the inverse loss scale, lr and wd of
    each group, ...) as one fp32 vector on the device. The host fills it
    before the update (`fill`: on a card a pinned, non-blocking copy, in
    stream order after the work already queued); the update reads 0-d
    views of it, cast once per dtype (`get`). `begin` drops the casts, so
    each step (and each replay of a captured graph) makes its own."""

    def __init__(self, n, device):
        self.buf = torch.zeros(n, dtype=torch.float32, device=device)
        self._cast = {}

    def fill(self, values):
        host = torch.tensor(values, dtype=torch.float32)
        if self.buf.is_cuda:
            host = host.pin_memory()
        self.buf.copy_(host, non_blocking=self.buf.is_cuda)

    def begin(self):
        self._cast = {}

    def get(self, slot, dtype):
        c = self._cast.get(dtype)
        if c is None:
            c = self._cast[dtype] = self.buf if dtype == torch.float32 \
                else self.buf.to(dtype)
        return c[slot]


def _make_kernel(optimizer, mp, clip, unscale, groups):
    """The fused update of one bucket: a function of (weights, grads,
    states, scalars, slots) that runs the bucket's launches, with
    `slots` = (rescale slot, inverse-loss-scale slot, [(lr slot, wd
    slot)] a group). Staged as `Optimizer.update` /
    `update_multi_precision` are: the folded AMP unscale (gradients in
    place), the fp32 upcast for masters, rescale, clip, the rule, the
    master rounded into the weight."""

    def kernel(ws, gs, svs, scal, slots):
        rescale_slot, inv_slot, hyper = slots
        gdt = gs[0].dtype
        if unscale:
            torch._foreach_mul_(gs, scal.get(inv_slot, gdt))
        for (pos, wd_zero), (lr_slot, wd_slot) in zip(groups, hyper):
            wsub = [ws[k] for k in pos]
            svsub = [svs[k] for k in pos]
            rdt = torch.float32 if mp else wsub[0].dtype
            gsub = [gs[k] for k in pos]
            if gsub[0].dtype == rdt:
                work = torch._foreach_mul(gsub, scal.get(rescale_slot, rdt))
            else:
                work = [g.to(rdt) for g in gsub]
                torch._foreach_mul_(work, scal.get(rescale_slot, rdt))
            if clip is not None:
                torch._foreach_clamp_min_(work, -clip)
                torch._foreach_clamp_max_(work, clip)
            lr = scal.get(lr_slot, rdt)
            wd = 0.0 if wd_zero else scal.get(wd_slot, rdt)
            if mp:
                masters = [sv[0] for sv in svsub]
                optimizer._multi_step(masters, work,
                                      [sv[1:] for sv in svsub], lr, wd)
                torch._foreach_copy_(wsub, masters)
            else:
                optimizer._multi_step(wsub, work, svsub, lr, wd)
    return kernel


def apply_param_update(optimizer, w, g, sv, lr, wd, mp, clip, rescale,
                       inv_scale=None):
    """ONE parameter's fused update, staged as the bucket kernel stages
    it (unscale in place, fp32 upcast for a master, rescale, clip, the
    rule, the master rounded into the weight); `lr`, `wd`, `rescale` and
    `inv_scale` are floats or 0-d tensors. Writes `w`, `g` (when
    unscaled) and the state tensors `sv` in place and returns (w, sv,
    g or None)."""
    vals = [rescale, 1.0 if inv_scale is None else inv_scale, lr, wd]
    scal = _Given(vals)
    kern = _make_kernel(optimizer, mp, clip, inv_scale is not None,
                        [((0,), isinstance(wd, float) and wd == 0)])
    with torch.no_grad():
        kern([w], [g], [tuple(sv)], scal, (0, 1, [(2, 3)]))
    return w, tuple(sv), (g if inv_scale is not None else None)


class _Given:
    """Scalars given by the caller, floats or tensors (`apply_param_update`)."""

    def __init__(self, values):
        self.values = values

    def get(self, slot, dtype):
        v = self.values[slot]
        return v.to(dtype) if isinstance(v, torch.Tensor) else v


def sparse_update_rows(*args, **kwargs):
    """The scatter-add arm of the update for row-sharded embeddings."""
    raise MXNetError("sparse_update_rows is not ported yet (ROADMAP.md, "
                     "Queue 1 [5d]: rule-driven sharding, embeddings)")


def classify_state_rows(*args, **kwargs):
    """How each row-shaped state leaf of a tiered table initialises."""
    raise MXNetError("classify_state_rows is not ported yet (ROADMAP.md, "
                     "Queue 1 [5d]: rule-driven sharding, embeddings)")


class BucketUpdate:
    """One bucket's fused update as a cache entry: its lr / wd groups
    and its kernel (no tensors: the caller hands them over, so a
    gradient or state rebound between steps is what the next update
    sees). `scalar_values` gives the group scalars the host writes."""

    def __init__(self, optimizer, bucket, unscale):
        opt = optimizer
        self.indices = [i for i, _ in bucket]
        self.mp = _is_master(opt, bucket[0][1].data()._data)
        self.groups = hyper_groups(opt, self.indices)
        clip = None if opt.clip_gradient is None \
            else float(opt.clip_gradient)
        self.kernel = _make_kernel(opt, self.mp, clip, unscale, self.groups)

    @staticmethod
    def key(optimizer, bucket, states, unscale):
        opt = optimizer
        return (bucket_signature(bucket, opt), state_signature(states),
                _hyper_sig(opt), unscale,
                tuple(hyper_groups(opt, [i for i, _ in bucket])))

    def n_scalars(self):
        return 2 * len(self.groups)

    def scalar_values(self, optimizer):
        out = []
        for pos, _ in self.groups:
            idx = self.indices[pos[0]]
            out += [float(optimizer._get_lr(idx)),
                    float(optimizer._get_wd(idx))]
        return out

    def run(self, tensors, scal, rescale_slot, inv_slot, base):
        """Launch the update on `tensors` = (weights, grads, state
        tuples), the group scalars from slot `base` on."""
        hyper = [(base + 2 * k, base + 2 * k + 1)
                 for k in range(len(self.groups))]
        self.kernel(*tensors, scal, (rescale_slot, inv_slot, hyper))


def bucket_tensors(bucket, states):
    """(weights, grads, state tuples) of a bucket, as tensors."""
    return ([p.data()._data for _, p in bucket],
            [p.grad()._data for _, p in bucket],
            [tuple(s._data for s in st) for st in states])


class FusedUpdater(Updater):
    """Updater that applies a whole bucket of parameters in one fused
    dispatch. Shares the per-index `states` dict with the plain Updater,
    so `Trainer.save_states` / `load_states` and the per-parameter
    `__call__` keep working."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._kernels = {}

    def bucket_states(self, bucket):
        """Each parameter's state tuple, made on first use."""
        opt = self.optimizer
        out = []
        for idx, p in bucket:
            if idx not in self.states:
                self.states[idx] = \
                    opt.create_state_multi_precision(idx, p.data())
            out.append(self.states[idx])
        return out

    def entry(self, bucket, states, unscale):
        """The cached `BucketUpdate` of `bucket` (a miss builds it)."""
        key = BucketUpdate.key(self.optimizer, bucket, states, unscale)
        ent = self._kernels.get(key)
        profiler.record_jit_cache(ent is not None)
        if ent is None:
            ent = self._kernels[key] = BucketUpdate(self.optimizer, bucket,
                                                    unscale)
        return ent

    def update_bucket(self, bucket, inv_scale=None):
        """One optimizer step for every (index, Parameter) of `bucket` in
        one fused dispatch. With `inv_scale` (AMP's 1/loss_scale) the
        unscale is folded in and each gradient is left unscaled."""
        opt = self.optimizer
        states = self.bucket_states(bucket)
        ent = self.entry(bucket, states, inv_scale is not None)
        for idx in ent.indices:
            opt._update_count(idx)
        profiler.record_dispatch("fused_update")
        tensors = bucket_tensors(bucket, states)
        scal = DeviceScalars(2 + ent.n_scalars(), tensors[0][0].device)
        scal.fill([float(opt.rescale_grad),
                   1.0 if inv_scale is None else float(inv_scale)]
                  + ent.scalar_values(opt))
        with torch.no_grad():
            ent.run(tensors, scal, 0, 1, 2)
