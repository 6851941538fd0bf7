"""Data-parallel training as one step function (counterpart of
`mxnet_tpu/parallel/data_parallel.py`).

The JAX package jit-compiles one global-view program: parameters
replicated over the mesh, the batch sharded over `dp`, XLA inserting the
gradient psum. Here every rank of the mesh runs the step on its own
block of rows (`mesh.Sharding`: what `shard_batch` and the prefetcher
hand out; a global batch that every rank holds is cut to this rank's
rows when the call says `global_batch=True`, since a tensor does not
say which it holds) and the collectives are explicit: the loss and each gradient
all-reduced and divided by the `dp` size, so the gradient is that of the
global batch's mean loss, and BatchNorm's batch statistics synchronised
over the same group (`ops.nn_ops.sync_batch_norm`), since the JAX
program normalises with the global batch's statistics. Without a mesh
the step is the one-device program.

`donate=True` updates the state's tensors in place (the JAX buffers
donated to the program); `donate=False` leaves the state handed in
untouched. `remat=True` recomputes the forward in the backward
(`torch.utils.checkpoint`, the counterpart of `jax.checkpoint`).
`zero=True` shards each optimizer-state leaf over `dp` on its first
dimension that the `dp` size divides (ZeRO-1, arXiv:2004.13336): each
rank keeps its block of those rows and updates its block of the weight,
then the weights are all-gathered; a leaf without such a dimension
stays whole on every rank. The sharded leaves carry the mark
`_comm.sharded_leaf(t)` (the state's own tensors, updated in place), so
that a checkpoint gathers them (`checkpoint.py`).

JAX's "one jitted program" is one step of eager launches here; capturing
it as a CUDA graph is what `Trainer.capture` does for the Gluon path.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ops import nn_ops
from . import _comm
from .functional import collect_params_ordered, functional_call, \
    param_values
from .mesh import Sharding

__all__ = ["DataParallelTrainer", "make_train_step", "sharded_leaf"]

sharded_leaf = _comm.sharded_leaf


def _zero_dim(shape, n):
    """The first dimension of `shape` that `n` divides (and is at least
    `n`), or None: where a ZeRO leaf shards (`:101-107` there)."""
    for d, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return d
    return None


def _tensor(x, dev):
    if isinstance(x, NDArray):
        x = x._data
    return torch.as_tensor(x).to(dev) if not isinstance(x, torch.Tensor) \
        else x.to(dev)


def make_train_step(block, loss_block, optimizer, mesh=None, dp_axis="dp",
                    donate=True, compute_dtype=None, remat=False,
                    zero=False, device=None):
    """(step_fn, init_state). `step_fn(state, x, y, lr, rng=None,
    global_batch=False)` -> (state, loss), where `state` = (params
    {name: tensor}, optimizer state {name: tuple}, num_update) and the
    loss is the global batch's mean. With a mesh, x and y are this rank's
    rows (with `global_batch=True`, the global batch, which each rank
    cuts) and the parameters are the same on every rank.
    `device` (no mesh): None = `mx.gpu(0)`, which raises without a card,
    or "cpu". `rng`, an int, seeds the port's generator for the step's
    dropout. The update is `optimizer._step` (the rule of `Optimizer.
    apply` in the JAX package) at `lr` and the optimizer's `wd`."""
    if zero and mesh is None:
        raise ValueError("zero=True (sharded optimizer state) requires a "
                         "mesh")
    names = [n for n, _ in collect_params_ordered(block)]
    trainable = [n for n, p in collect_params_ordered(block)
                 if p.grad_req != "null"]
    if mesh is not None:
        group, nrep = mesh.group(dp_axis), int(mesh.shape[dp_axis])
        dev = mesh.device
        rows = Sharding(mesh, (dp_axis,))
        me = mesh.axis_index(dp_axis)
    else:
        group, nrep, rows, me = None, 1, None, 0
        dev = resolve_device(device)
    sync = group if nrep > 1 else None
    zdims = {}

    def init_state():
        params = {n: v.to(dev).clone()
                  for n, v in param_values(block).items()}
        opt_state = {}
        for n in trainable:
            st = tuple(optimizer.init_state(params[n]))
            d = _zero_dim(params[n].shape, nrep) if zero else None
            zdims[n] = d
            if d is not None:
                k = params[n].shape[d] // nrep
                st = tuple(
                    s if s.shape != params[n].shape else
                    sharded_leaf(s.narrow(d, me * k, k).clone(), group, d)
                    for s in st)
            opt_state[n] = st
        return (params, opt_state,
                torch.zeros((), dtype=torch.int32, device=dev))

    def forward_loss(leaves, x, y):
        out, aux = functional_call(block, leaves, [x], training=True)
        out = out[0] if isinstance(out, tuple) else out
        if compute_dtype is not None:
            out = out.float()
        loss, _ = functional_call(loss_block, {}, [out, y], training=True)
        loss = loss[0] if isinstance(loss, tuple) else loss
        return loss.mean(), aux

    def step(state, x, y, lr, rng=None, global_batch=False):
        params, opt_state, num_update = state
        if not donate:
            params = {n: v.clone() for n, v in params.items()}
            opt_state = {n: tuple(_comm.clone_leaf(s) for s in sv)
                         for n, sv in opt_state.items()}
            num_update = num_update.clone()
        x, y = _tensor(x, dev), _tensor(y, dev)
        if rows is not None and global_batch:
            x, y = rows.local_rows(x), rows.local_rows(y)
        if rng is not None:
            from .. import random as _random
            _random.seed(int(rng))
        leaves = {n: params[n].detach().requires_grad_(n in trainable)
                  for n in names}
        with nn_ops.sync_batch_norm(sync):
            if remat:
                from torch.utils.checkpoint import checkpoint
                held = {}

                def run(*vals):
                    loss, aux = forward_loss(dict(zip(names, vals)), x, y)
                    held["aux"] = aux
                    return loss
                loss = checkpoint(run, *[leaves[n] for n in names],
                                  use_reentrant=False)
                aux = held["aux"]
            else:
                loss, aux = forward_loss(leaves, x, y)
            # (a remat backward runs the forward again: in the same group)
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in trainable], allow_unused=True)
        with torch.no_grad():
            loss = loss.detach().clone()
            if nrep > 1:
                _comm.all_reduce(loss, group).div_(nrep)
            wd = optimizer.wd
            for n, g in zip(trainable, grads):
                w = params[n]
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                d = zdims.get(n)
                if d is not None:
                    k = w.shape[d] // nrep
                    if d == 0:
                        g = _comm.reduce_scatter(g, group)
                    else:
                        g = _comm.all_reduce(g, group).narrow(d, me * k, k)
                    g, wl = g / nrep, w.narrow(d, me * k, k)
                else:
                    if nrep > 1:
                        g = _comm.all_reduce(g, group).div_(nrep)
                    wl = w
                if optimizer.clip_gradient is not None:
                    g = g.clamp(-optimizer.clip_gradient,
                                optimizer.clip_gradient)
                optimizer._step(wl, g, opt_state[n], lr, wd)
                if d is not None:
                    full = _comm.all_gather(wl.movedim(d, 0).contiguous(),
                                            group)
                    w.copy_(full.movedim(0, d))
            for n, v in aux.items():
                if n in params:
                    params[n].copy_(v)
            num_update.add_(1)
        return (params, opt_state, num_update), loss

    return step, init_state


class DataParallelTrainer:
    """The data-parallel step with its state:

        trainer = DataParallelTrainer(net, loss, mx.optimizer.SGD(...), mesh)
        loss = trainer.step(x, y)           # one step a call
        trainer.sync_to_params()            # weights back into the block
    """

    def __init__(self, block, loss_block, optimizer, mesh=None, dp_axis="dp",
                 zero=False, device=None):
        self.block = block
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.optimizer = optimizer
        self._step_fn, init = make_train_step(block, loss_block, optimizer,
                                              mesh, dp_axis, zero=zero,
                                              device=device)
        self.state = init()
        self.num_update = 0

    def step(self, x, y, lr=None, global_batch=False):
        self.num_update += 1
        lr = lr if lr is not None else self.optimizer.learning_rate
        self.optimizer.num_update = self.num_update
        self.state, loss = self._step_fn(self.state, x, y, lr,
                                         global_batch=global_batch)
        return loss

    def sync_to_params(self):
        """Write the state's weights into the block's Parameters (in
        place: each keeps its tensor)."""
        params, _, _ = self.state
        with torch.no_grad():
            for name, p in collect_params_ordered(self.block):
                p._data._data.copy_(params[name])
