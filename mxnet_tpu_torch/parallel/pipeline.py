"""Pipeline parallelism over the mesh axis 'pp', GPipe's schedule
(counterpart of `mxnet_tpu/parallel/pipeline.py`).

Each rank of the axis is one stage: it holds that stage's weights, and
the microbatches stream round the stages with `_comm.ppermute`, one
rotation a tick, over n_micro + n_stages - 1 ticks. Stage s works on
microbatch t - s at tick t; the first stage reads the input, the last
writes the output. The backward is autograd's transpose of the ticks:
each rotation's backward sends the cotangents the other way.

The JAX package runs every stage at every tick and masks the idle ones
(one XLA program); the port skips an idle tick's compute, which every
rank of a stage does alike, so the collectives inside a stage (tp, sp,
ep) keep one order on its ranks. Every tick's rotation runs on every
rank, as in the JAX schedule: a rotation is a pair of sends and receives
that its peers join, forward and backward. So on every tick each rank
sends something that carries a gradient when gradients are taken (an
idle tick sends zeros tied to the stage's weights), and every received
block is tied to the output (`_comm.keep_in_graph`): autograd then runs
every rotation's backward on every rank, and runs them in reverse tick
order (later nodes first), the same on every rank.
"""
from __future__ import annotations

import torch

from . import _comm

__all__ = ["pipeline_apply", "stack_stage_params"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_stage_params(stage_params_list):
    """Stack per-stage param pytrees along a new leading 'stage' axis so the
    whole pipeline's weights shard with P('pp') on axis 0."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *stage_params_list)


def gpipe_ticks(stage_fn, xm, group, n_stages, stage, anchor=None):
    """GPipe's ticks on this rank, stage `stage` of `n_stages` on `group`:
    `xm` (n_micro, mb, ...) the microbatches (read by stage 0 only),
    `stage_fn(x) -> y` of x's shape. Returns the outputs (n_micro, mb,
    ...) on the last stage and zeros elsewhere. `anchor`: a tensor that
    requires grad (this stage's weights) when gradients are taken, else
    None; idle ticks send zeros tied to it."""
    n_micro = xm.shape[0]
    outs, received = [], []
    buf = torch.zeros_like(xm[0])
    for t in range(n_micro + n_stages - 1):
        if 0 <= t - stage < n_micro:
            y = stage_fn(xm[min(t, n_micro - 1)] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs.append(y)
        else:
            y = torch.zeros_like(xm[0])
            if anchor is not None:
                y = _comm.keep_in_graph(y, anchor)
        buf = _comm.ppermute(y, group, 1)
        received.append(buf)
    out = torch.stack(outs) if outs else torch.zeros_like(xm)
    if anchor is not None and n_stages > 1:
        out = _comm.keep_in_graph(out, *received)
    return out


def pipeline_apply(stage_fn, stacked_params, x_micro, mesh, pp_axis="pp"):
    """Run a GPipe pipeline; every rank of `pp_axis` calls it.

    stage_fn(params, x) -> y : one stage's computation (same shape in/out).
    stacked_params: pytree with a leading stage axis, the global tensors
    that every rank holds alike (this rank takes its stage's slice).
    x_micro: (n_micro, mb, ...) microbatched input (replicated).
    Returns (n_micro, mb, ...) outputs (replicated). Gradients reach the
    global leaves as `shard_map`'s do: each rank gets the whole stacked
    gradient (`_comm.shard` on the stage axis) and the whole gradient of
    x_micro (f over the stage axis).
    """
    group = mesh.group(pp_axis)
    n_stages = int(mesh.shape[pp_axis])
    stage = mesh.axis_index(pp_axis)
    _comm.check_devices(mesh, x_micro, *_leaves(stacked_params))
    # two collectives reach the inputs in the backward: the weights'
    # all-gather (one, over all of them flattened: _comm.shard) and x's
    # sum (f). Every rank runs them in one order, the gather first: the
    # weights are tied to xm, so f's backward waits for theirs (and a
    # stage that never reads x still runs it)
    xm = _comm.f_identity_bwd_psum(x_micro, group)
    leaves = _leaves(stacked_params)
    flat = torch.cat([p.reshape(n_stages, -1) for p in leaves], 1)
    mine = _comm.shard(_comm.keep_in_graph(flat, xm), group, 0)[0]
    sizes = [p[0].numel() for p in leaves]
    it = iter([piece.view(p.shape[1:]) for piece, p in
               zip(mine.split(sizes), leaves)])
    params = _tree_map(lambda p: next(it), stacked_params)
    anchor = None
    if torch.is_grad_enabled():
        anchor = next((t for t in [*_leaves(params), xm]
                       if t.requires_grad), None)
    outs = gpipe_ticks(lambda x: stage_fn(params, x), xm, group, n_stages,
                       stage, anchor)
    # the real outputs live on the last stage: every rank gets them
    return _comm.g_psum_bwd_identity(outs, group)
