"""Collectives over a process group: what `lax` gives the JAX package
inside `shard_map`.

The differentiable ones (`ppermute`, tiled `all_to_all`, and the pair of
conversions between a global tensor and this rank's slice that
`shard_map`'s in / out specs make) serve sequence parallelism; Megatron's
conjugate pair `f_identity_bwd_psum` / `g_psum_bwd_identity` serves
tensor, expert and pipeline parallelism (`composite.py`), and `psum` sums
a value in the forward only (the composite's loss). The plain
ones (`all_reduce`, `reduce_scatter`, `all_gather`: `lax.psum`,
`lax.psum_scatter(tiled=True)` and `lax.all_gather(tiled=True)` along
dim 0) serve the store and data parallelism; they write no autograd
graph.

Every function is the identity on a group of one, and then runs no
collective at all. Gradients equal `shard_map`'s global ones when every
rank holds the same global input and the same loss: `_shard` all-gathers
its cotangent and `_gather` slices it, so nothing is summed over ranks
(`torch.distributed.nn.functional.all_gather` would sum them, and with
the same loss on every rank that multiplies gradients by the group
size).

A bare all-reduce under autograd is wrong in either direction for the
model-parallel axes: `torch.distributed.nn.functional.all_reduce` sums
again in its backward, which scales a cotangent that every rank already
holds whole by the group size. f and g pin the algebra instead: f marks
the entry into a branch whose ranks each hold a part of the weights
(identity forward, the partial cotangents summed in the backward), g its
exit (the partial outputs summed forward, the whole cotangent passed
through backward).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["ppermute_start", "ppermute", "keep_in_graph", "all_to_all",
           "shard", "gather", "f_identity_bwd_psum", "g_psum_bwd_identity",
           "psum", "check_devices", "all_reduce",
           "reduce_scatter", "all_gather", "sharded_leaf", "leaf_shard",
           "gather_leaf", "clone_leaf"]


def check_devices(mesh, *tensors):
    """Raise unless every tensor lies on the mesh's device type (NCCL
    takes CUDA tensors, gloo CPU ones)."""
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise MXNetError(f"a {t.device.type} tensor on a "
                             f"{mesh.device_type} mesh")


def _send_recv(xs, group, shift):
    """Post the sends of `xs` to rank + shift and the receives from rank -
    shift (ranks within `group`); returns (received, works)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    outs = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, y, src, group) for y in outs]
    return outs, dist.batch_isend_irecv(ops)


def _wait(works):
    for w in works:
        w.wait()


class _Pending:
    """The receives of a started `ppermute_start`: `wait()` before the
    received tensors are read."""

    def __init__(self):
        self.works = []

    def wait(self):
        _wait(self.works)
        self.works = []


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, pending, *xs):
        ctx.group, ctx.shift = group, shift
        outs, pending.works = _send_recv(
            [x.contiguous() for x in xs], group, shift)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        outs, works = _send_recv([g.contiguous() for g in gs], ctx.group,
                                 -ctx.shift)
        _wait(works)
        return (None, None, None, *outs)


def ppermute_start(xs, group, shift):
    """Start sending each tensor of `xs` to rank + shift of `group` and
    receiving its counterpart from rank - shift: returns (received,
    pending). The received tensors hold their data only after
    `pending.wait()`; the caller computes in between (`ring_attention`
    overlaps the next K/V block's transfer with the current block).
    Differentiable: the backward sends the cotangents the other way (and
    waits for them)."""
    pending = _Pending()
    if dist.get_world_size(group) == 1 or shift % dist.get_world_size(
            group) == 0:
        return list(xs), pending
    return list(_PPermute.apply(group, shift, pending, *xs)), pending


def ppermute(x, group, shift):
    """`x` of rank - shift, received here: `lax.ppermute` with the
    permutation i -> i + shift."""
    (y,), pending = ppermute_start([x], group, shift)
    pending.wait()
    return y


class _KeepInGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.n_deps = len(deps)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *[None] * ctx.n_deps)


def keep_in_graph(x, *deps):
    """`x`, with `deps` made part of its backward graph at a zero
    cotangent. A collective's backward is itself a collective that every
    rank must join, but autograd runs a node only where a gradient
    reaches it: a causal ring rank that skips the blocks it receives
    would leave its peers waiting in the rotation's backward. Tying the
    last blocks received to the output pulls the whole rotation chain
    into every rank's backward."""
    return _KeepInGraph.apply(x, *deps)


def _all_to_all(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise MXNetError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over "
                         f"{n} ranks")
    # chunk i of the split axis goes to rank i: move that axis to the
    # front, where all_to_all_single splits
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv holds the chunks of ranks 0..n-1 in order; put each back in
    # its own layout and concatenate them along concat_axis in rank order
    pieces = recv.reshape(n, send.shape[0] // n, *send.shape[1:])
    pieces = pieces.movedim(1, split_axis + 1)       # (n, *chunk shape)
    out = pieces.movedim(0, concat_axis)              # n beside the axis
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, \
            None


def all_to_all(x, group, split_axis, concat_axis):
    """`lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`:
    split `split_axis` into one chunk a rank, send chunk i to rank i, and
    concatenate the chunks received along `concat_axis` in rank order.
    Differentiable: the backward is the inverse all-to-all."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis % x.dim(),
                           concat_axis % x.dim())


def _slice(x, group, dim):
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise MXNetError(f"axis {dim} of size {x.shape[dim]} does not shard "
                         f"over {n} ranks")
    return x.chunk(n, dim)[me].contiguous()


def _all_gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None


def shard(x, group, dim):
    """This rank's slice of the global `x` along `dim` (a `shard_map` in
    spec); the backward all-gathers the cotangent."""
    if dist.get_world_size(group) == 1:
        return x
    return _Shard.apply(x, group, dim)


def gather(x, group, dim):
    """The global tensor from every rank's slice along `dim` (a
    `shard_map` out spec); the backward takes this rank's slice of the
    cotangent."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


def _summed(x, group):
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _FIdentityBwdPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _GPsumBwdIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def f_identity_bwd_psum(x, group):
    """Megatron's f: `x` itself; the backward sums the cotangent over
    `group`, so that a tensor every rank holds whole gets back the whole
    cotangent from a branch whose ranks each compute a part of it."""
    if dist.get_world_size(group) == 1:
        return x
    return _FIdentityBwdPsum.apply(x, group)


def g_psum_bwd_identity(x, group):
    """Megatron's g: `x` summed over `group` (each rank's partial
    output); the backward passes the cotangent through, since every rank
    already holds it whole."""
    if dist.get_world_size(group) == 1:
        return x
    return _GPsumBwdIdentity.apply(x, group)


def psum(x, group):
    """`lax.psum(x, axis)` in the forward only: a detached copy of `x`
    summed over `group` (the composite's loss); `x` itself, detached, on
    a group of one."""
    if dist.get_world_size(group) == 1:
        return x.detach()
    return _summed(x, group)


# ---------------------------------------------------------------------------
# plain collectives (no autograd): the store's and data parallelism's
# ---------------------------------------------------------------------------
def _nccl(group):
    return dist.get_backend(group) == "nccl"


def all_reduce(x, group, op="sum"):
    """`x` summed (or maxed, op="max") over the ranks of `group`, in
    place; returns `x`. Legal inside CUDA-graph capture on NCCL once the
    group's communicator exists. Like the two below, it runs the
    collective on a group of one rank too (the caller skips what it need
    not run)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return x


def reduce_scatter(x, group, out=None):
    """This rank's block of rows of `x` summed over `group`:
    `lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)`. Dim 0
    must split evenly. On NCCL it is `reduce_scatter_tensor` into `out`
    (allocated when None). gloo's reduce-scatter is missing from some
    torch builds, so on the CPU it is composed: an all-reduce of a copy,
    then this rank's rows."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[0] % n:
        raise MXNetError(f"reduce_scatter: dim 0 of size {x.shape[0]} "
                         f"does not split over {n} ranks")
    rows = x.shape[0] // n
    if out is None:
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
    if _nccl(group):
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    full = x.detach().clone()
    dist.all_reduce(full, group=group)
    return out.copy_(full.narrow(0, me * rows, rows))


def all_gather(x, group, out=None):
    """Every rank's `x` stacked along dim 0 in rank order:
    `lax.all_gather(x, axis, axis=0, tiled=True)`. On NCCL it is
    `all_gather_into_tensor` into `out` (allocated when None; `x` may be
    this rank's block of `out`, an in-place gather). On the CPU it is
    composed from gloo's list all-gather and a concatenation, for the
    same reason as `reduce_scatter`."""
    n = dist.get_world_size(group)
    shape = (x.shape[0] * n,) + tuple(x.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if _nccl(group):
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return out.copy_(torch.cat(parts, 0))


# ---------------------------------------------------------------------------
# ZeRO leaves: a rank's block of an optimizer-state tensor
# ---------------------------------------------------------------------------
def sharded_leaf(t, group, dim=0):
    """Mark `t` as this rank's block, along `dim`, of a tensor split in
    equal blocks over the ranks of `group` (a ZeRO optimizer-state leaf,
    the JAX package's array sharded over `dp`); returns `t`."""
    t._mx_zero = (group, dim)
    return t


def leaf_shard(t):
    """(group, dim) of a `sharded_leaf`, or None for a whole tensor."""
    return getattr(t, "_mx_zero", None)


def gather_leaf(t):
    """The whole tensor of a `sharded_leaf` (a collective: every rank of
    its group calls it), or `t` itself when it is whole."""
    mark = leaf_shard(t)
    if mark is None:
        return t
    group, dim = mark
    full = all_gather(t.movedim(dim, 0).contiguous(), group)
    return full.movedim(0, dim)


def clone_leaf(t):
    """A copy of `t` that keeps its `sharded_leaf` mark."""
    c = t.clone()
    mark = leaf_shard(t)
    return c if mark is None else sharded_leaf(c, *mark)
