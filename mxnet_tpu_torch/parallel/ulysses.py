"""All-to-all (Ulysses) sequence parallelism over the mesh axis 'sp'
(counterpart of `mxnet_tpu/parallel/ulysses.py`).

One stacked all-to-all turns sequence-sharded q/k/v (B, S/P, H, Dh)
into head-sharded full-sequence blocks (B, S, H/P, Dh); each rank runs
full attention over its heads (`ops.kernels.flash_block_attention`, the
flash kernels), and one reverse all-to-all restores the sequence
sharding. Four activation-sized tensors cross the group a forward,
whatever P; the attention needs no cross-rank math. On a group of one
both all-to-alls are the identity and run no collective.
"""
from __future__ import annotations

import torch

from ..ops.kernels import flash_block_attention
from . import _comm

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, axis_name="sp", causal=False, sm_scale=None,
                      *, mesh):
    """This rank's shard of attention, with q, k, v (B, S/P, H, Dh)
    sequence-sharded over `mesh`'s axis `axis_name`. H must be divisible
    by the axis size P. Returns (B, S/P, H, Dh). Every rank of the axis
    calls it."""
    _comm.check_devices(mesh, q, k, v)
    p = mesh.shape[axis_name]
    h = q.shape[2]
    if h % p:
        raise ValueError(f"ulysses_attention: heads {h} not divisible by "
                         f"axis {axis_name!r} size {p}")
    group = mesh.group(axis_name)
    # one collective for q/k/v: (3, B, S/P, H, Dh) -> split the heads
    # (axis 3) over the ranks, gather the sequence (axis 2)
    qkv = _comm.all_to_all(torch.stack([q, k, v]), group, split_axis=3,
                           concat_axis=2)
    # the flash kernels take (B, H/P, S, Dh)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in qkv.unbind(0))
    out, _lse = flash_block_attention(qt, kt, vt, causal, sm_scale)
    # (B, S, H/P, Dh) -> split the sequence back, gather the heads
    return _comm.all_to_all(out.transpose(1, 2), group, split_axis=1,
                            concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False):
    """All-to-all attention over global (B, S, H, Dh) tensors that every
    rank holds alike: each rank takes its sequence shard, runs
    `ulysses_attention` and gathers the global output (B, S, H, Dh);
    gradients reach the global inputs as `shard_map`'s do. `mesh` None
    is `make_mesh({axis_name: -1})`."""
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh({axis_name: -1})
    group = mesh.group(axis_name)
    ql, kl, vl = (_comm.shard(t, group, 1) for t in (q, k, v))
    out = ulysses_attention(ql, kl, vl, axis_name, causal, mesh=mesh)
    return _comm.gather(out, group, 1)
