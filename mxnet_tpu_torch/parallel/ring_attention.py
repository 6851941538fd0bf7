"""Ring attention: sequence parallelism over the mesh axis 'sp'
(counterpart of `mxnet_tpu/parallel/ring_attention.py`).

Each rank holds a sequence shard of Q/K/V; the K/V blocks rotate around
the ring (`_comm.ppermute_start`, NCCL peer-to-peer on the cards) while
the local queries accumulate the partial of each block, so attention
over S costs O(S/P) memory a rank. The block is
`ops.kernels.flash_block_attention` (the flash kernels, returning out
and lse) and partials merge exactly through lse in fp32; the backward
runs the flash backward kernels with the lse cotangent folded into
delta. The next block's transfer is posted before the current block is
computed, so the two overlap.

Causal masking decomposes by global shard: the rank's own block is the
causal diagonal, earlier shards are wholly visible, later ones are
skipped on the host with no launch (the JAX package computes a zero
block through `lax.switch` there).

On a group of one the ring has one step and no rotation: the port
skips it and sends nothing through NCCL.
"""
from __future__ import annotations

import math

import torch

from ..ops.kernels import flash_block_attention
from . import _comm

__all__ = ["ring_attention", "ring_attention_sharded"]

_MASKED = -1e30


def _ring_step(q, k_blk, v_blk, o, lse, src, me, causal, sm_scale):
    """One ring step of rank `me` over the K/V block of shard `src`:
    (o, lse) merged with that block's partial in fp32. With `causal`,
    shard `me` is the diagonal block, an earlier one is wholly visible,
    and a later one is skipped (no launch; (o, lse) come back as they
    were)."""
    if causal and src > me:
        return o, lse
    o_b, lse_b = flash_block_attention(q, k_blk, v_blk,
                                       causal and src == me, sm_scale)
    lse_new = torch.logaddexp(lse, lse_b)
    o_new = (o * torch.exp(lse - lse_new)[..., None]
             + o_b.float() * torch.exp(lse_b - lse_new)[..., None])
    return o_new, lse_new


def ring_attention(q, k, v, axis_name="sp", causal=False, sm_scale=None, *,
                   mesh):
    """This rank's shard of attention, with q, k, v sequence-sharded over
    `mesh`'s axis `axis_name`: (B, H, S/P, D) each, shard r holding
    positions [r S/P, (r + 1) S/P). Returns (B, H, S/P, D) in q's dtype.
    Every rank of the axis calls it (the `shard_map` body of the JAX
    package, whose axis binding `mesh` stands in for)."""
    _comm.check_devices(mesh, q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.group(axis_name)
    n, me = mesh.shape[axis_name], mesh.axis_index(axis_name)
    b, h, s_loc, d = q.shape
    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _MASKED, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        if i + 1 < n:
            # the last step's rotation would only bring the blocks home
            (k_next, v_next), pending = _comm.ppermute_start(
                [k_cur, v_cur], group, 1)
        o, lse = _ring_step(q, k_cur, v_cur, o, lse, (me - i) % n, me,
                            causal, sm_scale)
        if i + 1 < n:
            pending.wait()
            k_cur, v_cur = k_next, v_next
    if n > 1:
        o = _comm.keep_in_graph(o, k_cur, v_cur)
    return o.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False):
    """Ring attention over global (B, H, S, D) tensors that every rank
    holds alike: each rank takes its sequence shard, runs the ring and
    gathers the global output (B, H, S, D); gradients reach the global
    inputs as `shard_map`'s do. `mesh` None is `make_mesh({axis_name:
    -1})`, every rank of the default group on one axis."""
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh({axis_name: -1})
    group = mesh.group(axis_name)
    ql, kl, vl = (_comm.shard(t, group, 2) for t in (q, k, v))
    out = ring_attention(ql, kl, vl, axis_name, causal, mesh=mesh)
    return _comm.gather(out, group, 2)
