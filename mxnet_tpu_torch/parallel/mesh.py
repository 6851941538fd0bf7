"""Named device meshes over the default process group (counterpart of
`mxnet_tpu/parallel/mesh.py`).

A process drives one device, so a mesh's devices are the ranks of the
default group (`kvstore.init_distributed`): NCCL ranks on the cards, or
gloo ranks on the CPU. Axis names as in the JAX package: dp (data), tp
(tensor), pp (pipeline), sp (sequence), ep (expert). `replicated` and
`shard_batch` are not ported yet (ROADMAP.md, Queue 1 [5b]).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import kvstore

__all__ = ["Mesh", "make_mesh", "single_axis_mesh", "local_mesh_devices"]


class Mesh:
    """A `torch.distributed` `DeviceMesh` with the JAX Mesh's view of it:
    `shape` (axis name -> size, in the axes' order) and `axis_names`.
    `group(axis)` is the process group of this rank's line along `axis`,
    `axis_index(axis)` this rank's place on it, `device_type` "cuda"
    (NCCL) or "cpu" (gloo)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh

    @property
    def axis_names(self):
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def device_type(self):
        return self.device_mesh.device_type

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis):
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def local_mesh_devices():
    """The devices a mesh may hold: the ranks of the default group, one
    device each. With no group yet, `kvstore.init_distributed()` forms
    one first (a group of one on the card, unless the launcher's
    environment names a larger one)."""
    kvstore.init_distributed()
    return list(range(dist.get_world_size()))


def make_mesh(axes, devices=None):
    """A Mesh from {axis_name: size}, over the first prod(sizes) of
    `devices` (ranks; default `local_mesh_devices()`). Sizes must
    multiply to at most the device count; -1 infers one axis. Every rank
    of the default group calls it, as it creates the axes' groups. Like
    `jax.devices()`, it needs no prior `init_distributed`: on its own it
    forms a group of one on the card (see `local_mesh_devices`)."""
    devices = devices if devices is not None else local_mesh_devices()
    names = list(axes.keys())
    sizes = list(axes.values())
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = max(n // known, 1)
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor(list(devices[:total])).reshape(sizes)
    return Mesh(DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names)))


def single_axis_mesh(axis="dp", n=None):
    """A one-axis Mesh over the first `n` ranks (default all)."""
    devices = local_mesh_devices()
    return make_mesh({axis: n or len(devices)}, devices)
