"""Named device meshes over the default process group (counterpart of
`mxnet_tpu/parallel/mesh.py`).

A process drives one device, so a mesh's devices are the ranks of the
default group (`kvstore.init_distributed`): NCCL ranks on the cards, or
gloo ranks on the CPU. Axis names as in the JAX package: dp (data), tp
(tensor), pp (pipeline), sp (sequence), ep (expert).

The JAX package's shardings map onto ranks so (`Sharding`):
`replicated(mesh)`, `P()`, is the same tensor on every rank, and a batch
sharded over `dp`, `P('dp')`, is this rank's contiguous block of rows, rank
r holding rows r*B/P : (r+1)*B/P of the global batch. A tensor does not
say which of the two it holds (a JAX array's `.sharding` does), so the
callers say it: a step over a mesh takes this rank's rows unless it is
told that it was handed the global batch (`global_batch=True`), and the
store's `allreduce_` is told its layout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import kvstore
from ..base import MXNetError

__all__ = ["Mesh", "make_mesh", "single_axis_mesh", "local_mesh_devices",
           "Sharding", "replicated", "shard_batch"]


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

    @property
    def device(self):
        """This rank's device: its card under NCCL, the CPU under gloo."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def fingerprint(self):
        """Axis names, sizes and the ranks in mesh order: two meshes with
        equal fingerprints place every tensor alike (a cache key)."""
        return (self.axis_names, tuple(self.shape.values()),
                tuple(int(r) for r in self.device_mesh.mesh.flatten()))

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


class Sharding:
    """A `NamedSharding(mesh, P(*spec))` of the JAX package in the port's
    one-rank-a-device terms: `spec` () is replicated, (axis,) is dim 0
    split over `axis` in contiguous blocks of rows. `place(x)` is
    `jax.device_put(x, sharding)` for a global `x` that every rank holds:
    the rows of this rank (or all of `x`) on this rank's device."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def device(self):
        return self.mesh.device

    @property
    def axis(self):
        return self.spec[0] if self.spec else None

    @property
    def num_shards(self):
        return int(self.mesh.shape[self.axis]) if self.spec else 1

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.spec == other.spec
                and self.mesh.fingerprint() == other.mesh.fingerprint())

    def __hash__(self):
        return hash((self.spec, self.mesh.fingerprint()))

    def __repr__(self):
        return f"Sharding({self.mesh!r}, P{self.spec!r})"

    def local_rows(self, x):
        """This rank's block of rows of a global `x` (a view), on the
        device `x` is on; `x` itself when replicated."""
        if not self.spec:
            return x
        n = self.num_shards
        if x.dim() == 0 or x.shape[0] % n:
            raise MXNetError(f"{self!r}: dim 0 of a {tuple(x.shape)} batch "
                             f"does not split over {n} ranks")
        rows = x.shape[0] // n
        return x.narrow(0, self.mesh.axis_index(self.axis) * rows, rows)

    def place(self, x):
        return self.local_rows(x).to(self.device)


def replicated(mesh):
    """The same tensor on every rank of `mesh` (`P()`)."""
    return Sharding(mesh, ())


def shard_batch(mesh, batch, axis="dp"):
    """This rank's rows of a global batch tree, on this rank's device:
    every leaf (NDArray, tensor or numpy array, nested in tuples, lists
    and dicts) split along dim 0 over `axis` (`P(axis)`), as the same
    kind of leaf."""
    from ..ndarray.ndarray import NDArray
    sh = Sharding(mesh, (axis,))

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if isinstance(x, NDArray):
            return NDArray(sh.place(x._data))
        if isinstance(x, torch.Tensor):
            return sh.place(x)
        return sh.place(torch.as_tensor(np.asarray(x)))
    return one(batch)
