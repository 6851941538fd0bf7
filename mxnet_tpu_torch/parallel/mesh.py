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
           "P", "Sharding", "replicated", "shard_batch"]


class Mesh:
    """A `torch.distributed` `DeviceMesh` with the JAX Mesh's view of it:
    `shape` (axis name -> size, in the axes' order) and `axis_names`.
    `group(axis)` is the process group of this rank's line along `axis`
    (or along a tuple of axes), `axis_index(axis)` this rank's place on
    it, `device_type` "cuda" (NCCL) or "cpu" (gloo)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self._groups = {}         # tuple of axes -> this rank's group

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
        """The process group of this rank's line along `axis`, a name or
        a tuple of names (`lax.psum(x, ("dp", "sp"))`'s group: the ranks
        that share this rank's place on every other axis). A tuple's
        groups are made on first use, every line of them at once, so
        every rank of the default group must ask for the same tuples in
        the same order (the composite asks in its constructor); they are
        kept on the mesh."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or not axes:
            raise MXNetError(f"{self!r} has no axes {axis!r}")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            self._groups[key] = _line_group(self.device_mesh.mesh,
                                            self.axis_names, key)
        return self._groups[key]

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


def _line_group(ranks, names, axes):
    """This rank's group among the lines of `ranks` (the mesh's rank
    tensor) along `axes`: every line is made, in one order on every
    rank, as `dist.new_group` wants."""
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    lines = ranks.permute(*rest, *keep).reshape(
        -1, int(np.prod([ranks.shape[i] for i in keep])))
    mine, _ = dist.new_subgroups_by_enumeration(
        [[int(r) for r in line] for line in lines])
    return mine


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


class P(tuple):
    """A PartitionSpec: one entry a dim, an axis name or None
    (`jax.sharding.PartitionSpec`, whose tuple it equals)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Sharding:
    """A `NamedSharding(mesh, P(*spec))` of the JAX package in the port's
    one-rank-a-device terms: `spec` has one entry a leading dim, an axis
    name (that dim split over the axis in contiguous blocks, block r on
    the rank at place r of the axis) or None (whole); () is replicated.
    `place(x)` is `jax.device_put(x, sharding)` for a global `x` that
    every rank holds: this rank's block (or all of `x`) on this rank's
    device. `axis`, `num_shards` and `local_rows` speak of dim 0, the
    batch's."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)
        for ax in self.spec:
            if ax is not None and ax not in mesh.shape:
                raise MXNetError(f"{mesh!r} has no axis {ax!r}")

    @property
    def device(self):
        return self.mesh.device

    @property
    def axis(self):
        return self.spec[0] if self.spec else None

    @property
    def num_shards(self):
        return int(self.mesh.shape[self.axis]) if self.axis else 1

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.spec == other.spec
                and self.mesh.fingerprint() == other.mesh.fingerprint())

    def __hash__(self):
        return hash((self.spec, self.mesh.fingerprint()))

    def __repr__(self):
        return f"Sharding({self.mesh!r}, P{self.spec!r})"

    def _block(self, x, dim, ax, what):
        n = int(self.mesh.shape[ax])
        if x.dim() <= dim or x.shape[dim] % n:
            raise MXNetError(f"{self!r}: dim {dim} of a {tuple(x.shape)} "
                             f"{what} does not split over {n} ranks")
        rows = x.shape[dim] // n
        return x.narrow(dim, self.mesh.axis_index(ax) * rows, rows)

    def local_rows(self, x):
        """This rank's block of rows of a global `x` (a view), on the
        device `x` is on; `x` itself when dim 0 is whole."""
        if not self.axis:
            return x
        return self._block(x, 0, self.axis, "batch")

    def local_block(self, x):
        """This rank's block of a global `x` along every split dim (a
        view), on the device `x` is on."""
        for dim, ax in enumerate(self.spec):
            if ax is not None:
                x = self._block(x, dim, ax, "tensor")
        return x

    def place(self, x):
        return self.local_block(x).to(self.device)


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
