"""NDArray serialisation (counterpart of `mxnet_tpu/ndarray/utils.py`;
reference: mx.nd.save / mx.nd.load, C API NDArraySave / NDArrayLoad).

The format is the JAX package's numpy .npz: a list saves as keys
``arr:<i>``, a str-keyed dict as ``key:<name>``, so a file crosses both
packages. numpy has no bfloat16: a bfloat16 array is written as float32
holding its values exactly, as `Block.save_parameters` writes it, so the
JAX package loads it (and its cast back to bfloat16 gives the same
bits); the JAX package's own bfloat16 entries (ml_dtypes', stored as
2-byte void ``<V2``) load here as bfloat16 with their bits.

The disk write is pushed onto the dependency engine against the file's
var (`engine.file_var`; reference: NDArray::Save is a PushAsync over the
array vars): `save` copies the values to the host before it returns, so
later in-place updates do not reach the file, and the write overlaps
the caller's work; `load` waits on the same var, so it reads after any
save of that path still in flight."""
from __future__ import annotations

import io as _io

import numpy as np
import torch

from ..context import resolve_device
from .ndarray import NDArray

__all__ = ["save", "load", "load_frombuffer"]


def _npz_path(fname):
    # np.savez appends .npz to a name without it: the file var must track
    # the path actually written
    fname = str(fname)
    return fname if fname.endswith(".npz") else fname + ".npz"


def _snapshot(x):
    """`x`'s values on the host, in memory of their own (a CPU tensor's
    `asnumpy` shares its memory)."""
    arr = x.asnumpy()
    return arr.copy() if x._data.device.type == "cpu" else arr


def save(fname, data):
    """Save an NDArray, a list of NDArrays or a str-keyed dict of them.
    The values are copied to the host now; the write runs on the engine,
    in order for this file."""
    from .. import engine
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        arrays = {f"arr:{i}": _snapshot(d) for i, d in enumerate(data)}
    elif isinstance(data, dict):
        arrays = {f"key:{k}": _snapshot(v) for k, v in data.items()}
    else:
        raise TypeError(f"unsupported data type {type(data)}")
    engine.push(lambda: np.savez(fname, **arrays),
                write_vars=[engine.file_var(_npz_path(fname))])


def _tensor(arr):
    """A CPU tensor of one saved array: 2-byte void entries are the JAX
    package's bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _decode_npz(f, device):
    """The `save` payload (a list as 'arr:<i>' keys, a dict as
    '<kind>:<name>' keys) as NDArrays on `device`."""
    keys = list(f.keys())
    if all(k.startswith("arr:") for k in keys):
        items = sorted(keys, key=lambda k: int(k.split(":", 1)[1]))
        return [NDArray(_tensor(f[k]).to(device)) for k in items]
    return {k.split(":", 1)[1]: NDArray(_tensor(f[k]).to(device))
            for k in keys}


def load(fname, ctx=None):
    """Load what `save` wrote (from either package), a list or a dict as
    it was saved, onto `ctx` (None = `mx.gpu(0)`). Waits on the file's
    engine var first, so it reads after a save still in flight."""
    from .. import engine
    device = resolve_device(ctx)
    engine.wait_for_var(engine.file_var(_npz_path(fname)))
    with np.load(_npz_path(fname), allow_pickle=False) as f:
        return _decode_npz(f, device)


def load_frombuffer(buf, ctx=None):
    """Load from an in-memory `save` payload (reference:
    mx.nd.load_frombuffer over the C NDArrayLoadFromBuffer)."""
    device = resolve_device(ctx)
    with np.load(_io.BytesIO(buf), allow_pickle=False) as f:
        return _decode_npz(f, device)
