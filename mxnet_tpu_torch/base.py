"""Base utilities: the framework's error type and its dtypes.

Counterpart of `mxnet_tpu/base.py` (parity with mxnet.base.MXNetError).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "numpy_dtype", "dtype_of", "from_numpy"]


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (mxnet.base.MXNetError parity)."""


# MXNet names dtypes the numpy way; tensors carry torch dtypes
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.float16): torch.float16,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64,
           np.dtype(np.int8): torch.int8,
           np.dtype(np.uint8): torch.uint8,
           np.dtype(np.bool_): torch.bool}
_NP_DTYPES = {t: n for n, t in _DTYPES.items()}
# the common spellings looked up directly (names, numpy dtypes, numpy
# scalar types): `np.dtype(...)` costs microseconds a call, and per-sample
# data transforms convert dtypes millions of times an epoch
_FAST = {**_DTYPES, **{n.name: t for n, t in _DTYPES.items()},
         **{n.type: t for n, t in _DTYPES.items()},
         "bfloat16": torch.bfloat16}


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype, a name ("float32", "bfloat16",
    ...), or a torch dtype. numpy has no bfloat16 of its own: the name,
    and a numpy dtype named so (ml_dtypes' bfloat16, which the JAX
    package's arrays carry), give torch.bfloat16."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        fast = _FAST.get(dtype)
    except TypeError:                  # unhashable: the general path
        fast = None
    if fast is not None:
        return fast
    try:
        npd = np.dtype(dtype)
    except TypeError as e:
        raise MXNetError(f"unsupported dtype {dtype!r}") from e
    if npd.name == "bfloat16":
        return torch.bfloat16
    try:
        return _DTYPES[npd]
    except KeyError as e:
        raise MXNetError(f"unsupported dtype {dtype!r}") from e


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (the torch dtype itself where
    numpy has none, as for bfloat16)."""
    return _NP_DTYPES.get(dtype, dtype)


def dtype_of(dtype):
    """The dtype a Parameter or NDArray reports for any dtype
    `torch_dtype` takes: a numpy dtype, or torch.bfloat16 (numpy has no
    bfloat16; the JAX package reports ml_dtypes' numpy dtype)."""
    return numpy_dtype(torch_dtype(dtype))


def from_numpy(arr):
    """A CPU tensor holding a copy of numpy array `arr`. An array whose
    dtype is named bfloat16 (ml_dtypes', as the JAX package hands its
    bf16 arrays over) is read through its 16-bit patterns and viewed as
    torch.bfloat16, without importing ml_dtypes."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(arr)
