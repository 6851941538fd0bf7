"""Base utilities: the framework's error type and its dtypes.

Counterpart of `mxnet_tpu/base.py` (parity with mxnet.base.MXNetError).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "numpy_dtype"]


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


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype, a name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise MXNetError(f"unsupported dtype {dtype!r}") from e


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (the torch dtype itself where
    numpy has none, as for bfloat16)."""
    return _NP_DTYPES.get(dtype, dtype)
