"""Base utilities: the framework's error type.

Counterpart of `mxnet_tpu/base.py` (parity with mxnet.base.MXNetError).
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (mxnet.base.MXNetError parity)."""
