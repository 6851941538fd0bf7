"""Device contexts: `mx.cpu()` / `mx.gpu(i)` as `torch.device`s.

Counterpart of `mxnet_tpu/context.py`. The card is the first-class
context: every entry point that takes `device=` or `ctx=` resolves
`None` to `gpu(0)`, and the CPU is used only when the caller asks for it
(`device="cpu"` / `ctx=mx.cpu()`). With no CUDA device and no explicit CPU
request, `resolve_device` raises — nothing carries on quietly on the
CPU. There is no `mx.tpu`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (PyTorch has one CPU device; the id is accepted for
    reference-script parity)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA card `device_id`."""
    return torch.device("cuda", int(device_id))


def num_gpus():
    """Number of CUDA cards visible to this process."""
    return torch.cuda.device_count()


def resolve_device(device=None):
    """`device` as a concrete `torch.device`: None means `gpu(0)`.
    Raises `MXNetError` for a CUDA device that is not present, and for
    any device type other than cpu and cuda."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return cpu()
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {dev} (use mx.gpu(i) or "
                         f"mx.cpu())")
    if not torch.cuda.is_available():
        raise MXNetError(
            f"{dev} requested but no CUDA device is available; pass "
            f"device='cpu' (mx.cpu()) to run on the CPU")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise MXNetError(f"{dev} not available: "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)
