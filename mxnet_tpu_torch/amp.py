"""Automatic mixed precision (counterpart of `mxnet_tpu/amp.py`).

`init()` turns on op-level autocast: the product and convolution entry
points (`ndarray.FullyConnected`, `ops.nn_ops.convolution`) consult
`autocast_dtype()` and run fp32 operands in the target dtype, on
cuBLAS / cuDNN on the card. `convert_block` casts the layers in
`_CAST_LAYERS` to the target dtype and keeps the normalisation layers
in `_KEEP_FP32` in fp32. The attention and LayerNorm take what the
products hand them: under `init("float16")` the flash kernels' float16
forms and, where a LayerNorm's input is float16, its float16 form with
the fp32 gamma / beta that `_KEEP_FP32` leaves (a sum with the fp32
residual stream promotes to fp32, as in the JAX package).

For float16 the dynamic loss scaling is wired into `gluon.Trainer`:
when `init(target_dtype="float16")` installed a `DynamicLossScaler`, a
step unscales the gradients, skips the update on overflow and halves
the scale; `skip_nonfinite=True` without a scaler skips on inf / nan
too. Either check is one reduction over all gradients and one host read
(`grads_nonfinite`).
"""
from __future__ import annotations

import torch

from . import profiler

__all__ = ["init", "reset", "convert_block", "scale_loss", "unscale",
           "unscale_arrays", "DynamicLossScaler", "bfloat16",
           "autocast_dtype", "is_active", "grads_nonfinite", "scaler"]

bfloat16 = torch.bfloat16

_CAST_LAYERS = ("Dense", "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
                "Embedding", "ShardedEmbedding")
_KEEP_FP32 = ("BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm")

_state = {"scaler": None, "initialized": False, "target_dtype": None}


def init(target_dtype="bfloat16"):
    """Turn on the op-level autocast; for float16 also install the
    `DynamicLossScaler` that `gluon.Trainer` consults."""
    _state["initialized"] = True
    _state["target_dtype"] = target_dtype
    if target_dtype == "float16":
        _state["scaler"] = DynamicLossScaler()


def reset():
    """Turn AMP off again."""
    _state["initialized"] = False
    _state["target_dtype"] = None
    _state["scaler"] = None


def is_active():
    return _state["initialized"]


def scaler():
    """The installed DynamicLossScaler, or None: only float16 AMP has
    one (bf16 needs no loss scaling)."""
    return _state.get("scaler") if _state["initialized"] else None


def autocast_dtype():
    """The dtype fp32 product and convolution operands are cast to under
    AMP, or None when AMP is off."""
    if not _state["initialized"]:
        return None
    t = _state.get("target_dtype") or "bfloat16"
    return torch.float16 if str(t) in ("float16", "fp16") \
        else torch.bfloat16


def convert_block(block, target_dtype="bfloat16"):
    """Cast the product and convolution layers to the target dtype and
    force the normalisation layers in `_KEEP_FP32` back to fp32, so it
    is safe after a blanket `net.cast("bfloat16")`."""
    def walk(b):
        name = type(b).__name__
        if name in _KEEP_FP32:
            b.cast("float32")
            return
        if name in _CAST_LAYERS:
            b.cast(target_dtype)
        for c in b._children.values():
            walk(c)
    walk(block)
    return block


class DynamicLossScaler:
    """Dynamic loss scaling for float16: halve the scale on an overflow
    (never below 1), double it after `scale_window` clean steps."""

    def __init__(self, init_scale=2. ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        return grads_nonfinite(params)

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self.scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0


def _grads(params):
    return [p._grad._data for p in params
            if getattr(p, "_grad", None) is not None]


def grads_nonfinite(params):
    """True if any parameter's gradient holds an inf or a nan: every
    gradient in one flat buffer, one `isfinite` reduction over it and one
    host read, not a launch and a read for each parameter."""
    grads = _grads(params)
    if not grads:
        return False
    flat = torch.cat([g.detach().reshape(-1) for g in grads])
    return not bool(torch.isfinite(flat).all())


def scale_loss(loss, trainer_or_scaler=None):
    scaler = _state.get("scaler")
    if scaler is None:
        return loss
    return loss * scaler.loss_scale


def unscale_arrays(grads, inv_scale):
    """Multiply every gradient tensor by `inv_scale` in place, as one
    multi-tensor launch (`torch._foreach_mul_`), counted as one
    `amp_unscale` dispatch; returns the same list. The scaler's scales
    are powers of two, so the product is the same in every float
    dtype."""
    grads = list(grads)
    if not grads:
        return []
    profiler.record_dispatch("amp_unscale")
    with torch.no_grad():
        torch._foreach_mul_(grads, float(inv_scale))
    return grads


def unscale(grads_or_trainer):
    """Divide the gradients of a Trainer's (or a list of) parameters by
    the loss scale; nothing without a scaler."""
    scaler = _state.get("scaler")
    if scaler is None:
        return
    params = grads_or_trainer._params \
        if hasattr(grads_or_trainer, "_params") else grads_or_trainer
    unscale_arrays(_grads(params), 1.0 / scaler.loss_scale)
