"""Per-channel int8 quantization (counterpart of
`mxnet_tpu/contrib/quantization.py:quantize_channelwise`; the calibration
and quantized layers of that module are not ported)."""
from __future__ import annotations

import torch

__all__ = ["quantize_channelwise"]


def quantize_channelwise(w, axis=0):
    """Symmetric per-channel int8 quantization: one scale per index
    along `axis` (for a Dense weight (out, in), axis=0 is per output
    channel). Returns (int8 tensor, float32 scale vector of length
    w.shape[axis]) with w ≈ q * scale broadcast along `axis`:
    scale = max(amax, 1e-12) / 127, q = clip(round(w / scale), -127,
    127), rounding half to even as `jnp.round` does. A channel of all
    zeros gets the minimum scale and quantizes to 0 exactly."""
    axis = axis % w.dim()
    red = tuple(i for i in range(w.dim()) if i != axis)
    wf = w.float()
    amax = wf.abs().amax(dim=red) if red else wf.abs()
    scale = amax.clamp_min(1e-12) / 127.0
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale
