"""mx.contrib (counterpart of `mxnet_tpu/contrib`): only the per-channel
int8 quantizer that int8 serving needs is ported (ROADMAP.md, Queue 1
item 8 has the rest)."""
from __future__ import annotations

from . import quantization

__all__ = ["quantization"]
