"""mx.contrib (counterpart of `mxnet_tpu/contrib`): the per-channel int8
quantizer that int8 serving needs and `contrib.io.DataLoaderIter`
(ROADMAP.md, Queue 1 item 8 has the rest)."""
from __future__ import annotations

from . import io
from . import quantization

__all__ = ["io", "quantization"]
