"""Hand-written CUDA kernels of the port and their plain versions, and
the tensor ops the Gluon layers call (`nn_ops`)."""
from __future__ import annotations

from . import kernels, nn_ops
from .kernels import (conv1x1_bn_stats, flash_attention, flash_attention_fwd,
                      flash_block_attention, ragged_paged_attention)

__all__ = ["kernels", "nn_ops", "conv1x1_bn_stats", "flash_attention",
           "flash_attention_fwd", "flash_block_attention",
           "ragged_paged_attention"]
