"""Hand-written CUDA kernels of the port and their plain versions."""
from __future__ import annotations

from . import kernels
from .kernels import (flash_attention, flash_attention_fwd,
                      ragged_paged_attention)

__all__ = ["kernels", "flash_attention", "flash_attention_fwd",
           "ragged_paged_attention"]
