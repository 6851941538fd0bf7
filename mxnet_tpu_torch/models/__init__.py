"""Model definitions of the port."""
from __future__ import annotations

from . import transformer
from .transformer import TransformerNMT, transformer_base

__all__ = ["transformer", "TransformerNMT", "transformer_base"]
