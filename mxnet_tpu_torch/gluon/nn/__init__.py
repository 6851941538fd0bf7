"""Gluon neural-network layers."""
from .basic_layers import *                 # noqa: F401,F403
from .basic_layers import __all__ as _layers
from .conv_layers import *                  # noqa: F401,F403
from .conv_layers import __all__ as _conv_layers

__all__ = list(_layers) + list(_conv_layers)
