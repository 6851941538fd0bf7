"""Gluon neural-network layers."""
from .basic_layers import *                 # noqa: F401,F403
from .basic_layers import __all__ as _layers

__all__ = list(_layers)
