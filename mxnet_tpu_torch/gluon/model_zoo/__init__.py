"""mx.gluon.model_zoo (counterpart of `mxnet_tpu/gluon/model_zoo/`): the
vision zoo's ResNet family."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
