"""mx.optimizer namespace (counterpart of `mxnet_tpu/optimizer/`)."""
from .optimizer import Optimizer, SGD, Adam, create, register
from . import optimizer as opt
from .updater import Updater, get_updater

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "opt",
           "Updater", "get_updater"]
