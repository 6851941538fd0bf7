"""mx.optimizer namespace (counterpart of `mxnet_tpu/optimizer/`)."""
from .optimizer import Optimizer, SGD, Adam, create, register, \
    fused_sgd_mom_kernel, multi_sgd_mom_update, multi_sgd_update
from . import optimizer as opt
from .updater import Updater, get_updater
from . import multi_tensor
from .multi_tensor import FusedUpdater, build_buckets

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "opt",
           "Updater", "get_updater", "multi_tensor", "fused_sgd_mom_kernel",
           "multi_sgd_mom_update", "multi_sgd_update", "FusedUpdater",
           "build_buckets"]
