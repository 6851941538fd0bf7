"""mx.gluon (counterpart of `mxnet_tpu/gluon/`): blocks, parameters, the
basic layers, losses and the Trainer."""
from . import block, loss, nn, parameter, trainer
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["block", "loss", "nn", "parameter", "trainer", "Block",
           "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
