"""mx.gluon (counterpart of `mxnet_tpu/gluon/`): blocks, parameters, the
basic, convolution and pooling layers, losses, the Trainer and the
vision zoo's ResNets."""
from . import block, loss, model_zoo, nn, parameter, trainer
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["block", "loss", "model_zoo", "nn", "parameter", "trainer", "Block",
           "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
