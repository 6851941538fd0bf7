"""mx.gluon (counterpart of `mxnet_tpu/gluon/`): blocks, parameters, the
basic, convolution and pooling layers, losses, the Trainer, the vision
zoo's ResNets, and `data` (datasets, samplers, the engine-fed
DataLoader, the vision datasets and transforms)."""
from . import block, data, loss, model_zoo, nn, parameter, trainer
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["block", "data", "loss", "model_zoo", "nn", "parameter", "trainer", "Block",
           "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
