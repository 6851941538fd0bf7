"""mxnet_tpu_torch: the PyTorch / CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` stays the reference; this package is its
counterpart for NVIDIA Hopper cards, with the same structure and names:

  import mxnet_tpu_torch as mx
  from mxnet_tpu_torch import autograd, gluon

  model = mx.models.transformer_base(36548, dropout=0.0)
  model.initialize(ctx=mx.gpu(0))
  trainer = gluon.Trainer(model.collect_params(), "adam",
                          {"learning_rate": 3e-4})
  ce = gluon.loss.SoftmaxCrossEntropyLoss()
  with autograd.record():
      loss = ce(model(src, tgt_in, src_len).reshape((-1, 36548)),
                tgt_out.reshape((-1,))).mean()
  loss.backward()
  trainer.step(src.shape[0])

  srv = mx.serve.Server(model, engine_driven=False)
  print(srv.submit([5, 9, 11]).result())

It imports `torch` and `numpy`, never `jax` and nothing of `mxnet_tpu`.
Entry points run on `mx.gpu(0)` unless the caller passes
`device="cpu"` / `ctx=mx.cpu()`; with no CUDA device and no explicit
CPU request they raise `MXNetError`. The kernels are CUDA C++ written
for `sm_90a` (`ops/csrc/`), built with `nvcc` at first use; on CPU
tensors their plain PyTorch versions run instead.

Four slices are ported: serving (TransformerNMT through `serve.Server`),
Gluon training (NDArray, autograd, Gluon blocks and layers, losses,
optimizers and the Trainer, on the same TransformerNMT), the serving
fast path (`Server(speculative_k=k, kv_dtype="int8",
weight_dtype="int8")`) and ResNet training through Gluon
(`gluon.model_zoo.vision.get_model("resnet50_v1")`, convolution,
pooling, BatchNorm), with `ops.conv1x1_bn_stats` and runtime CUDA
compilation (`rtc.CudaModule`). ROADMAP.md lists what is still to be
ported.
"""

__version__ = "0.1.0"

from . import base
from .base import MXNetError
from . import context
from .context import cpu, gpu, num_gpus
from . import observability
from . import profiler
from . import fault
from . import random
from . import initializer
from . import initializer as init
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import ops
from . import optimizer
from . import gluon
from . import models
from . import contrib
from . import convert
from . import rtc
from . import serve

__all__ = ["MXNetError", "base", "context", "cpu", "gpu", "num_gpus",
           "observability", "profiler", "fault", "random", "initializer",
           "init", "autograd", "ndarray", "nd", "ops", "optimizer", "gluon",
           "models", "contrib", "convert", "rtc", "serve"]
