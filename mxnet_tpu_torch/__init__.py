"""mxnet_tpu_torch: the PyTorch / CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` stays the reference; this package is its
counterpart for NVIDIA Hopper cards, with the same structure and names:

  import mxnet_tpu_torch as mx
  model = mx.models.transformer_base(36548)          # on mx.gpu(0)
  srv = mx.serve.Server(model, engine_driven=False)
  print(srv.submit([5, 9, 11]).result())

It imports `torch` and `numpy`, never `jax` and nothing of `mxnet_tpu`.
Entry points run on `mx.gpu(0)` unless the caller passes
`device="cpu"` / `mx.cpu()`; with no CUDA device and no explicit CPU
request they raise `MXNetError`. The attention kernels are CUDA C++
written for `sm_90a` (`ops/csrc/`), built with `nvcc` at first use; on
CPU tensors their plain PyTorch versions run instead.

This slice ports the serving path (TransformerNMT through
`serve.Server`); ROADMAP.md lists what is still to be ported.
"""

__version__ = "0.1.0"

from . import base
from .base import MXNetError
from . import context
from .context import cpu, gpu, num_gpus
from . import observability
from . import profiler
from . import fault
from . import ops
from . import models
from . import convert
from . import serve

__all__ = ["MXNetError", "base", "context", "cpu", "gpu", "num_gpus",
           "observability", "profiler", "fault", "ops", "models",
           "convert", "serve"]
