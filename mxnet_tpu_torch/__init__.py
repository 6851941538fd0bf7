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

  srv = mx.serve.Server(model)          # decodes on the engine
  print(srv.submit([5, 9, 11]).result())

It imports `torch` and `numpy`, never `jax` and nothing of `mxnet_tpu`.
Entry points run on `mx.gpu(0)` unless the caller passes
`device="cpu"` / `ctx=mx.cpu()`; with no CUDA device and no explicit
CPU request they raise `MXNetError`. The kernels are CUDA C++ written
for `sm_90a` (`ops/csrc/`), built with `nvcc` at first use; on CPU
tensors their plain PyTorch versions run instead.

Ported slices: serving (TransformerNMT through `serve.Server`), Gluon
training (NDArray, autograd, Gluon blocks and layers, losses,
optimizers and the Trainer, on the same TransformerNMT), the serving
fast path (`Server(speculative_k=k, kv_dtype="int8",
weight_dtype="int8")`), ResNet training through Gluon
(`gluon.model_zoo.vision.get_model("resnet50_v1")`, convolution,
pooling, BatchNorm), with `ops.conv1x1_bn_stats` and runtime CUDA
compilation (`rtc.CudaModule`), BERT pretraining (`models.bert`), and
long-context sequence parallelism over `torch.distributed`
(`kvstore.init_distributed`, `parallel.make_mesh`, ring and all-to-all
attention over `ops.flash_block_attention`), and bf16 training as the
JAX benches run it (`Block.cast("bfloat16")`; ResNet-50 with the
space-to-depth stem; `amp`), and the Trainer's fused multi-tensor
update with `Trainer.capture` / `mx.jit_step`, the whole training step
as one CUDA graph (`cachedop`), and the dependency engine (`engine`,
`csrc/engine.cc` built with g++) that runs `serve.Server`'s decode loop
by default and the `gluon.data.DataLoader`'s batchify tasks, with
`metric`, `lr_scheduler` and `models.get_mlp` for MLP-on-MNIST, and the
input pipeline, IO and checkpoints: `recordio` (with the C++ mmap
reader `csrc/recordio.cc`), `gluon.data.RecordFileDataset`,
`prefetch.DevicePrefetcher` behind `DataLoader(prefetch_to_device=...,
pin_memory=True)`, `mx.nd.save` / `load`, `checkpoint` (atomic,
checksummed, async and emergency saves, `CheckpointManager`), and
`fault.retry` / `fault.preemption`, and the image input pipeline:
`image` (decode, resize, crops, the augmenters, `ImageIter`), `io`
(`NDArrayIter`, `PrefetchingIter`, `ImageRecordIter`, ...),
`contrib.io.DataLoaderIter` and the image-file datasets, on the port's
own JPEG / PNG codec (`_imcodec`, `csrc/imcodec.cc` built with g++),
and data parallelism: the key-value store (`mx.kv.create`, `KVStore`:
push / pull / allreduce over NCCL, one process a card, gradient
compression, the optimizer on the store), the Trainer's store path, a
captured step that reduces across ranks (`sharded_update=True`: ZeRO-1),
`parallel.make_train_step` / `DataParallelTrainer`, `shard_batch` and
ZeRO checkpoints. ROADMAP.md lists what is still to be ported.
"""

__version__ = "0.1.0"

from . import base
from .base import MXNetError
from . import log
from . import context
from .context import cpu, gpu, num_gpus
from . import observability
from . import profiler
from . import engine
from . import fault
from . import kvstore
from . import kvstore as kv
from .kvstore import KVStore
from . import random
from . import initializer
from . import initializer as init
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import ops
from . import amp
from . import parallel
from . import lr_scheduler
from . import metric
from . import optimizer
from . import gluon
from . import recordio
from . import image
from . import io
from . import prefetch
from . import checkpoint
from . import cachedop
from .cachedop import CachedStep, jit_step
from . import models
from . import contrib
from . import convert
from . import rtc
from . import serve

__all__ = ["MXNetError", "base", "log", "context", "cpu", "gpu", "num_gpus",
           "observability", "profiler", "fault", "kvstore", "kv", "KVStore",
           "random",
           "initializer", "init", "autograd", "ndarray", "nd", "ops",
           "amp", "parallel", "lr_scheduler", "metric", "optimizer", "gluon",
           "engine", "recordio", "image", "io", "prefetch", "checkpoint",
           "cachedop", "CachedStep", "jit_step",
           "models", "contrib", "convert", "rtc", "serve"]
