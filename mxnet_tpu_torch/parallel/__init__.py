"""mx.parallel — data and sequence parallelism over `torch.distributed`
(counterpart of `mxnet_tpu/parallel`).

Ported: named meshes over the default process group (`make_mesh`,
`single_axis_mesh`, `local_mesh_devices`, `Mesh`) with the JAX
shardings' counterparts (`Sharding`, `replicated`, `shard_batch`); the
functional bridge (`functional_call`, `param_values`) and data-parallel
training (`make_train_step`, `DataParallelTrainer`); and the two
long-context strategies, ring attention and all-to-all (Ulysses)
attention, each as a per-rank body and a `_sharded` entry over global
tensors. Tensor, pipeline, expert and composite parallelism
(`tensor_parallel`, `pipeline`, `moe`, `composite`) are not ported yet
(ROADMAP.md, Queue 1 [5c]).
"""
from .mesh import (Mesh, Sharding, make_mesh, single_axis_mesh,
                   local_mesh_devices, replicated, shard_batch)
from .functional import functional_call, param_values, \
    collect_params_ordered
from .data_parallel import DataParallelTrainer, make_train_step
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = ["Mesh", "Sharding", "make_mesh", "single_axis_mesh",
           "local_mesh_devices", "replicated", "shard_batch",
           "functional_call", "param_values", "collect_params_ordered",
           "DataParallelTrainer", "make_train_step", "ring_attention",
           "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
