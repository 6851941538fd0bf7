"""mx.parallel — distributed training over `torch.distributed`
(counterpart of `mxnet_tpu/parallel`).

Axes: dp (data) / tp (tensor) / pp (pipeline) / sp (sequence) / ep
(expert). A process drives one device, so a mesh's devices are the ranks
of the default group: NCCL ranks on the cards, gloo ranks on the CPU.

Named meshes (`make_mesh`, `single_axis_mesh`, `local_mesh_devices`,
`Mesh`, whose `group` takes an axis or a tuple of axes) with the JAX
shardings' counterparts (`P`, `Sharding`, `replicated`, `shard_batch`);
the functional bridge (`functional_call`, `param_values`) and
data-parallel training (`make_train_step`, `DataParallelTrainer`); the
two long-context strategies, ring attention and all-to-all (Ulysses)
attention, each as a per-rank body and a `_sharded` entry over global
tensors; Megatron tensor parallelism (`tensor_parallel`), the GPipe
pipeline (`pipeline_apply`), expert parallelism (`moe`) and the 5-axis
train step that composes them all (`composite`). The JAX package's
functions that run inside `shard_map` are per-rank bodies here, which
every rank of the axis calls with its own blocks.
"""
from .mesh import (Mesh, P, Sharding, make_mesh, single_axis_mesh,
                   local_mesh_devices, replicated, shard_batch)
from .functional import functional_call, param_values, \
    collect_params_ordered
from .data_parallel import DataParallelTrainer, make_train_step
from . import tensor_parallel
from .tensor_parallel import (column_parallel_dense, row_parallel_dense,
                              shard_params, tp_rules_transformer)
from .pipeline import pipeline_apply, stack_stage_params
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses import ulysses_attention, ulysses_attention_sharded
from . import moe
from .moe import moe_ffn, init_moe_params, moe_param_specs
from . import composite

__all__ = ["Mesh", "P", "Sharding", "make_mesh", "single_axis_mesh",
           "local_mesh_devices", "replicated", "shard_batch",
           "functional_call", "param_values", "collect_params_ordered",
           "DataParallelTrainer", "make_train_step", "tensor_parallel",
           "column_parallel_dense", "row_parallel_dense", "shard_params",
           "tp_rules_transformer", "pipeline_apply", "stack_stage_params",
           "ring_attention", "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded", "moe", "moe_ffn", "init_moe_params",
           "moe_param_specs", "composite"]
