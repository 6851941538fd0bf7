"""mx.parallel — sequence parallelism over `torch.distributed`
(counterpart of `mxnet_tpu/parallel`).

Ported: named meshes over the default process group (`make_mesh`,
`single_axis_mesh`, `local_mesh_devices`, `Mesh`) and the two
long-context strategies, ring attention and all-to-all (Ulysses)
attention, each as a per-rank body and a `_sharded` entry over global
tensors. The JAX package's data, tensor, pipeline, expert and composite
parallelism (`data_parallel`, `functional`, `tensor_parallel`,
`pipeline`, `moe`, `composite`) and `shard_batch` / `replicated` are not
ported yet (ROADMAP.md, Queue 1 [5b], [5c]).
"""
from .mesh import Mesh, make_mesh, single_axis_mesh, local_mesh_devices
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = ["Mesh", "make_mesh", "single_axis_mesh", "local_mesh_devices",
           "ring_attention", "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
