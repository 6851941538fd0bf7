"""Tensor (model) parallelism over the mesh axis 'tp' (counterpart of
`mxnet_tpu/parallel/tensor_parallel.py`).

The JAX package's helpers are global-view: XLA's SPMD partitioner reads
the weights' shardings and inserts the collectives. The port's are
per-rank bodies, as the composite's layers are: each rank holds its
block of the weights (`shard_params` cuts them by the same rule table)
and the collectives are explicit, Megatron's f and g
(`_comm.f_identity_bwd_psum` / `g_psum_bwd_identity`):

  * `column_parallel_dense` takes this rank's rows of W (its block of
    the output dim) and returns its columns of y; x enters through f, so
    x's gradient is summed over tp, as the global view has it;
  * `row_parallel_dense` takes this rank's columns of x and W's block of
    the input dim, sums the partial products over tp through g, and adds
    the bias after the sum (before it, the sum would count it tp times).

With `mesh=None` both are the dense product. `constrain` is the
identity: a tensor carries no layout in the port (`parallel/mesh.py`).
"""
from __future__ import annotations

import re

import torch

from . import _comm
from .mesh import P, Sharding

__all__ = ["column_parallel_dense", "row_parallel_dense", "shard_params",
           "tp_rules_transformer", "constrain"]


def constrain(x, mesh, spec):
    """`x` (`lax.with_sharding_constraint` has nothing to constrain in a
    per-rank body)."""
    return x


def column_parallel_dense(x, weight, bias=None, mesh=None, tp_axis="tp"):
    """y = x @ W^T with W's rows (the output dim) split over `tp_axis`:
    `weight` (out / tp, in) and `bias` (out / tp,) are this rank's
    blocks, y this rank's columns. No communication in the forward."""
    if mesh is not None:
        x = _comm.f_identity_bwd_psum(x, mesh.group(tp_axis))
    y = torch.matmul(x, weight.T)
    if bias is not None:
        y = y + bias
    return y


def row_parallel_dense(x, weight, bias=None, mesh=None, tp_axis="tp"):
    """y = x @ W^T with W's columns (the input dim) split over `tp_axis`:
    x holds this rank's columns, `weight` (out, in / tp) its block; the
    partial products are summed over `tp_axis` (g), then the whole
    `bias` is added."""
    y = torch.matmul(x, weight.T)
    if mesh is not None:
        y = _comm.g_psum_bwd_identity(y, mesh.group(tp_axis))
    if bias is not None:
        y = y + bias
    return y


def tp_rules_transformer(tp_axis="tp", dp_axis=None):
    """PartitionSpec rules (regex -> spec) for a standard transformer:
    QKV & FFN-in column-parallel, attn-out & FFN-out row-parallel,
    embeddings sharded over vocab."""
    return [
        (r".*(query|key|value|qkv).*weight$", P(tp_axis, None)),
        (r".*(ffn_1|intermediate|fc1|inter).*weight$", P(tp_axis, None)),
        (r".*(proj|ffn_2|output_dense|fc2|out).*weight$", P(None, tp_axis)),
        (r".*(query|key|value|qkv|ffn_1|intermediate|fc1|inter).*bias$",
         P(tp_axis)),
        (r".*word_embed.*weight$", P(tp_axis, None)),
        (r".*", P()),
    ]


def shard_params(params, mesh, rules):
    """This rank's block of each `{name: tensor}` leaf, on the mesh's
    device: the first rule whose regex `re.match`es the name gives the
    spec, and an axis that does not divide its dim stays replicated."""
    out = {}
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    for name, val in params.items():
        spec = P()
        for pat, s in compiled:
            if pat.match(name):
                spec = s
                break
        # drop axes that don't divide evenly (stay replicated)
        fixed = []
        for dim, ax in zip(val.shape, tuple(spec) + (None,) * val.dim()):
            if ax is not None and dim % mesh.shape[ax] != 0:
                ax = None
            fixed.append(ax)
        out[name] = Sharding(mesh, fixed).place(val).contiguous()
    return out
