"""MLP on MNIST — BASELINE.json config #1 (counterpart of
`mxnet_tpu/models/mlp.py`): a Gluon `HybridSequential` of Dense layers,
`bench_mlp.py`'s 784-512-256-10 net with `hidden=(512, 256)`."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["get_mlp"]


def get_mlp(hidden=(128, 64), classes=10, activation="relu"):
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        for h in hidden:
            net.add(nn.Dense(h, activation=activation))
        net.add(nn.Dense(classes))
    return net
