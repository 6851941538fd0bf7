"""Updater: a closure over an Optimizer holding per-index states
(counterpart of `mxnet_tpu/optimizer/updater.py`)."""
from __future__ import annotations

__all__ = ["Updater", "get_updater"]


class Updater:
    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        self.states = states

    def get_states(self, dump_optimizer=False):
        return self.states


def get_updater(optimizer, fused=False):
    """The per-parameter updater, or with `fused=True` the bucketed
    `multi_tensor.FusedUpdater`; both keep the same `states` dict."""
    if fused:
        from .multi_tensor import FusedUpdater
        return FusedUpdater(optimizer)
    return Updater(optimizer)
