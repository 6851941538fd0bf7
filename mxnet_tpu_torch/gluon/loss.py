"""Gluon losses (counterpart of `mxnet_tpu/gluon/loss.py:18-37,
108-136`): the losses of this slice; the rest are in ROADMAP.md."""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray, _apply
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _reduce(x, weight, sample_weight, batch_axis):
    """Weight the per-element loss and average it over every axis except
    the batch axis."""
    if sample_weight is not None:
        x = x * sample_weight
    if weight is not None:
        x = x * weight
    axes = tuple(i for i in range(x.dim()) if i != batch_axis)
    return x.mean(dim=axes) if axes else x


def _inputs(pred, label, sample_weight):
    if not isinstance(label, NDArray):
        label = NDArray(torch.as_tensor(label, device=pred.context))
    return [pred, label] + ([sample_weight] if sample_weight is not None
                            else [])


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """(label - pred)^2 / 2, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        def fn(p, lab, *sw):
            x = torch.square(lab.reshape(p.shape) - p) / 2
            return _reduce(x, self._weight, sw[0] if sw else None,
                           self._batch_axis)
        return _apply(fn, _inputs(pred, label, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy; sparse (integer) labels by default, or a
    distribution over `axis` with `sparse_label=False`; `from_logits`
    takes `pred` as log-probabilities already. The loss is in pred's
    dtype, as in the JAX package (`mxnet_tpu/gluon/loss.py:123`): bf16
    logits give a bf16 loss (torch's log_softmax computes in fp32 and
    rounds once); cast them to fp32 first for an fp32 loss."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        ax = self._axis

        def fn(p, lab, *sw):
            logp = p if self._from_logits else torch.log_softmax(p, dim=ax)
            if self._sparse_label:
                idx = lab.to(torch.int64).unsqueeze(ax)
                x = -torch.gather(logp, ax, idx).squeeze(ax)
            else:
                x = -(logp * lab).sum(dim=ax)
            return _reduce(x, self._weight, sw[0] if sw else None,
                           self._batch_axis)
        return _apply(fn, _inputs(pred, label, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
