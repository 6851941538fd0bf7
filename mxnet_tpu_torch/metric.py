"""Evaluation metrics (counterpart of `mxnet_tpu/metric.py`; reference:
python/mxnet/metric.py). Every metric reads its labels and predictions
to the host (`asnumpy`, or numpy / torch tensors as they are) and
accumulates in numpy, so a metric updates the same on either device."""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "PCC", "Loss",
           "CompositeEvalMetric", "CustomMetric", "create", "np", "Torch", "Caffe"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    if name not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}")
    return _REGISTRY[name](*args, **kwargs)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _to_np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_as_list(name), _as_list(value)))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int64).ravel()
            label = label.astype(np.int64).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(np.int64)
            pred = _to_np(pred)
            topk = np.argsort(-pred, axis=-1)[..., :self.top_k]
            self.sum_metric += float((topk == label[..., None]).any(-1).sum())
            self.num_inst += label.size


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(np.int64)
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=-1)
            pred = pred.ravel().astype(np.int64)
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1e-12)
        rec = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(np.int64)
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=-1)
            pred = pred.ravel().astype(np.int64)
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.tn += float(((pred == 0) & (label == 0)).sum())
            self.num_inst += 1

    def get(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = np.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                      * (self.tn + self.fp) * (self.tn + self.fn))
        return self.name, float(num / den) if den > 0 else 0.0


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(np.abs(label - pred.reshape(label.shape)).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(((label - pred.reshape(label.shape)) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(np.int64)
            pred = _to_np(pred).reshape(len(label), -1)
            prob = pred[np.arange(len(label)), label]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(np.int64)
            pred = _to_np(pred).reshape(len(label), -1)
            prob = pred[np.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = np.where(ignore, 1.0, prob)
                n = int((~ignore).sum())
            else:
                n = len(label)
            self.sum_metric += float(-np.log(np.maximum(prob, 1e-12)).sum())
            self.num_inst += n

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_np(label).ravel())
            self._preds.append(_to_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        lab = np.concatenate(self._labels)
        pre = np.concatenate(self._preds)
        return self.name, float(np.corrcoef(lab, pre)[0, 1])


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation / Matthews generalisation over the
    confusion matrix (reference: metric.PCC)."""

    def __init__(self, name="pcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._cm = None

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab = _to_np(label).ravel().astype(np.int64)
            p = _to_np(pred)
            cls = p.argmax(-1).ravel().astype(np.int64) if p.ndim > 1 \
                else (p.ravel() > 0.5).astype(np.int64)
            k = int(max(lab.max(initial=0), cls.max(initial=0))) + 1
            if self._cm is None or self._cm.shape[0] < k:
                new = np.zeros((k, k), np.float64)
                if self._cm is not None:
                    new[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
                self._cm = new
            np.add.at(self._cm, (lab, cls), 1)
            self.num_inst += lab.size

    def get(self):
        if self._cm is None:
            return self.name, float("nan")
        c = self._cm
        n = c.sum()
        t = c.sum(axis=1)   # true counts
        p = c.sum(axis=0)   # predicted counts
        cov_tp = np.trace(c) * n - (t * p).sum()
        denom = np.sqrt(n * n - (p * p).sum()) * \
            np.sqrt(n * n - (t * t).sum())
        return self.name, float(cov_tp / denom) if denom else float("nan")


@register
class Loss(EvalMetric):
    """Running mean of a loss output."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            v = _to_np(pred)
            self.sum_metric += float(v.sum())
            self.num_inst += v.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_as_list(n))
            values.extend(_as_list(v))
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_np(label), _to_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


# upstream framework-comparison aliases: both report the averaged loss
# (reference: metric.Torch / metric.Caffe)
@register
class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        super().__init__(name=name, **kwargs)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", **kwargs):
        super().__init__(name=name, **kwargs)
