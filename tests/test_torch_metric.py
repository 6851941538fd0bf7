"""The port's `metric` and `lr_scheduler` on the CPU against the JAX
package's: every registered metric (and `create`'s names, aliases,
lists and callables) updated with the same seeded labels and
predictions, given as NDArrays of each package, as numpy arrays and, for
the port, as torch tensors; every scheduler at every update count of a
schedule. Both packages accumulate in numpy / Python floats, so the
values must agree to rtol 1e-12 (numpy reorders nothing between them);
the schedulers are pure arithmetic and must agree exactly."""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import metric as jm
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import metric as tm
from mxnet_tpu_torch.base import MXNetError

RTOL = 1e-12


def _batches(kind, seed):
    """[(labels, preds)] as numpy for a metric's input kind."""
    rng = np.random.RandomState(seed)
    out = []
    for n in (7, 13):
        if kind == "class":
            pred = rng.rand(n, 4).astype(np.float32)
            pred /= pred.sum(1, keepdims=True)
            out.append((rng.randint(0, 4, n).astype(np.float32), pred))
        elif kind == "binary":
            out.append((rng.randint(0, 2, n).astype(np.float32),
                        rng.rand(n, 2).astype(np.float32)))
        elif kind == "binary_flat":
            out.append((rng.randint(0, 2, n).astype(np.float32),
                        rng.rand(n).astype(np.float32)))
        else:                                   # regression
            out.append((rng.randn(n).astype(np.float32),
                        rng.randn(n, 1).astype(np.float32)))
    return out


METRICS = [
    ("acc", {}, "class"), ("accuracy", {"axis": 1}, "class"),
    ("top_k_accuracy", {"top_k": 2}, "class"), ("f1", {}, "binary"),
    ("mcc", {}, "binary"), ("mae", {}, "regression"),
    ("mse", {}, "regression"), ("rmse", {}, "regression"),
    ("ce", {}, "class"), ("nll_loss", {}, "class"),
    ("perplexity", {}, "class"), ("perplexity", {"ignore_label": 1},
                                  "class"),
    ("pearsonr", {}, "regression"), ("pcc", {}, "class"),
    ("pcc", {}, "binary_flat"), ("loss", {}, "regression"),
    ("torch", {}, "regression"), ("caffe", {}, "regression"),
]


def _value(metric):
    return metric.get()


def _close(a, b):
    (na, va), (nb, vb) = a, b
    assert na == nb
    va, vb = np.atleast_1d(va).astype(float), np.atleast_1d(vb).astype(float)
    np.testing.assert_allclose(va, vb, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(METRICS)])
@pytest.mark.parametrize("wrap", ["nd", "numpy", "torch"])
def test_metric_matches_jax(name, kw, kind, wrap):
    """create(name, **kw), two updates, get(), reset(), get() again, and
    get_name_value(): the JAX metric's values."""
    jmet, tmet = jm.create(name, **kw), tm.create(name, **kw)
    assert type(tmet).__name__ == type(jmet).__name__
    for lab, pred in _batches(kind, 3):
        jmet.update([mxj.nd.array(lab)], [mxj.nd.array(pred)])
        if wrap == "nd":
            args = ([mx.nd.array(lab, ctx=mx.cpu())],
                    [mx.nd.array(pred, ctx=mx.cpu())])
        elif wrap == "torch":
            args = ([torch.from_numpy(lab)], [torch.from_numpy(pred)])
        else:
            args = ([lab], [pred])
        tmet.update(*args)
    _close(_value(tmet), _value(jmet))
    assert tmet.num_inst == jmet.num_inst
    assert str(tmet) == str(jmet)
    for (tn, tv), (jn, jv) in zip(tmet.get_name_value(),
                                  jmet.get_name_value()):
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=RTOL, equal_nan=True)
    jmet.reset()
    tmet.reset()
    _close(_value(tmet), _value(jmet))


def test_composite_custom_and_registry():
    lab, pred = _batches("class", 5)[0]

    def feval(label, p):
        return float((p.argmax(-1) == label).sum()), len(label)
    jc = jm.create(["acc", "ce", feval])
    tc = tm.create(["acc", "ce", feval])
    assert isinstance(tc, tm.CompositeEvalMetric)
    for met, nd in ((jc, mxj.nd), (tc, None)):
        a = [nd.array(lab)] if nd else [mx.nd.array(lab, ctx=mx.cpu())]
        b = [nd.array(pred)] if nd else [mx.nd.array(pred, ctx=mx.cpu())]
        met.update(a, b)
    (jn, jv), (tn, tv) = jc.get(), tc.get()
    assert jn == tn
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    one = tm.CustomMetric(lambda lb, p: 0.5, name="half")
    one.update([lab], [pred])
    assert one.get() == jm.CustomMetric(lambda lb, p: 0.5,
                                        name="half").get()[:1] + (0.5,)
    acc = tm.Accuracy()
    assert tm.create(acc) is acc
    with pytest.raises(MXNetError, match="unknown metric"):
        tm.create("no-such-metric")

    @tm.register
    class Zero(tm.EvalMetric):
        def __init__(self, name="zero", **kw):
            super().__init__(name, **kw)

        def update(self, labels, preds):
            self.num_inst += 1
    assert isinstance(tm.create("zero"), Zero)
    assert sorted(tm.__all__) == sorted(jm.__all__)


def test_accuracy_over_an_epoch():
    """Accuracy over an epoch of NDArray batches equals the mean of the
    per-batch hit rates weighted by size, as in the JAX package."""
    rng = np.random.RandomState(9)
    met, want = tm.Accuracy(), tm.Accuracy()
    hits = n = 0
    for _ in range(5):
        lab = rng.randint(0, 10, 32).astype(np.float32)
        out = rng.randn(32, 10).astype(np.float32)
        met.update([mx.nd.array(lab, ctx=mx.cpu())],
                   [mx.nd.array(out, ctx=mx.cpu())])
        hits += (out.argmax(1) == lab).sum()
        n += 32
    assert met.get() == ("accuracy", hits / n)
    assert want.get()[0] == "accuracy" and math.isnan(want.get()[1])


SCHEDULERS = [
    ("Factor", lambda m: m.FactorScheduler(3, factor=0.5, base_lr=0.1)),
    ("FactorFloor", lambda m: m.FactorScheduler(
        2, factor=0.1, stop_factor_lr=1e-4, base_lr=1.0)),
    ("FactorWarm", lambda m: m.FactorScheduler(
        4, factor=0.9, base_lr=0.2, warmup_steps=5, warmup_begin_lr=0.01)),
    ("MultiFactor", lambda m: m.MultiFactorScheduler(
        [10, 4, 15], factor=0.3, base_lr=0.5)),
    ("MultiFactorWarm", lambda m: m.MultiFactorScheduler(
        [6, 12], factor=0.5, base_lr=0.5, warmup_steps=3,
        warmup_mode="constant")),
    ("Poly", lambda m: m.PolyScheduler(20, base_lr=0.3, pwr=2,
                                       final_lr=0.01)),
    ("PolyWarm", lambda m: m.PolyScheduler(20, base_lr=0.3, pwr=1,
                                           warmup_steps=4)),
    ("Cosine", lambda m: m.CosineScheduler(25, base_lr=0.4,
                                           final_lr=0.02)),
    ("CosineWarm", lambda m: m.CosineScheduler(
        25, base_lr=0.4, warmup_steps=6, warmup_begin_lr=0.1)),
    ("WarmUp", lambda m: m.WarmUpScheduler(
        m.CosineScheduler(20, base_lr=0.2), warmup_steps=5)),
]


@pytest.mark.parametrize("name,make", SCHEDULERS,
                         ids=[s[0] for s in SCHEDULERS])
def test_scheduler_matches_jax(name, make):
    j, t = make(jls), make(tls)
    assert [t(i) for i in range(40)] == [j(i) for i in range(40)]


def test_scheduler_errors_and_optimizer_hook():
    with pytest.raises(ValueError, match="warmup"):
        tls.WarmUpScheduler(tls.FactorScheduler(2, warmup_steps=3))
    with pytest.raises(NotImplementedError):
        tls.LRScheduler()(0)
    sched = tls.FactorScheduler(2, factor=0.5)
    opt = mx.optimizer.SGD(learning_rate=0.8, lr_scheduler=sched)
    assert sched.base_lr == 0.8
    seen = []
    for _ in range(5):
        seen.append(opt.learning_rate)
        opt.num_update += 1
    assert seen == [sched(i) for i in range(5)]
