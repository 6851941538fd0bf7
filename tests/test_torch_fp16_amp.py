"""float16 AMP (`amp.init("float16")`, MXNet's original AMP mode) on a
narrow BERT and a narrow TransformerNMT, in the port on the CPU against
the JAX package: one forward and backward, then three Trainer steps
with the `DynamicLossScaler` (the loss scaled by `amp.scale_loss`, the
Trainer unscaling, judging the overflow and moving the scale), on the
same weights (carried across by `convert.load_jax_parameters`) and the
same seeded numpy batch. Under float16 AMP every Dense runs in float16,
so the attention reaches the flash forms with float16 q / k / v and
LayerNorm its float16 form with fp32 gamma / beta (`_KEEP_FP32`); the
tied output projections promote the float16 activations and the fp32
embedding to fp32, as `jnp.einsum` does.

The BERT is `tests/test_torch_bf16_bert.py`'s (2 layers, units 128, 2
heads, S = 128, key lengths below S), held against its float64 forward
(`_bert_f64`). The NMT is `tests/test_torch_bf16_nmt.py`'s (2 + 2
layers, units 64, 4 heads, B = 3, S = 12), held against the same model
without AMP in fp32 (the port's, which `tests/test_torch_train.py`
holds to the JAX package's; fp32's rounding is 2^-13 of fp16's, so it
stands for the exact value at the scale this measures).

Tolerances, `tests/test_torch_fp16.py`'s rule at fp16's unit roundoff
(2^-11): each value's distance from the yardstick at most twice the JAX
package's plus one fp16 rounding of the yardstick's largest value, and
port vs JAX within FP16_TOL elementwise (`tests/test_pallas.py:80-84`'s
bf16 limit, 12.8 bf16 unit roundoffs, counted in fp16's: 0.00625). The
gradients are compared unscaled (divided by the loss scale). The loss
scales after each step, and so the skip decisions, must be equal. The
steps are SGD with momentum, linear in the gradient: three steps move a
weight by lr (3 + 2 mu + mu^2) gradients at most, each within FP16_TOL's
atol of the other package's, so the weights after them lie within
STEP_ATOL of each other.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import bert as jb
from mxnet_tpu.models import transformer as jt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import bert as tb
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops.kernels import LAUNCHES
import test_torch_bf16_bert as bert16
import test_torch_bf16_nmt as nmt16

CPU = mx.cpu()
FP16_TOL = dict(rtol=0.05 * 2.0 ** -3, atol=0.05 * 2.0 ** -3)
FLOOR = 2.0 ** -11
LR, MU, STEPS = 0.05, 0.9, 3
STEP_ATOL = LR * (3 + 2 * MU + MU ** 2) * FP16_TOL["atol"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x.astype("float32").asnumpy(), np.float64) \
        if hasattr(x, "asnumpy") else np.asarray(x, np.float64)


def _rule(port, jx, exact, what):
    port, jx, exact = (np.asarray(a, np.float64) for a in (port, jx, exact))
    np.testing.assert_allclose(port, jx, **FP16_TOL, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + FLOOR * np.abs(exact).max(), (what, dp, dj)


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    mx.amp.reset()
    mxj.amp.reset()


def _train(pkg, model, loss_fn):
    """amp.init("float16"), then STEPS recorded steps of `loss_fn()` (it
    returns (loss, outputs)): scale_loss, backward, Trainer.step(1) with
    SGD. Returns the first step's (loss, outputs, unscaled gradients),
    each step's (loss, loss scale after it) and the weights after the
    last."""
    pkg.amp.init("float16")
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": MU})
    first, seq = None, []
    for _ in range(STEPS):
        with pkg.autograd.record():
            loss, outs = loss_fn()
            scaled = pkg.amp.scale_loss(loss, trainer)
        scaled.backward()
        if first is None:
            scale = pkg.amp.scaler().loss_scale
            grads = {n: _np(p.grad()._data) / scale for n, p in
                     model._collect_params_with_prefix().items()}
            first = (float(loss.asnumpy()), outs, grads)
        trainer.step(1)
        seq.append((float(loss.asnumpy()), pkg.amp.scaler().loss_scale))
    weights = {n: _np(p.data()._data) for n, p in
               model._collect_params_with_prefix().items()}
    pkg.amp.reset()
    return first, seq, weights


def _compare(port, jax_, what):
    """The steps' loss scales equal, the losses and the weights after the
    last step within FP16_TOL and STEP_ATOL."""
    (_, tseq, tw), (_, jseq, jw) = port, jax_
    assert [s for _, s in tseq] == [s for _, s in jseq], (tseq, jseq)
    np.testing.assert_allclose([x for x, _ in tseq], [x for x, _ in jseq],
                               **FP16_TOL, err_msg=f"{what} losses")
    assert tseq[-1][0] < tseq[0][0], tseq
    for name, w in tw.items():
        np.testing.assert_allclose(w, jw[name], rtol=FP16_TOL["rtol"],
                                   atol=STEP_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------
weights = bert16.weights


def _bert_models(arrays):
    """The JAX and the port BERTForPretraining on `arrays`, fp32."""
    jm = jb.BERTForPretraining(jb.BERTModel(**bert16.NARROW))
    jm.load_parameters(arrays["path"])
    arrays = {k: v for k, v in arrays.items() if k != "path"}
    tm = tb.BERTForPretraining(tb.BERTModel(**bert16.NARROW))
    mx.convert.load_jax_parameters(tm, arrays, ctx=CPU)
    return jm, tm


def _bert_loss(pkg, model):
    a = bert16._arrays(pkg, bert16._batch())
    return lambda: (lambda r: (r[0], r[1:]))(bert16._loss(pkg, model, a))


def test_fp16_amp_bert_matches_jax_and_float64(weights):
    """A narrow BERT under float16 AMP: MLM logits fp32 (the tied
    projection promotes) and NSP logits float16 in both packages, the
    loss and all 38 gradients against float64 under the rule, then three
    SGD steps with the loss scaler: the same scales, losses and weights;
    no kernel launches on the CPU."""
    jm, tm = _bert_models(weights)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ref = bert16._f64(tm)
    port = _train(mx, tm, _bert_loss(mx, tm))
    jx = _train(mxj, jm, _bert_loss(mxj, jm))
    (tl, (tmlm, tnsp), tg), (jl, (jmlm, jnsp), jg) = port[0], jx[0]
    assert tmlm.dtype == np.float32 and jmlm.dtype == np.float32
    assert tnsp.dtype == np.float16 and jnsp.dtype == np.float16
    _rule(_np(tmlm._data), _np(jmlm._data), ref[1], "mlm logits")
    _rule(_np(tnsp._data), _np(jnsp._data), ref[2], "nsp logits")
    _rule(tl, jl, ref[0], "loss")
    assert len(tg) == 38
    for name in tg:
        _rule(tg[name], jg[name], ref[3][name], f"gradient of {name}")
    _compare(port, jx, "bert")
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


def test_fp16_amp_bert_runs_the_float16_forms(weights, monkeypatch):
    """Under float16 AMP the BERT's attention receives float16 q / k / v
    and its LayerNorms float16 x with fp32 gamma / beta (what the card's
    `*_f16` kernels take), forward and backward."""
    from mxnet_tpu_torch.ops import kernels as tk
    seen = {"attention": set(), "layer_norm": set()}
    fwd, ln = tk.flash_attention_fwd, tk.layer_norm_fwd

    def spy_fwd(q, k, v, *a, **kw):
        seen["attention"].add(str(q.dtype))
        return fwd(q, k, v, *a, **kw)

    def spy_ln(x, g, b, *a, **kw):
        seen["layer_norm"].add((str(x.dtype), str(g.dtype)))
        return ln(x, g, b, *a, **kw)
    monkeypatch.setattr(tk, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(tk, "layer_norm_fwd", spy_ln)
    _, tm = _bert_models(weights)
    mx.amp.init("float16")
    with mx.autograd.record():
        loss = _bert_loss(mx, tm)()[0]
    loss.backward()
    assert seen["attention"] == {"torch.float16"}
    assert ("torch.float16", "torch.float32") in seen["layer_norm"]
    assert all(np.isfinite(p.grad().asnumpy()).all()
               for p in tm.collect_params().values())


# ---------------------------------------------------------------------------
# TransformerNMT
# ---------------------------------------------------------------------------
@pytest.fixture
def nmt_models():
    """The JAX and the port TransformerNMT (fp32) on
    `tests/test_torch_bf16_nmt.py`'s weights: a JAX model's, its
    LayerNorm affines made random."""
    mxj.random.seed(11)
    jm = jt.TransformerNMT(nmt16.VOCAB, **nmt16.NARROW)
    jm.initialize(mxj.init.Normal(0.1))
    b = nmt16._batch()
    jm(*(mxj.nd.array(b[k]) for k in ("src", "tgt", "vl")))
    rng = np.random.RandomState(1)
    arrays = {}
    for name, p in jm._collect_params_with_prefix().items():
        value = p.data().asnumpy()
        if name.endswith(".gamma"):
            value = (1 + 0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif name.endswith(".beta"):
            value = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        p.set_data(mxj.nd.array(value))
        arrays[name] = value
    tm, ref = (tt.TransformerNMT(nmt16.VOCAB, **nmt16.NARROW)
               for _ in range(2))
    for m in (tm, ref):
        mx.convert.load_jax_parameters(m, arrays, ctx=CPU)
    return jm, tm, ref


def _nmt_loss(pkg, model):
    b = nmt16._batch()
    if pkg is mx:
        a = {k: mx.nd.array(v, ctx=CPU) for k, v in b.items()}
    else:
        a = {k: mxj.nd.array(v) for k, v in b.items()}
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def run():
        logits = model(a["src"], a["tgt"], a["vl"])
        loss = ce(logits.reshape((-1, nmt16.VOCAB)),
                  a["out"].reshape((-1,))).mean()
        return loss, (logits,)
    return run


def test_fp16_amp_nmt_matches_jax(nmt_models):
    """A narrow TransformerNMT under float16 AMP: fp32 logits in both
    packages, the loss and all 65 gradients against the fp32 model's
    under the rule, then three SGD steps with the loss scaler: the same
    scales, losses and weights; no kernel launches on the CPU."""
    jm, tm, ref = nmt_models
    with mx.autograd.record():
        rl, (rlog,) = _nmt_loss(mx, ref)()
    rl.backward()
    rgrads = {n: _np(p.grad()._data) for n, p in
              ref._collect_params_with_prefix().items()}
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    port = _train(mx, tm, _nmt_loss(mx, tm))
    jx = _train(mxj, jm, _nmt_loss(mxj, jm))
    (tl, (tlog,), tg), (jl, (jlog,), jg) = port[0], jx[0]
    assert tlog.dtype == np.float32 and jlog.dtype == np.float32
    _rule(_np(tlog._data), _np(jlog._data), _np(rlog._data), "logits")
    _rule(tl, jl, float(rl.asnumpy()), "loss")
    assert len(tg) == 65 and set(tg) == set(rgrads)
    for name in tg:
        _rule(tg[name], jg[name], rgrads[name], f"gradient of {name}")
    _compare(port, jx, "nmt")
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)
