"""The BERT slice on the CPU against the JAX package: a tiny
`BERTForPretraining` (vocab 64, units 128, hidden 256, 2 layers, 2 heads,
S = 32, dropout 0) is built by `mxnet_tpu`, its `save_parameters` file
(with random learned positions, MLM bias and LayerNorm affines written
in, so none of them is a zero or a one) is loaded into the port's model,
and the Gluon loop of examples/bert_pretrain.py (record, the MLM and NSP
SoftmaxCrossEntropyLoss, backward, Trainer.step with Adam) runs in both
packages on the same seeded numpy batch, with key lengths of 1 and
more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import bert as jb
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import bert as tb
from mxnet_tpu_torch.ops.kernels import LAUNCHES

CPU = mx.cpu()
VOCAB, B, S, P = 64, 3, 32, 5
TINY = dict(vocab_size=VOCAB, units=128, hidden_size=256, num_layers=2,
            num_heads=2, max_length=S, dropout=0.0)
# the tolerances of tests/test_torch_train.py:23,26: fp32 through a few
# layers on the CPU in both packages (XLA vs ATen sum orders) for
# outputs and the loss, and for gradients and updated weights
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch():
    rng = np.random.RandomState(0)
    return dict(tok=rng.randint(0, VOCAB, (B, S)).astype(np.int32),
                seg=rng.randint(0, 2, (B, S)).astype(np.int32),
                vl=np.array([S, 1, 17], np.int32),
                pos=rng.randint(0, S, (B, P)).astype(np.int32),
                mlm_y=rng.randint(0, VOCAB, (B, P)).astype(np.int32),
                nsp_y=rng.randint(0, 2, (B,)).astype(np.int32),
                y=rng.randn(B, 1).astype(np.float32))


def _arrays(pkg, batch):
    if pkg is mx:
        return {k: mx.nd.array(v, ctx=CPU) for k, v in batch.items()}
    return {k: mxj.nd.array(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX BERTForPretraining's save_parameters file, its position
    weights, MLM bias and LayerNorm gamma / beta made random."""
    mxj.random.seed(5)
    m = jb.BERTForPretraining(jb.BERTModel(**TINY))
    m.initialize(mxj.init.Normal(0.05))
    a = _arrays(mxj, _batch())
    m(a["tok"], a["seg"], a["vl"], a["pos"])
    path = str(tmp_path_factory.mktemp("bert") / "bert.params")
    m.save_parameters(path)
    arrays = dict(np.load(path))
    rng = np.random.RandomState(1)
    for name, value in arrays.items():
        if name.endswith(("position_weight", "mlm_bias", ".beta")):
            arrays[name] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif name.endswith(".gamma"):
            arrays[name] = (1 + 0.1 * rng.randn(*value.shape)).astype(
                np.float32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def _models(path):
    """The JAX and the port BERTForPretraining on the weights in
    `path`."""
    jm = jb.BERTForPretraining(jb.BERTModel(**TINY))
    jm.load_parameters(path)
    tm = tb.BERTForPretraining(tb.BERTModel(**TINY))
    tm.load_parameters(path, ctx=CPU)
    return jm, tm


def _pretrain_loss(pkg, model, a):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    mlm, nsp = model(a["tok"], a["seg"], a["vl"], a["pos"])
    return ce(mlm.reshape((-1, VOCAB)), a["mlm_y"].reshape((-1,))).mean() \
        + ce(nsp, a["nsp_y"]).mean()


def _train(pkg, model, steps, lr):
    """examples/bert_pretrain.py's loop with Adam; returns the losses."""
    a = _arrays(pkg, _batch())
    trainer = pkg.gluon.Trainer(model.collect_params(), "adam",
                                {"learning_rate": lr})
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = _pretrain_loss(pkg, model, a)
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.asnumpy()))
    return losses


def _by_name(model, what):
    return {n: getattr(p, what)().asnumpy() for n, p in
            model._collect_params_with_prefix().items()}


def test_structural_names_and_shapes_match_jax(weights):
    """bert_base under the pretraining heads has the JAX package's 158
    structural names with the same shapes, the tiny model 38; the JAX
    file loads with every value exact."""
    for jm, tm, n in (
            (jb.BERTForPretraining(jb.bert_base(max_length=512)),
             tb.BERTForPretraining(tb.bert_base(max_length=512)), 158),
            (*_models(weights), 38)):
        want = {k: p.shape for k, p in
                jm._collect_params_with_prefix().items()}
        got = {k: p.shape for k, p in
               tm._collect_params_with_prefix().items()}
        assert len(got) == n and got == want
    assert got["bert.encoder.position_weight"] == (S, 128)
    arrays = dict(np.load(weights))
    for name, value in _by_name(tm, "data").items():
        np.testing.assert_array_equal(value, arrays[name])
    with pytest.raises(mx.MXNetError, match="missing"):
        mx.convert.load_jax_parameters(
            tb.BERTForPretraining(tb.BERTModel(**TINY)),
            {k: v for k, v in arrays.items() if k != "bert.mlm_bias"},
            ctx=CPU)


def test_pretraining_outputs_match_jax(weights):
    """seq, pooled and the MLM scores of BERTModel, and the NSP scores,
    agree with the JAX model; a length-1 row included."""
    jm, tm = _models(weights)
    ja, ta = _arrays(mxj, _batch()), _arrays(mx, _batch())
    want = jm.bert(ja["tok"], ja["seg"], ja["vl"], ja["pos"])
    got = tm.bert(ta["tok"], ta["seg"], ta["vl"], ta["pos"])
    for name, g, w, shape in zip(("seq", "pooled", "mlm"), got, want,
                                 ((B, S, 128), (B, 128), (B, P, VOCAB))):
        assert g.shape == shape, name
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **FWD_TOL,
                                   err_msg=name)
    seq, pooled = tm.bert(ta["tok"], ta["seg"], ta["vl"])
    np.testing.assert_allclose(pooled.asnumpy(), want[1].asnumpy(),
                               **FWD_TOL)
    nsp = tm(ta["tok"], ta["seg"], ta["vl"], ta["pos"])[1]
    np.testing.assert_allclose(
        nsp.asnumpy(), jm(ja["tok"], ja["seg"], ja["vl"], ja["pos"])[1]
        .asnumpy(), **FWD_TOL)


def test_loss_and_every_gradient_match(weights):
    """The MLM + NSP loss and all 38 gradients, the tied word embedding
    (gathered rows and the MLM projection) included."""
    jm, tm = _models(weights)
    want = _train(mxj, jm, 1, 0.0)
    got = _train(mx, tm, 1, 0.0)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_g, got_g = _by_name(jm, "grad"), _by_name(tm, "grad")
    assert got_g.keys() == want_g.keys() and len(got_g) == 38
    for name in want_g:
        assert np.abs(want_g[name]).max() > 0, name
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)
    # every vocabulary row gets gradient through the projection, not only
    # the rows the batch gathers
    assert np.all(np.abs(got_g["bert.word_embed.weight"]).sum(1) > 0)


def test_two_adam_steps_match(weights):
    """Losses and every weight after two Adam steps at the example's
    learning rate (1e-4); no kernel is launched on the CPU.

    The key third of each fused qkv bias has zero gradient in exact
    arithmetic: a bias on the keys adds q.b to every score of a query
    row, which the softmax removes. Its computed gradient is round-off
    (about 1e-9 against 1e-2 for the rest of the bias) in both packages,
    and Adam divides a gradient by its own size, so each package moves
    those entries by about lr a step in a direction round-off picks.
    They are held to that: gradient at round-off in both packages, each
    weight within steps * lr of its start. Every other weight is held to
    GRAD_TOL."""
    lr, steps, units = 1e-4, 2, TINY["units"]
    jm, tm = _models(weights)
    start = _by_name(tm, "data")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    want = _train(mxj, jm, steps, lr)
    got = _train(mx, tm, steps, lr)
    assert got[1] < got[0]
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_w, got_w = _by_name(jm, "data"), _by_name(tm, "data")
    grads = (_by_name(jm, "grad"), _by_name(tm, "grad"))
    key_bias = slice(units, 2 * units)
    for name, value in got_w.items():
        if name.endswith("attention.qkv.bias"):
            for g in grads:
                assert np.abs(g[name][key_bias]).max() \
                    < 1e-6 * np.abs(g[name]).max(), name
            for w in (value, want_w[name]):
                assert np.abs(w[key_bias] - start[name][key_bias]).max() \
                    <= steps * lr * (1 + 1e-3), name
            value, ref = (np.delete(a, key_bias) for a in
                          (value, want_w[name]))
        else:
            ref = want_w[name]
        np.testing.assert_allclose(value, ref, **GRAD_TOL, err_msg=name)
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


@pytest.mark.parametrize("head,kw,label", [
    ("BERTClassifier", {"num_classes": 3}, "nsp_y"),
    ("BERTRegression", {}, "y"),
])
def test_classifier_and_regression_match(tmp_path, head, kw, label):
    """Each fine-tuning head, built and initialised by the JAX package
    and carried across by file: its output and the gradient of every
    parameter under a softmax-CE (classifier) or L2 (regression) loss."""
    mxj.random.seed(6)
    jm = getattr(jb, head)(jb.BERTModel(**TINY), dropout=0.0, **kw)
    jm.initialize(mxj.init.Normal(0.05))
    a = _arrays(mxj, _batch())
    jm(a["tok"], a["seg"], a["vl"])
    path = str(tmp_path / "head.params")
    jm.save_parameters(path)
    tm = getattr(tb, head)(tb.BERTModel(**TINY), dropout=0.0, **kw)
    tm.load_parameters(path, ctx=CPU)
    outs, grads = [], []
    for pkg, model in ((mxj, jm), (mx, tm)):
        a = _arrays(pkg, _batch())
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss() \
            if head == "BERTClassifier" else pkg.gluon.loss.L2Loss()
        with pkg.autograd.record():
            out = model(a["tok"], a["seg"], a["vl"])
            loss = loss_fn(out, a[label]).mean()
        loss.backward()
        outs.append(out.asnumpy())
        grads.append(_by_name(model, "grad"))
    assert outs[1].shape == (B, kw.get("num_classes", 1))
    np.testing.assert_allclose(outs[1], outs[0], **FWD_TOL)
    assert grads[1].keys() == grads[0].keys() and len(grads[1]) == 38
    for name, want in grads[0].items():
        np.testing.assert_allclose(grads[1][name], want, **GRAD_TOL,
                                   err_msg=name)


def test_get_bert_spec_table():
    """get_bert builds each spec of the table (bert_large: 24 layers of
    1024 units, 16 heads), and an unknown name raises MXNetError."""
    large = tb.bert_large(vocab_size=100, max_length=8)
    names = large._collect_params_with_prefix()
    assert len(large.encoder.layers) == 24
    assert names["encoder.layers.23.ffn.ffn1.weight"].shape == (4096, 1024)
    assert large.encoder.layers[0].attention._num_heads == 16
    assert tb.get_bert("bert_12_768_12", vocab_size=100)._units == 768
    with pytest.raises(mx.MXNetError, match="unknown bert spec"):
        tb.get_bert("bert_6_512_8")


@pytest.mark.parametrize("act,approximate", [("gelu", True),
                                             ("erf_gelu", False)])
def test_gelu_forms_match_jax(act, approximate):
    """nd.Activation's "gelu" is the tanh approximation and "erf_gelu"
    the exact form, as `jax.nn.gelu(approximate=...)`."""
    x = np.random.RandomState(3).randn(4, 257).astype(np.float32) * 3
    got = mx.nd.Activation(mx.nd.array(x, ctx=CPU), act_type=act).asnumpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approximate))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    other = np.asarray(jax.nn.gelu(jnp.asarray(x),
                                   approximate=not approximate))
    assert np.abs(got - other).max() > 1e-4


def test_slice_axis_matches_jax():
    x = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    for axis, begin, end in ((1, 0, 1), (2, 1, None), (0, 1, 3)):
        got = mx.nd.array(x, ctx=CPU).slice_axis(axis, begin, end)
        want = mxj.nd.array(x).slice_axis(axis, begin, end)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
