"""MLP-on-MNIST (BASELINE.json configuration #1, `examples/train_mnist.py`'s
flow) on the CPU, the port against the JAX package: `models.get_mlp` at
narrow widths (784-64-32-10) built by `mxnet_tpu`, its `save_parameters`
file loaded by the port's net, then five SGD steps (lr 0.1, momentum
0.9, as `bench_mlp.py` and the example train) on batches of synthetic
MNIST from each package's `DataLoader(shuffle=True)` after the same
numpy seed, with `Accuracy` updated each step. Losses and every
parameter after the five steps within FWD_TOL / PARAM_TOL
(`tests/test_torch_train.py`'s limits: fp32 sums in another order, five
momentum steps deep); the accuracy counts exactly. Also the captured
step (`Trainer.capture`, run eagerly on the CPU) from the same weights
bit for bit against the eager fused step."""
import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models.mlp import get_mlp as jax_get_mlp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

CPU = mx.cpu()
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
HIDDEN = (64, 32)
STEPS, BATCH = 5, 32


def _loader(mod, **ctx):
    ds = mod.gluon.data.vision.MNIST(train=True).take(STEPS * BATCH)
    ds = ds.transform_first(lambda x: x.astype("float32") / 255.0)
    np.random.seed(17)
    return list(mod.gluon.data.DataLoader(ds, batch_size=BATCH,
                                          shuffle=True, **ctx))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's five steps: (params file, losses, accuracy,
    final parameters by structural name)."""
    mxj.random.seed(3)
    net = jax_get_mlp(HIDDEN)
    net.initialize(mxj.init.Xavier())
    batches = _loader(mxj)
    net(batches[0][0])
    path = str(tmp_path_factory.mktemp("mlp") / "mlp.params")
    net.save_parameters(path)
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    lf = jgluon.loss.SoftmaxCrossEntropyLoss()
    acc = mxj.metric.Accuracy()
    losses = []
    for x, y in batches:
        with jag.record():
            out = net(x)
            loss = lf(out, y)
        loss.backward()
        tr.step(x.shape[0])
        acc.update([y], [out])
        losses.append(float(loss.mean().asscalar()))
    final = {k: p.data().asnumpy() for k, p in
             net._collect_params_with_prefix().items()}
    return path, losses, acc.get(), final


def _port_net(path):
    net = mx.models.get_mlp(HIDDEN)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.load_parameters(path, ctx=CPU)
    return net


def test_five_sgd_steps_match_jax(jax_run):
    path, want_losses, want_acc, want = jax_run
    net = _port_net(path)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = mx.metric.Accuracy()
    losses = []
    for x, y in _loader(mx, ctx=CPU):
        assert x.shape == (BATCH, 28, 28, 1) and x.context.type == "cpu"
        with autograd.record():
            out = net(x)
            loss = lf(out, y)
        loss.backward()
        tr.step(x.shape[0])
        acc.update([y], [out])
        losses.append(float(loss.mean().asscalar()))
    np.testing.assert_allclose(losses, want_losses, **FWD_TOL)
    assert acc.get() == want_acc
    got = {k: p.data().asnumpy() for k, p in
           net._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(want) and len(got) == 6
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **PARAM_TOL,
                                   err_msg=name)
    assert losses[-1] < losses[0]


def test_captured_steps_equal_eager(jax_run):
    """`trainer.capture` of the same step (on the CPU the captured
    program runs eagerly) gives the eager fused steps' losses and
    weights bit for bit."""
    path = jax_run[0]
    runs = []
    for captured in (False, True):
        net = _port_net(path)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        lf = gluon.loss.SoftmaxCrossEntropyLoss()
        step = tr.capture(lambda x, y: lf(net(x), y)) if captured else None
        losses = []
        for x, y in _loader(mx, ctx=CPU):
            if captured:
                loss = step(x, y)
                assert step.last_fallback_reason is None
            else:
                with autograd.record():
                    loss = lf(net(x), y)
                loss.backward()
                tr.step(x.shape[0])
            losses.append(loss.asnumpy())
        runs.append((losses, [p.data().asnumpy() for p in
                              net._collect_params_with_prefix().values()]))
    (le, we), (lc, wc) = runs
    for a, b in zip(le + we, lc + wc):
        np.testing.assert_array_equal(a, b)


def test_get_mlp_names_match_jax():
    jn = jax_get_mlp((512, 256))
    tn = mx.models.get_mlp((512, 256))
    jn.initialize()
    jn(mxj.nd.array(np.zeros((1, 784), np.float32)))
    tn.initialize(ctx=CPU)
    tn(mx.nd.array(np.zeros((1, 784), np.float32), ctx=CPU))
    jp = {k: p.shape for k, p in jn._collect_params_with_prefix().items()}
    tp = {k: tuple(p.shape) for k, p in
          tn._collect_params_with_prefix().items()}
    assert tp == jp
    assert tp["0.weight"] == (512, 784) and tp["2.bias"] == (10,)
    assert tn.prefix == jn.prefix == "mlp_"
