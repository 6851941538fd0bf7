"""The ResNet slice on the CPU against the JAX package.

Ops: `convolution`, `pooling`, `global_pooling` and `batch_norm` of
`mxnet_tpu_torch.ops.nn_ops` against `mxnet_tpu.ops.nn_ops` in both
layouts, forward and backward (`jax.vjp` against `torch.autograd`).

Models: tiny ResNets (thumbnail stem, one block a stage, narrow
channels, 16 x 16 images, batch 2) hold seeded weights in `mxnet_tpu`,
are carried into the port by `convert.load_jax_parameters`, and are
trained one step in both packages on the same seeded numpy batch: the
train-mode logits and loss, every gradient, the running statistics, the
weights after one SGD step (momentum 0.9, wd 1e-4) and the eval-mode
logits agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ops import nn_ops as jn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import nn_ops as tn
from mxnet_tpu_torch.ops.kernels import LAUNCHES

CPU = mx.cpu()
# logits and loss: fp32 through a few layers in both packages (XLA vs
# ATen sum orders), the tolerance of tests/test_models.py:75
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# gradients and updated weights: the backward tolerance order of
# tests/test_pallas.py:209
BWD_TOL = dict(rtol=1e-3, atol=1e-5)


def _np(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _both(jax_fn, torch_fn, inputs, cot_seed=1):
    """Outputs and input gradients of both functions on the same numpy
    inputs, the gradient of sum(out * c) for a seeded cotangent c."""
    jout, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
    (cot,) = _np(jout.shape, seed=cot_seed)
    jgrads = vjp(jnp.asarray(cot))
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    tout = torch_fn(*tin)
    tgrads = torch.autograd.grad(tout, tin, torch.from_numpy(cot))
    return ((np.asarray(jout), tout.detach().numpy()),
            [(np.asarray(a), b.numpy()) for a, b in zip(jgrads, tgrads)])


def _assert_pairs(out, grads):
    np.testing.assert_allclose(out[1], out[0], **FWD_TOL)
    for want, got in grads:
        np.testing.assert_allclose(got, want, **BWD_TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad,bias", [(3, 2, 1, True),
                                               (1, 1, 0, False),
                                               (7, 2, 3, False)],
                         ids=["3x3s2", "1x1", "7x7s2"])
def test_convolution_matches_jax(layout, k, stride, pad, bias):
    cin, cout = 5, 6
    x_shape = (2, cin, 11, 12) if layout == "NCHW" else (2, 11, 12, cin)
    w_shape = (cout, cin, k, k) if layout == "NCHW" else (cout, k, k, cin)
    inputs = _np(x_shape, w_shape, (cout,))[:3 if bias else 2]

    def jfn(x, w, *b):
        return jn.convolution(x, w, b[0] if b else None, stride, pad,
                              layout=layout)

    def tfn(x, w, *b):
        return tn.convolution(x, w, b[0] if b else None, stride, pad,
                              layout=layout)
    out, grads = _both(jfn, tfn, inputs)
    _assert_pairs(out, grads)
    assert grads[1][1].shape == w_shape     # the stored weight layout


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,cip", [("max", True), ("avg", True),
                                           ("avg", False)],
                         ids=["max", "avg-pad", "avg-nopad"])
def test_pooling_matches_jax(layout, pool_type, cip):
    shape = (2, 3, 9, 10) if layout == "NCHW" else (2, 9, 10, 3)
    (x,) = _np(shape)
    out, grads = _both(
        lambda a: jn.pooling(a, 3, pool_type, 2, 1, layout, cip),
        lambda a: tn.pooling(a, 3, pool_type, 2, 1, layout, cip), [x])
    _assert_pairs(out, grads)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling_matches_jax(layout, pool_type):
    shape = (2, 3, 5, 4) if layout == "NCHW" else (2, 5, 4, 3)
    (x,) = _np(shape)
    out, grads = _both(
        lambda a: jn.global_pooling(a, pool_type, layout),
        lambda a: tn.global_pooling(a, pool_type, layout), [x])
    _assert_pairs(out, grads)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("offset", [0.0, 1e3], ids=["centred", "mean1e3"])
def test_batch_norm_matches_jax(layout, training, offset):
    """y, the new moving statistics, and the gradients of x, gamma and
    beta. With |mean| = 1e3 and std = 1 the moving mean sits 0.3 from
    the batch mean, as it does once it tracks it: the shifted one-pass
    variance must then hold float64's to 1e-4."""
    axis = 1 if layout == "NCHW" else 3
    c = 4
    shape = (3, c, 5, 6) if layout == "NCHW" else (3, 5, 6, c)
    x, gamma, beta = _np(shape, (c,), (c,))
    x = x + offset
    xm = np.moveaxis(x.astype(np.float64), axis, -1).reshape(-1, c)
    mm = (xm.mean(0) + 0.3 * (offset > 0)).astype(np.float32)
    mv = np.full(c, 1.5, np.float32)

    def jfn(a, g, b):
        return jn.batch_norm(a, g, b, jnp.asarray(mm), jnp.asarray(mv),
                             1e-5, 0.9, training, axis)

    def tfn(a, g, b):
        return tn.batch_norm(a, g, b, torch.from_numpy(mm),
                             torch.from_numpy(mv), 1e-5, 0.9, training,
                             axis)
    out, grads = _both(lambda *a: jfn(*a)[0], lambda *a: tfn(*a)[0],
                       [x, gamma, beta])
    _assert_pairs(out, grads)
    jstats = jfn(*map(jnp.asarray, (x, gamma, beta)))[1:]
    tstats = tfn(*map(torch.from_numpy, (x, gamma, beta)))[1:]
    for want, got in zip(jstats, tstats):
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if training:
        var64 = xm.var(0)
        new_var = 0.9 * mv + 0.1 * var64
        np.testing.assert_allclose(tstats[1].numpy(), new_var, rtol=1e-4)


def test_pooling_refuses_what_it_does_not_port():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(MXNetError, match="2-D"):
        tn.pooling(torch.zeros(1, 2, 4), 2, layout="NCW")
    with pytest.raises(MXNetError, match="half"):
        tn.pooling(x, 2, "max", 1, 2)
    with pytest.raises(MXNetError, match="pool_type"):
        tn.pooling(x, 2, "sum")


# ---------------------------------------------------------------------------
# tiny ResNets through Gluon, JAX package vs port
# ---------------------------------------------------------------------------
B, HW, CLASSES = 2, 16, 10
TINY = {
    "v1-bottleneck": (1, "bottle_neck", [1, 1, 1, 1], [8, 16, 32, 64, 128]),
    "v2-basic": (2, "basic_block", [1, 1, 1, 1], [8, 8, 16, 32, 64]),
}


def _build(pkg_res, version, block, layers, channels, layout):
    net_cls = pkg_res.resnet_net_versions[version - 1]
    block_cls = pkg_res.resnet_block_versions[version - 1][block]
    return net_cls(block_cls, layers, channels, classes=CLASSES,
                   thumbnail=True, layout=layout)


def _batch(layout):
    rng = np.random.RandomState(0)
    shape = (B, 3, HW, HW) if layout == "NCHW" else (B, HW, HW, 3)
    return (rng.rand(*shape).astype(np.float32),
            rng.randint(0, CLASSES, B).astype(np.int32))


def _run(pkg, net, x, y, arr):
    """One recorded forward, backward and SGD step, then an eval-mode
    forward: (logits, loss, grads, stats after the forward, weights
    after the step, eval logits)."""
    xb, yb = arr(x), arr(y)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        logits = net(xb)
        loss = ce(logits, yb).mean()
    loss.backward()
    params = net._collect_params_with_prefix()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    stats = {n: p.data().asnumpy() for n, p in params.items()
             if n.endswith(("running_mean", "running_var"))}
    trainer.step(B)
    weights = {n: p.data().asnumpy() for n, p in params.items()}
    return (logits.asnumpy(), float(loss.asnumpy()), grads, stats, weights,
            net(xb).asnumpy())


def _seeded_weights(net, x, seed):
    """numpy weights for every parameter of `net` (a port model; one CPU
    forward gives the deferred shapes): He-scaled normal weights, gamma
    near 1, small beta and bias, running statistics at their init."""
    net.initialize(ctx=CPU)
    net(mx.nd.array(x, ctx=CPU))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        s = p.shape
        if name.endswith("running_mean"):
            a = np.zeros(s)
        elif name.endswith("running_var"):
            a = np.ones(s)
        elif name.endswith("gamma"):
            a = 1 + 0.1 * rng.randn(*s)
        elif name.endswith(("beta", "bias")):
            a = 0.1 * rng.randn(*s)
        else:
            a = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        arrays[name] = a.astype(np.float32)
    return arrays


@pytest.mark.parametrize("tiny,layout", [("v1-bottleneck", "NCHW"),
                                         ("v1-bottleneck", "NHWC"),
                                         ("v2-basic", "NCHW")])
def test_tiny_resnet_trains_like_jax(tiny, layout, tmp_path):
    """The JAX model holds seeded weights (hybridized: one compiled
    forward and backward, to keep the CPU time low); its save_parameters
    file goes into a fresh port model through load_jax_parameters."""
    version, block, layers, channels = TINY[tiny]
    x, y = _batch(layout)
    seeded = tmp_path / "seeded.npz"
    with open(seeded, "wb") as f:
        np.savez(f, **_seeded_weights(
            _build(tres, version, block, layers, channels, layout), x, 3))
    jnet = _build(jres, version, block, layers, channels, layout)
    jnet.load_parameters(str(seeded))
    jnet.hybridize()
    path = str(tmp_path / "tiny.params")
    jnet.save_parameters(path)
    arrays = dict(np.load(path))
    tnet = _build(tres, version, block, layers, channels, layout)
    mx.convert.load_jax_parameters(tnet, arrays, ctx=CPU)
    assert set(tnet._collect_params_with_prefix()) == set(arrays)

    want = _run(mxj, jnet, x, y, mxj.nd.array)
    got = _run(mx, tnet, x, y, lambda a: mx.nd.array(a, ctx=CPU))
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    np.testing.assert_allclose(got[1], want[1], **FWD_TOL)
    assert set(got[2]) == set(want[2]) and len(got[2]) > 0
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name], **BWD_TOL,
                                   err_msg=name)
    assert len(got[3]) == len(want[3]) > 0
    for name in want[3]:
        assert not np.array_equal(got[3][name], arrays[name]), name
        np.testing.assert_allclose(got[3][name], want[3][name], **FWD_TOL,
                                   err_msg=name)
    for name in want[4]:
        np.testing.assert_allclose(got[4][name], want[4][name], **BWD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[5], want[5], **FWD_TOL)
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("name", ["resnet50_v1", "resnet50_v2"])
def test_resnet50_structural_names_match_jax(name):
    """The full-width zoo models have the JAX package's structural names
    and declared shapes (no forward: deferred shapes stay 0 in both)."""
    jnet = mxj.gluon.model_zoo.vision.get_model(name, layout="NHWC")
    tnet = mx.gluon.model_zoo.vision.get_model(name, layout="NHWC")
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    assert list(tp) == list(jp)
    assert len(tp) == (267 if name == "resnet50_v1" else 259)
    for n in jp:
        assert tuple(tp[n].shape) == tuple(jp[n].shape), n
        assert tp[n].grad_req == jp[n].grad_req, n


def test_zoo_refuses_what_it_does_not_port():
    with pytest.raises(MXNetError, match="model store"):
        mx.gluon.model_zoo.vision.get_model("resnet18_v1", pretrained=True)
    with pytest.raises(MXNetError, match="space-to-depth stem.*NHWC"):
        mx.gluon.model_zoo.vision.resnet50_v1(layout="NCHW", stem_s2d=True)
    with pytest.raises(MXNetError, match="zoo"):
        mx.gluon.model_zoo.vision.get_model("vgg16")


def test_resnet_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                          tmp_path):
    """initialize() and load_parameters() default to mx.gpu(0): without a
    card they raise, and ctx=mx.cpu() is honoured."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = mx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=4,
                                              thumbnail=True)
    with pytest.raises(MXNetError, match="CUDA"):
        net.initialize()
    net.initialize(ctx=CPU)
    net(mx.nd.array(np.zeros((1, 3, 8, 8), np.float32), ctx=CPU))
    path = str(tmp_path / "r18.params")
    net.save_parameters(path)
    fresh = mx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=4,
                                                thumbnail=True)
    with pytest.raises(MXNetError, match="CUDA"):
        fresh.load_parameters(path)
    fresh.load_parameters(path, ctx=CPU)
    assert all(p.data().context.type == "cpu"
               for p in fresh.collect_params().values())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_relu_and_identity_match_jax(layout):
    """BatchNormReLU (training mode, running statistics moved) and
    Identity, port against the JAX layers on the same weights."""
    axis = 1 if layout == "NCHW" else 3
    shape = (2, 3, 4, 5) if layout == "NCHW" else (2, 4, 5, 3)
    (x,) = _np(shape)
    outs = []
    for pkg, arr in ((mxj, mxj.nd.array),
                     (mx, lambda a: mx.nd.array(a, ctx=CPU))):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.BatchNormReLU(axis=axis),
                pkg.gluon.nn.Identity())
        net.initialize(**({} if pkg is mxj else {"ctx": CPU}))
        with pkg.autograd.record():
            y = net(arr(x))
        mean = net[0].running_mean.data().asnumpy()
        outs.append((y.asnumpy(), mean))
    (jy, jmean), (ty, tmean) = outs
    assert (ty >= 0).all() and (ty == 0).any()
    np.testing.assert_allclose(ty, jy, **FWD_TOL)
    np.testing.assert_allclose(tmean, jmean, **FWD_TOL)
    assert np.abs(tmean).max() > 0
