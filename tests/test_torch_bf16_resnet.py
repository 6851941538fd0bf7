"""ResNet in bf16 with the space-to-depth stem, as bench.py builds it
(`resnet50_v1(layout="NHWC", stem_s2d=True)`, then `cast("bfloat16")`,
bench.py:226-228), on the CPU against the JAX package.

`ops.nn_ops.stem_conv_s2d` is held against the JAX package's and against
the plain 7x7 / stride-2 / pad-3 convolution, in fp32 (y and both
gradients within STEM_F32_TOL: the same products summed in another
order) and in bf16 (the rule below). A narrow `ResNetV1(BottleneckV1,
[1, 1, 1, 1], ...)` with the S2D stem (channels 16-256, 10 classes,
B=8 at 32 x 32) gets weights from numpy seed 1 (its BatchNorm affines
random too), through a save_parameters file into the JAX model
(hybridized: one compiled step) and through `convert.
load_jax_parameters` into the port's; both are cast to bf16, and
bench.py's step (the cross-entropy on logits cast to fp32, backward,
SGD lr 0.1 momentum 0.9 on the mean loss's gradient) runs 10 times in
both on the same seeded numpy batch: the state after two steps and the
10-step loss curves are compared.

The bf16 rule, as in tests/test_torch_bf16.py: each reading is also
taken in float64 (the port's model cast to float64 on the bf16 weights
and input, or the plain convolution in float64); the port's distance
from float64 must be at most twice the JAX package's plus one bf16 ulp
(2^-8 relative) of the largest float64 value, and for the stem port vs
JAX within rtol = atol = 0.05 elementwise (tests/test_pallas.py:80-84).
Through a whole bf16 ResNet at random weights, BatchNorm over few values
and the ReLU kinks amplify each rounding: the logits move up to about
0.16 from float64 in both packages (so no elementwise limit between
them), and a parameter's gradient 3-56 % in norm. Which package lands
nearer float64 on one small tensor (the 10 output biases) is then
chance, so each gradient, weight and running statistic is held in norm
against twice the larger of the JAX package's distance for it and the
median of the JAX package's distances over its kind, plus the floor, as
`chip_smoke.py` holds the bf16 ResNet on the card against the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.ops import nn_ops as jnn_ops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn_ops

CPU = mx.cpu()
STEM_F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)     # tests/test_pallas.py:80-84
FLOOR = 2.0 ** -8
B, HW, CLASSES = 8, 32, 10
CHANNELS = [16, 32, 64, 128, 256]
LR, MU = 0.1, 0.9


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _rule(port, jx, exact, what, elementwise=True):
    """The bf16 rule of the module docstring in max abs, with port vs JAX
    elementwise (`elementwise`) or without."""
    port, jx, exact = _np(port), _np(jx), np.asarray(exact, np.float64)
    if elementwise:
        np.testing.assert_allclose(port, jx, **BF16_TOL, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + FLOOR * np.abs(exact).max(), (what, dp, dj)


def _rule_by_kind(port, jx, exact, kind):
    """The norm form of the rule over {name: array} of one kind: each
    port distance from float64 (relative to the float64 norm) at most
    twice the larger of JAX's for that name and JAX's median, plus the
    floor."""
    def rel(a, n):
        return np.linalg.norm(a[n] - exact[n]) / max(
            np.linalg.norm(exact[n]), 1e-30)
    dj = {n: rel(jx, n) for n in exact}
    median = float(np.median(list(dj.values())))
    for n in exact:
        dp = rel(port, n)
        assert dp <= 2 * max(dj[n], median) + FLOOR, (kind, n, dp, dj[n],
                                                       median)


def _stem_inputs(seed, n=2, hw=16, c=3, o=8):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, hw, hw, c).astype(np.float32),
            (0.2 * rng.randn(o, 7, 7, c)).astype(np.float32),
            rng.randn(n, hw // 2, hw // 2, o).astype(np.float32))


@pytest.mark.parametrize("hw,c", [(16, 3), (12, 5)])
def test_stem_s2d_fp32_matches_jax_and_the_plain_convolution(hw, c):
    """y, dx and dw of sum(y * dy) through the S2D stem against the JAX
    package's `stem_conv_s2d` and the port's plain 7x7 convolution."""
    import jax
    x, w, dy = _stem_inputs(0, hw=hw, c=c)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    y = nn_ops.stem_conv_s2d(tx, tw)
    (y * torch.from_numpy(dy)).sum().backward()
    px, pw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    yp = nn_ops.convolution(px, pw, None, 2, 3, layout="NHWC")
    (yp * torch.from_numpy(dy)).sum().backward()
    jy, jvjp = jax.vjp(jnn_ops.stem_conv_s2d, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jvjp(jnp.asarray(dy))
    assert y.shape == yp.shape == (2, hw // 2, hw // 2, 8)
    for got, plain, ref in ((y, yp, jy), (tx.grad, px.grad, jdx),
                            (tw.grad, pw.grad, jdw)):
        np.testing.assert_allclose(_np(got), _np(ref), **STEM_F32_TOL)
        np.testing.assert_allclose(_np(got), _np(plain), **STEM_F32_TOL)


def test_stem_s2d_bf16_matches_jax_under_the_rule():
    """The S2D stem on bf16 x and w: y (bf16) and the bf16 weight
    gradient against JAX's and float64 under the bf16 rule; the weight
    gradient comes back through the repack to the (O, 7, 7, C) shape."""
    import jax
    x, w, dy = (_bf16(a) for a in _stem_inputs(1))
    tw = torch.tensor(w).to(torch.bfloat16).requires_grad_()
    y = nn_ops.stem_conv_s2d(torch.tensor(x).to(torch.bfloat16), tw)
    y.backward(torch.tensor(dy).to(torch.bfloat16))
    jy, jvjp = jax.vjp(lambda a: jnn_ops.stem_conv_s2d(
        jnp.asarray(x, jnp.bfloat16), a), jnp.asarray(w, jnp.bfloat16))
    (jdw,) = jvjp(jnp.asarray(dy, jnp.bfloat16))
    w64 = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    y64 = nn_ops.convolution(torch.tensor(x, dtype=torch.float64), w64,
                             None, 2, 3, layout="NHWC")
    y64.backward(torch.tensor(dy, dtype=torch.float64))
    assert y.dtype == tw.grad.dtype == torch.bfloat16
    assert tw.grad.shape == (8, 7, 7, 3)
    _rule(y, jy, y64.detach().numpy(), "y")
    _rule(tw.grad, jdw, w64.grad.numpy(), "dw")


def test_stem_s2d_and_the_zoo_refuse_what_jax_refuses():
    """Odd spatial sizes raise ValueError in both packages; the S2D stem
    with NCHW raises MXNetError where JAX asserts."""
    x = torch.zeros((1, 15, 16, 3))
    with pytest.raises(ValueError, match="even spatial dims"):
        nn_ops.stem_conv_s2d(x, torch.zeros((4, 7, 7, 3)))
    with pytest.raises(ValueError, match="even spatial dims"):
        jnn_ops.stem_conv_s2d(jnp.zeros((1, 15, 16, 3)),
                              jnp.zeros((4, 7, 7, 3)))
    with pytest.raises(MXNetError, match="needs layout NHWC"):
        mx.gluon.model_zoo.vision.resnet50_v1(layout="NCHW", stem_s2d=True)
    with pytest.raises(AssertionError, match="NHWC"):
        mxj.gluon.model_zoo.vision.resnet50_v1(layout="NCHW", stem_s2d=True)


def test_resnet50_s2d_names_match_jax():
    """`resnet50_v1(layout="NHWC", stem_s2d=True)`: the JAX package's 267
    structural names and declared shapes, the stem an `S2DStemConv` with
    the 7x7 stem's (64, 7, 7, 3) weight (no forward)."""
    vision, jvision = mx.gluon.model_zoo.vision, mxj.gluon.model_zoo.vision
    tnet = vision.resnet50_v1(layout="NHWC", stem_s2d=True)
    jnet = jvision.resnet50_v1(layout="NHWC", stem_s2d=True)
    tp = tnet._collect_params_with_prefix()
    jp = jnet._collect_params_with_prefix()
    assert list(tp) == list(jp) and len(tp) == 267
    for n in jp:
        assert tuple(tp[n].shape) == tuple(jp[n].shape), n
    assert isinstance(tnet.features[0], vision.S2DStemConv)
    assert tuple(tp["features.0.weight"].shape) == (64, 7, 7, 3)


def _narrow(pkg):
    vision = pkg.gluon.model_zoo.vision
    return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                           classes=CLASSES, layout="NHWC", stem_s2d=True)


def _batch():
    rng = np.random.RandomState(0)
    return (_bf16(rng.rand(B, HW, HW, 3)),
            rng.randint(0, CLASSES, B).astype(np.int32))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Weights for every structural name of the narrow net from numpy
    seed 1 (the shapes from one forward of the port's): He-normal
    convolution and Dense weights, random BatchNorm gammas and betas,
    running statistics 0 and 1; as numpy and in a save_parameters file
    for the JAX model."""
    net = _narrow(mx)
    net.initialize(ctx=CPU)
    net(mx.nd.array(_batch()[0], ctx=CPU))
    rng = np.random.RandomState(1)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        shape = tuple(p.shape)
        if name.endswith(".gamma"):
            a = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith((".beta", "bias")):
            a = 0.1 * rng.randn(*shape)
        elif name.endswith("running_mean"):
            a = np.zeros(shape)
        elif name.endswith("running_var"):
            a = np.ones(shape)
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        arrays[name] = a.astype(np.float32)
    path = str(tmp_path_factory.mktemp("resnet_bf16") / "narrow.params")
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return arrays, path


def _build(pkg, weights, dtype):
    """The narrow net on `weights` cast to bf16 (then to float64 for the
    reference); the JAX one hybridized (one compiled step)."""
    arrays, path = weights
    net = _narrow(pkg)
    if pkg is mx:
        mx.convert.load_jax_parameters(net, arrays, ctx=CPU)
    else:
        net.load_parameters(path)
        net.hybridize()
    net.cast("bfloat16")
    if dtype == "float64":
        net.cast("float64")
    return net


BENCH_STEPS = 10


def _train(pkg, net, dtype, steps=BENCH_STEPS, keep=2):
    """bench.py's step `steps` times: (logits and loss of the first step,
    its gradients), the weights and running statistics after step
    `keep`, and every step's loss."""
    x, y = _batch()
    if pkg is mx:
        xa = mx.nd.array(x, ctx=CPU, dtype=dtype)
        ya = mx.nd.array(y, ctx=CPU)
    else:
        xa, ya = mxj.nd.array(x).astype(dtype), mxj.nd.array(y)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": MU})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    out = "float64" if dtype == "float64" else "float32"
    first, kept, losses = None, None, []
    params = net._collect_params_with_prefix()
    for k in range(steps):
        with pkg.autograd.record():
            logits = net(xa)
            loss = ce(logits.astype(out), ya).mean()
        loss.backward()
        losses.append(float(loss.asnumpy()))
        if first is None:
            first = (_np(logits._data), losses[0],
                     {n: _np(p.grad()._data) for n, p in params.items()
                      if p.grad_req != "null"})
        trainer.step(1)
        if k + 1 == keep:
            kept = {n: _np(p.data()._data) for n, p in params.items()}
    return first, kept, np.asarray(losses)


@pytest.fixture(scope="module")
def runs(weights):
    """bench.py's 10 steps on the cast narrow net in the port, the JAX
    package and the port in float64: {"port" | "jax" | "f64": (first
    step, state after two steps, loss curve)}; the port's model kept to
    check its dtypes."""
    tnet = _build(mx, weights, "bfloat16")
    for n, p in tnet._collect_params_with_prefix().items():
        assert p.data()._data.dtype == torch.bfloat16, n
    return {"port": _train(mx, tnet, "bfloat16"),
            "jax": _train(mxj, _build(mxj, weights, "bfloat16"),
                          "bfloat16"),
            "f64": _train(mx, _build(mx, weights, "float64"), "float64")}


def test_narrow_s2d_resnet_in_bf16_matches_jax(weights, runs):
    """The cast narrow S2D ResNet: every parameter bf16; the bf16 logits
    and the loss under the bf16 rule, the 53 gradients of the first step
    and every weight and running statistic after two steps under its
    norm form by kind; the training moved every parameter."""
    (tlog, tloss, tg), tw, _ = runs["port"]
    (jlog, jloss, jg), jw, _ = runs["jax"]
    (rlog, rloss, rg), rw, _ = runs["f64"]
    _rule(tlog, jlog, rlog, "logits", elementwise=False)
    _rule(np.float64(tloss), np.float64(jloss), rloss, "loss",
          elementwise=False)
    assert len(tg) == 53 and set(tg) == set(jg) == set(rg)
    _rule_by_kind(tg, jg, rg, "gradient")
    stats = [n for n in rw if "running" in n]
    for kind, names in (("weight", [n for n in rw if n not in stats]),
                        ("running statistic", stats)):
        _rule_by_kind(*({n: d[n] for n in names} for d in (tw, jw, rw)),
                      kind)
    moved = [n for n in rw if not np.array_equal(tw[n], _np(
        torch.from_numpy(weights[0][n]).to(torch.bfloat16)))]
    assert len(moved) == len(rw)


def test_ten_bench_steps_loss_curves_agree(runs):
    """ROADMAP Queue 3 item 12: bench.py's SGD (lr 0.1, momentum 0.9, no
    wd, the mean loss's gradient) for 10 steps from the same weights.
    The port's bf16 loss curve is held against float64 in norm, at most
    twice the JAX package's distance plus the floor (a bf16 run's
    trajectory leaves float64's within a few steps, in both packages).
    Both bf16 curves rise at some step, as the JAX package's does: the
    rise of `chip_smoke.py` phase 7b's loss is this optimizer's
    behaviour at lr 0.1, not a fault of the port."""
    t, j, r = (runs[k][2] for k in ("port", "jax", "f64"))
    print(f"loss curves: port {np.round(t, 4).tolist()}, JAX "
          f"{np.round(j, 4).tolist()}, float64 {np.round(r, 4).tolist()}")
    assert len(t) == len(j) == len(r) == BENCH_STEPS
    assert np.all(np.isfinite(t)) and np.all(np.isfinite(j))
    dp, dj = np.linalg.norm(t - r), np.linalg.norm(j - r)
    assert dp <= 2 * dj + FLOOR * np.linalg.norm(r), (dp, dj)
    assert np.any(np.diff(j) > 0) and np.any(np.diff(t) > 0)
