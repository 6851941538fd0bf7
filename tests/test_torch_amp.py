"""`mx.amp` of the port on the CPU against the JAX package's
(`tests/test_amp.py`'s thirteen cases, each run on the port and, where
the JAX package gives a value, held against it): `convert_block`'s dtype
for every structural name, the op-level autocast of Dense (its output's
dtype and values on the same seeded weights and inputs), the
`DynamicLossScaler` sequences, loss scaling and unscaling, overflow
detection, and the Trainer's skip / halve protocol for `step()` and
`allreduce_grads()` + `update()`, with the weights after each step.

Tolerances: both packages run the autocast Dense as one bf16 rounding of
an fp32 sum of the same bf16 products, in another order, then a bf16
bias add: one bf16 ulp apart at most (rtol 2^-7, AUTOCAST_TOL); a bf16
gradient of (y * y).sum() rounds twice more (2 y, then its product with
x), so two ulps (2^-6). The SGD
steps are fp32 updates of the same gradients (rtol 1e-6, SGD_TOL); the
scales and the skip decisions must be equal.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import amp as jamp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()
AUTOCAST_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
SGD_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def _amp_off():
    yield
    amp.reset()
    jamp.reset()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype("float32").asnumpy())


def _pair(make):
    """The JAX block `make(mxj)` initialised, and the port's `make(mx)`
    holding the same weights."""
    jnet = make(mxj)
    jnet.initialize()
    arrays = {n: p.data().asnumpy() for n, p in
              jnet._collect_params_with_prefix().items()}
    tnet = make(mx)
    mx.convert.load_jax_parameters(tnet, arrays, ctx=CPU)
    return jnet, tnet


def _dense(pkg, units=2, in_units=2):
    return pkg.gluon.nn.Dense(units, in_units=in_units)


def _dense_bn_dense(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4),
            pkg.gluon.nn.BatchNorm(axis=1, in_channels=8),
            pkg.gluon.nn.Dense(2, in_units=8))
    return net


def _dtypes(net):
    return {n: str(p.data().dtype).split(".")[-1] for n, p in
            net._collect_params_with_prefix().items()}


def test_module_has_the_jax_modules_names():
    assert amp.__all__ == jamp.__all__
    assert amp.bfloat16 == torch.bfloat16
    assert mx.amp is amp
    assert amp._CAST_LAYERS == jamp._CAST_LAYERS
    assert amp._KEEP_FP32 == jamp._KEEP_FP32


def test_convert_block_casts_matmul_keeps_norms():
    """Every structural name gets the JAX package's dtype."""
    jnet, tnet = _pair(_dense_bn_dense)
    jamp.convert_block(jnet, "bfloat16")
    amp.convert_block(tnet, "bfloat16")
    assert _dtypes(tnet) == _dtypes(jnet)
    assert _dtypes(tnet)["0.weight"] == "bfloat16"
    assert _dtypes(tnet)["1.gamma"] == "float32"


def test_bf16_forward_backward():
    """A cast Dense on bf16 input: y and the bf16 gradient match the JAX
    package's on the same weights and input."""
    jnet, tnet = _pair(lambda pkg: _dense(pkg, 4, 4))
    jnet.cast("bfloat16")
    tnet.cast("bfloat16")
    x = np.random.RandomState(0).uniform(size=(2, 4)).astype(np.float32)
    with mx.autograd.record():
        y = tnet(mx.nd.array(x, ctx=CPU, dtype="bfloat16"))
        loss = (y * y).sum()
    loss.backward()
    with mxj.autograd.record():
        jy = jnet(mxj.nd.array(x).astype("bfloat16"))
        (jy * jy).sum().backward()
    g = tnet.weight.grad()
    assert g.dtype == torch.bfloat16
    assert np.isfinite(g.asnumpy()).all()
    np.testing.assert_allclose(_np(y._data), _np(jy), **AUTOCAST_TOL)
    np.testing.assert_allclose(g.asnumpy(), _np(jnet.weight.grad()),
                               rtol=2.0 ** -6, atol=2.0 ** -6)


def _scale_sequence(pkg, init_scale, window, overflows):
    s = pkg.amp.DynamicLossScaler(init_scale=init_scale, scale_factor=2.0,
                                  scale_window=window)
    out = []
    for o in overflows:
        s.update_scale(o)
        out.append(s.loss_scale)
    return out


@pytest.mark.parametrize("init_scale,window,overflows", [
    (1024.0, 2, [True, False, False]),
    (4.0, 100, [True] * 11),
    (1024.0, 3, [False, False, True, False, False, False, False, False]),
], ids=["down_on_overflow", "floor_at_one", "window_resets_on_overflow"])
def test_dynamic_loss_scaler_sequences(init_scale, window, overflows):
    """The three scaler cases of tests/test_amp.py: the port's scales
    step by step equal the JAX package's, and the cases' own values."""
    got = _scale_sequence(mx, init_scale, window, overflows)
    assert got == _scale_sequence(mxj, init_scale, window, overflows)
    want = {2: [512.0, 512.0, 1024.0],
            100: [2.0, 1.0] + [1.0] * 9,
            3: [1024.0, 1024.0, 512.0, 512.0, 512.0, 1024.0, 1024.0,
                1024.0]}[window]
    assert got == want


def test_scale_loss_and_unscale_roundtrip(_amp_off):
    amp.init(target_dtype="float16")
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    x = mx.nd.ones((1, 2), ctx=CPU)
    with mx.autograd.record():
        y = net(x).sum()
        scaled = amp.scale_loss(y)
    scaled.backward()
    scale = amp.scaler().loss_scale
    g_scaled = net.weight.grad().asnumpy().copy()
    mx.profiler.reset_dispatches()
    amp.unscale(list(net.collect_params().values()))
    assert mx.profiler.dispatch_count("amp_unscale") == 1
    g = net.weight.grad().asnumpy()
    np.testing.assert_allclose(g * scale, g_scaled, rtol=1e-3)


def test_overflow_detection():
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    x = mx.nd.ones((1, 2), ctx=CPU)
    with mx.autograd.record():
        y = net(x).sum() * float("inf")
    y.backward()
    s = amp.DynamicLossScaler()
    assert s.has_overflow(list(net.collect_params().values()))


def test_grads_nonfinite_is_one_reduction(monkeypatch):
    """All gradients in one buffer, one isfinite and one host read,
    whatever the parameter count; finite gradients, an inf and a nan
    in any one of them."""
    net = nn.HybridSequential()
    for _ in range(5):
        net.add(nn.Dense(3, in_units=3))
    net.initialize(ctx=CPU)
    with mx.autograd.record():
        net(mx.nd.ones((1, 3), ctx=CPU)).sum().backward()
    params = list(net.collect_params().values())
    calls = []
    real = torch.isfinite
    monkeypatch.setattr(torch, "isfinite",
                        lambda t: calls.append(t.numel()) or real(t))
    assert not amp.grads_nonfinite(params)
    assert calls == [5 * (9 + 3)]
    for bad in (float("inf"), float("nan")):
        params[7]._grad._data[0] = bad
        assert amp.grads_nonfinite(params)
        params[7]._grad._data[0] = 0.0
    assert not amp.grads_nonfinite([])


def test_init_autocasts_dense_compute(_amp_off):
    """amp.init() changes the compute dtype: fp32 in, bf16 out, the
    weights stay fp32 masters; y equals the JAX package's autocast
    Dense on the same weights and input."""
    jnet, net = _pair(lambda pkg: _dense(pkg, 4, 4))
    xs = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    x = mx.nd.array(xs, ctx=CPU)
    assert net(x).dtype == np.float32
    amp.init("bfloat16")
    jamp.init("bfloat16")
    y = net(x)
    assert y.dtype == torch.bfloat16
    assert net.weight.data().dtype == np.float32
    np.testing.assert_allclose(_np(y._data), _np(jnet(mxj.nd.array(xs))),
                               **AUTOCAST_TOL)


def test_init_float16_runs_products_in_float16(_amp_off):
    """A float16 target: Dense in float16 (and a scaler); BatchNorm.cast
    keeps float16 out of the normalisation, as the JAX package does."""
    amp.init("float16")
    net = nn.Dense(4, in_units=4)
    net.initialize(ctx=CPU)
    assert net(mx.nd.ones((2, 4), ctx=CPU)).dtype == np.float16
    assert amp.scaler() is not None
    jbn = mxj.gluon.nn.BatchNorm(axis=1, in_channels=4)
    bn = nn.BatchNorm(axis=1, in_channels=4)
    for b in (jbn, bn):
        b.initialize(**({} if b is jbn else {"ctx": CPU}))
        b.cast("float16")
    assert _dtypes(bn) == _dtypes(jbn) == dict.fromkeys(
        ("gamma", "beta", "running_mean", "running_var"), "float32")


def test_convert_block_fixes_blanket_cast(_amp_off):
    """_KEEP_FP32 is live: convert_block after a blanket cast puts the
    norm layers back to fp32, name by name as the JAX package does."""
    jnet, tnet = _pair(_dense_bn_dense)
    for net, a in ((jnet, jamp), (tnet, amp)):
        net.cast("bfloat16")
        assert "bfloat16" in str(net[1].gamma.data().dtype)
        a.convert_block(net, "bfloat16")
    assert _dtypes(tnet) == _dtypes(jnet)
    assert _dtypes(tnet)["1.gamma"] == "float32"
    assert _dtypes(tnet)["0.weight"] == "bfloat16"


def _overflow_then_clean(pkg, use_update):
    """tests/test_amp.py's protocol: a forced overflow, then a clean
    step, through step() or allreduce_grads() + update(): (scales, the
    weight before, after the overflow and after the clean step)."""
    pkg.amp.init("float16")
    scaler = pkg.amp.scaler()
    scaler.loss_scale = 1024.0
    net = _dense(pkg)
    net.initialize(**({"ctx": CPU} if pkg is mx else {}))
    if pkg is mx:
        net.weight.set_data(torch.tensor([[0.5, -0.25], [0.125, 1.0]]))
    else:
        net.weight.set_data(pkg.nd.array([[0.5, -0.25], [0.125, 1.0]]))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    x = pkg.nd.ones((1, 2), **({"ctx": CPU} if pkg is mx else {}))
    ws, scales = [net.weight.data().asnumpy().copy()], []
    for bad in (True, False):
        with pkg.autograd.record():
            out = net(x).sum()
            loss = pkg.amp.scale_loss(out * float("inf") if bad else out)
        loss.backward()
        if use_update:
            trainer.allreduce_grads()
            trainer.update(1)
        else:
            trainer.step(1)
        ws.append(net.weight.data().asnumpy().copy())
        scales.append(scaler.loss_scale)
    return scales, ws


@pytest.mark.parametrize("use_update", [False, True],
                         ids=["step", "allreduce_update"])
def test_trainer_skips_update_on_overflow_and_halves_scale(_amp_off,
                                                           use_update):
    """The forced overflow skips the update and halves the scale; the
    clean step then updates by lr * x = 0.1 (unscaled): the port's
    scales equal the JAX Trainer's and its weights match after each
    step."""
    scales, ws = _overflow_then_clean(mx, use_update)
    jscales, jws = _overflow_then_clean(mxj, use_update)
    assert scales == jscales == [512.0, 512.0]
    np.testing.assert_array_equal(ws[1], ws[0])
    np.testing.assert_allclose(ws[0] - ws[2], np.full_like(ws[0], 0.1),
                               rtol=1e-3)
    for w, jw in zip(ws, jws):
        np.testing.assert_allclose(w, jw, **SGD_TOL)


def test_init_busts_hybridize_cache(_amp_off):
    """amp.init() after a hybridized net ran takes effect at once, and
    reset() undoes it (the port's blocks run eagerly)."""
    net = nn.Dense(4, in_units=4)
    net.initialize(ctx=CPU)
    net.hybridize()
    x = mx.nd.ones((2, 4), ctx=CPU)
    assert net(x).dtype == np.float32
    amp.init("bfloat16")
    assert net(x).dtype == torch.bfloat16
    amp.reset()
    assert net(x).dtype == np.float32


def _skip_nonfinite(pkg):
    net = _dense(pkg)
    net.initialize(**({"ctx": CPU} if pkg is mx else {}))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1},
                                skip_nonfinite=True)
    x = pkg.nd.ones((1, 2), **({"ctx": CPU} if pkg is mx else {}))
    ws = [net.weight.data().asnumpy().copy()]
    for bad in (True, False):
        with pkg.autograd.record():
            loss = net(x).sum() * (float("nan") if bad else 1.0)
        loss.backward()
        trainer.step(1)
        ws.append(net.weight.data().asnumpy().copy())
    return ws


def test_trainer_skip_nonfinite(_amp_off):
    """skip_nonfinite without AMP: the nan step is skipped through one
    `nonfinite_guard` dispatch, the clean one updates, as in the JAX
    Trainer."""
    mx.profiler.reset_dispatches()
    ws = _skip_nonfinite(mx)
    assert mx.profiler.dispatch_count("nonfinite_guard") == 2
    jws = _skip_nonfinite(mxj)
    np.testing.assert_array_equal(ws[1], ws[0])
    assert not np.allclose(ws[2], ws[0])
    np.testing.assert_array_equal(jws[1], jws[0])
    np.testing.assert_allclose(ws[0] - ws[2], jws[0] - jws[2], **SGD_TOL)
