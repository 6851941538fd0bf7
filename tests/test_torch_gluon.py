"""The port's NDArray / autograd / Gluon / optimizer pieces on the CPU
against the JAX package: layers built in both packages hold the same
weights (a `save_parameters` file crosses from one to the other), take
the same seeded numpy inputs, and must give the same outputs and
gradients."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
# fp32 on the CPU in both packages; sums may run in another order
TOL = dict(rtol=1e-5, atol=1e-6)


def _j(a):
    return mxj.nd.array(a)


def _t(a):
    return mx.nd.array(a, ctx=CPU)


def _grads_of(block, names):
    params = block._collect_params_with_prefix()
    return {n: params[n].grad().asnumpy() for n in names}


def _port_copy_of(jax_block, port_block, tmp_path):
    """Carry the JAX block's weights to the uninitialised port block
    through the JAX package's save_parameters file (the file's shapes
    settle the port's deferred ones)."""
    path = str(tmp_path / "net.params")
    jax_block.save_parameters(path)
    port_block.load_parameters(path, ctx=CPU)
    return port_block


def _fwd_bwd(mod, block, x, w):
    """(output, {structural name: grad}) of sum(block(x) * w)."""
    with mod.autograd.record():
        out = block(x)
        loss = (out * w).sum()
    loss.backward()
    names = list(block._collect_params_with_prefix())
    return out.asnumpy(), _grads_of(block, names)


@pytest.mark.parametrize("layer", ["dense", "dense_flatten", "embedding",
                                   "layernorm", "sequential"])
def test_layers_forward_and_gradients_match_jax(layer, tmp_path):
    rng = np.random.RandomState(0)
    if layer == "embedding":
        x = rng.randint(0, 20, (3, 5)).astype(np.int32)
        make = [lambda nn: nn.Embedding(20, 6)]
        out_shape = (3, 5, 6)
    elif layer == "dense_flatten":
        x = rng.randn(4, 3, 5).astype(np.float32)
        make = [lambda nn: nn.Dense(7, activation="relu")]
        out_shape = (4, 7)
    else:
        x = rng.randn(4, 3, 8).astype(np.float32)
        make = {"dense": [lambda nn: nn.Dense(7, flatten=False, in_units=8)],
                "layernorm": [lambda nn: nn.LayerNorm(in_channels=8)],
                "sequential": [
                    lambda nn: nn.Dense(16, flatten=False,
                                        activation="relu"),
                    lambda nn: nn.Dense(8, flatten=False),
                    lambda nn: nn.LayerNorm()]}[layer]
        out_shape = (4, 3, 8) if layer != "dense" else (4, 3, 7)

    def build(nn):
        net = nn.HybridSequential()
        with net.name_scope():
            for f in make:
                net.add(f(nn))
        return net

    mxj.random.seed(0)
    jnet = build(mxj.gluon.nn)
    jnet.initialize()
    jnet(_j(x))
    if layer == "layernorm":          # non-trivial gamma / beta
        for p in jnet.collect_params().values():
            p.set_data(_j(rng.randn(*p.shape).astype(np.float32)))
    tnet = _port_copy_of(jnet, build(mx.gluon.nn), tmp_path)
    w = rng.randn(*out_shape).astype(np.float32)
    want_out, want_g = _fwd_bwd(mxj, jnet, _j(x), _j(w))
    got_out, got_g = _fwd_bwd(mx, tnet, _t(x), _t(w))
    np.testing.assert_allclose(got_out, want_out, **TOL)
    assert got_g.keys() == want_g.keys()
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **TOL,
                                   err_msg=name)


def test_parameter_file_crosses_back_to_jax(tmp_path):
    """A port `save_parameters` file loads into the JAX package."""
    mx.random.seed(1)
    tnet = mx.gluon.nn.Dense(5, in_units=3)
    tnet.initialize(ctx=CPU)
    tnet.save_parameters(str(tmp_path / "p.params"))
    # an explicit prefix keeps the JAX package's global name counters
    # (which other test files read) untouched
    jnet = mxj.gluon.nn.Dense(5, in_units=3, prefix="crossback_")
    jnet.load_parameters(str(tmp_path / "p.params"))
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(),
                                  tnet.weight.data().asnumpy())


def test_dropout_rate_scaling_and_modes():
    """Dropout keeps about 1 - rate of the elements, scales them by
    1/(1 - rate), draws from the seeded generator, and is the identity
    outside record() and under predict_mode()."""
    drop = mx.gluon.nn.Dropout(0.25)
    x = mx.nd.ones((200, 500), ctx=CPU)
    assert np.array_equal(drop(x).asnumpy(), x.asnumpy())
    mx.random.seed(3)
    with mx.autograd.record():
        y = drop(x).asnumpy()
        with mx.autograd.predict_mode():
            assert np.array_equal(drop(x).asnumpy(), x.asnumpy())
    kept = y != 0
    assert abs(kept.mean() - 0.75) < 0.01
    np.testing.assert_allclose(y[kept], 1 / 0.75, rtol=1e-6)
    mx.random.seed(3)
    with mx.autograd.train_mode():
        assert np.array_equal(drop(x).asnumpy(), y)


def test_deferred_init_and_grad_req_null():
    """A Dense without in_units takes its shape at the first forward; a
    grad_req="null" parameter gets no gradient buffer, and backward
    leaves it alone while the others are written."""
    net = mx.gluon.nn.Dense(4)
    net.initialize(ctx=CPU)
    assert net.weight.shape == (4, 0) and net.weight._data is None
    with pytest.raises(mx.gluon.DeferredInitializationError):
        net.weight.data()
    x = mx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    net(x)
    assert net.weight.shape == (4, 3)
    net.bias.grad_req = "null"
    with mx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    assert net.weight.grad().asnumpy().shape == (4, 3)
    with pytest.raises(MXNetError, match="no gradient"):
        net.bias.grad()
    # grad_req="add" accumulates across backward calls
    net.weight.grad_req = "add"
    for _ in range(2):
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               np.full((4, 3), 4.0), rtol=1e-6)


def test_ndarray_attach_grad_and_reshape():
    """attach_grad / backward on a plain array, MXNet's reshape codes
    (0 copies a dimension, -1 is inferred) and mean."""
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x + 1).reshape((0, -1, 1)).mean()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(),
                               2 * x.asnumpy() / 6, rtol=1e-6)
    assert x.reshape((-1,)).shape == (6,)
    assert x.reshape(0, 1, -1).shape == (2, 1, 3)
    assert x.dtype == np.float32 and x.context.type == "cpu"
    with pytest.raises(MXNetError, match="recorded"):
        mx.nd.array(np.ones(2, np.float32), ctx=CPU).backward()


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
], ids=["sgd-momentum", "adam"])
def test_optimizer_steps_match_jax(opt, kw):
    """Two updates of one weight with the same gradients: SGD with
    momentum and Adam give the JAX package's weights (rescale_grad and
    clip_gradient included)."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * 4 for _ in range(2)]
    kw = dict(kw, rescale_grad=0.5, clip_gradient=1.5)
    jopt = mxj.optimizer.create(opt, **kw)
    topt = mx.optimizer.create(opt, **kw)
    jw, tw = _j(w0), _t(w0)
    js, ts = jopt.create_state(0, jw), topt.create_state(0, tw)
    for g in grads:
        jopt.update(0, jw, _j(g), js)
        topt.update(0, tw, _t(g), ts)
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), **TOL)


def test_trainer_refuses_unported_settings():
    net = mx.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="bogus")
    for kw in ({"update_on_kvstore": True}, {"compression_params":
                                              {"type": "int8"}}):
        with pytest.raises(MXNetError, match="requires a kvstore"):
            mx.gluon.Trainer(net.collect_params(), "sgd", kvstore=None,
                             **kw)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore=None)
    with pytest.raises(MXNetError, match="sharded_update=True needs"):
        tr.capture(lambda x: x, sharded_update=True)
    with pytest.raises(MXNetError, match=r"ROADMAP.*\[5d\]"):
        tr.shard()
    with pytest.raises(MXNetError, match="ROADMAP"):
        mx.optimizer.create("lamb")
    with pytest.raises(MXNetError, match="no gradient"):
        net.weight.grad_req = "write"
        net.weight._grad = None
        tr.step(1)


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_takes_the_reference_arguments(fused):
    """`fused` and `max_skipped_steps` are the JAX Trainer's arguments
    (bench_mlp.py passes `fused=False`): both paths train one step of a
    Dense layer to the JAX package's weights, and `capture` returns a
    step."""
    rng = np.random.RandomState(1)
    w0, x = rng.randn(2, 3).astype(np.float32), rng.randn(4, 3)
    out = {}
    for pkg in (mxj, mx):
        net = pkg.gluon.nn.Dense(2, in_units=3, use_bias=False)
        if pkg is mx:
            net.initialize(ctx=CPU)
            net.weight.set_data(_t(w0))
            xb = _t(x)
        else:
            net.initialize()
            net.weight.set_data(_j(w0))
            xb = _j(x)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               fused=fused, max_skipped_steps=3)
        assert tr._fused == fused and tr.max_skipped_steps == 3
        with pkg.autograd.record():
            loss = (net(xb) * net(xb)).sum()
        loss.backward()
        tr.step(4)
        out[pkg] = net.weight.data().asnumpy()
        if pkg is mx:
            assert tr.consecutive_skipped_steps == 0
            assert isinstance(tr.capture(lambda a: net(a).sum()),
                              mx.CachedStep)
    np.testing.assert_allclose(out[mx], out[mxj], **TOL)


def test_trainer_skip_nonfinite_leaves_weights():
    net = mx.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    before = net.weight.data().asnumpy().copy()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 1.0}, skip_nonfinite=True)
    net.weight.grad()._data.fill_(float("nan"))
    tr.step(1)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), before)
    net.weight.zero_grad()
    net.bias.grad()._data.fill_(1.0)
    tr.step(1)
    np.testing.assert_allclose(net.bias.data().asnumpy(), [-1.0, -1.0])


def test_initializers_draw_on_the_seeded_generator():
    """Uniform(0.07) is the default; one seed gives one draw; the name
    decides gamma / beta / bias."""
    def draw():
        mx.random.seed(7)
        ln = mx.gluon.nn.LayerNorm(in_channels=4)
        d = mx.gluon.nn.Dense(300, in_units=10)
        for b in (ln, d):
            b.initialize(ctx=CPU)
        return d.weight.data().asnumpy(), ln, d
    w1, ln, d = draw()
    w2, _, _ = draw()
    assert np.array_equal(w1, w2)
    assert np.abs(w1).max() <= 0.07 and w1.std() > 0.03
    assert np.array_equal(ln.gamma.data().asnumpy(), np.ones(4))
    assert np.array_equal(d.bias.data().asnumpy(), np.zeros(300))
    x = mx.init.Xavier()("w", (4, 6), np.float32, CPU)
    assert x.shape == (4, 6) and float(x.abs().max()) <= np.sqrt(3 / 5)
    assert float(mx.init.Constant(2.5)("w", (3,), np.float32, CPU)[0]) \
        == 2.5
