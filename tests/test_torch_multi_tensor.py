"""The port's fused multi-tensor Trainer path (`optimizer/multi_tensor.py`,
`gluon.Trainer(fused=True)`, `engine.set_bulk_size`) on the CPU against
the JAX package: the cases of `tests/test_multi_tensor.py` that need no
key-value store. The same MLP in both packages (the JAX weights carried
over by name), the same seeded numpy batch, the same steps; the port's
fused path is also held against its own per-parameter path.

Tolerances: fp32 weights after a few steps agree within rtol 1e-4, atol
1e-6 across the packages and the two paths (the updates run their sums
and products in other orders: foreach lists against one XLA region);
bf16 weights with fp32 masters within the JAX test's rtol 2e-2, atol
1e-3 (a bf16 ulp of the written-back weight). Bucket layouts, dispatch
counts, cache tallies, skip decisions and loss scales are compared
exactly."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu.optimizer import multi_tensor as jmt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import multi_tensor

CPU = mx.cpu()
TOL = dict(rtol=1e-4, atol=1e-6)
MP_TOL = dict(rtol=2e-2, atol=1e-3)
# Adam across the packages: JAX takes 1 - beta2^t in fp32 (5e-5 of
# relative error at t = 1), up to 3e-5 of lr a step in the update
# (tests/test_torch_bf16_bert.py); the port takes it in float64. Four
# steps at lr 0.05: 6e-6.
ADAM_TOL = dict(rtol=1e-4, atol=6e-6)


def _data(n=8, d=16, k=4):
    rng = np.random.RandomState(0)
    return (rng.randn(n, d).astype(np.float32),
            rng.randint(0, k, n).astype(np.float32))


def _mlp(pkg, layers, hidden, k):
    net = pkg.gluon.nn.Sequential()
    for _ in range(layers):
        net.add(pkg.gluon.nn.Dense(hidden, activation="relu"))
    net.add(pkg.gluon.nn.Dense(k))
    return net


def _nets(x, layers=3, hidden=16, k=4):
    """The JAX MLP (Xavier from seed 0, materialised) and the port's
    with the same weights."""
    mxj.random.seed(0)
    jnet = _mlp(mxj, layers, hidden, k)
    jnet.initialize(mxj.init.Xavier())
    jnet(mxj.nd.array(x))
    arrays = {n: np.asarray(p.data()._data)
              for n, p in jnet._collect_params_with_prefix().items()}
    tnet = _mlp(mx, layers, hidden, k)
    mx.convert.load_jax_parameters(tnet, arrays, ctx=CPU)
    return jnet, tnet


def _batch(pkg, x, y):
    if pkg is mx:
        return mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU)
    return mxj.nd.array(x), mxj.nd.array(y)


def _weights(net):
    return [p.data().asnumpy().astype(np.float32)
            for p in net.collect_params().values()]


def _train(pkg, net, opt, x, y, steps=3, opt_params=None, cast=None,
           **trainer_kw):
    xb, yb = _batch(pkg, x, y)
    if cast:
        net.cast(cast)
        xb = xb.astype(cast)
    lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = pkg.gluon.Trainer(net.collect_params(), opt,
                           dict({"learning_rate": 0.05},
                                **(opt_params or {})), **trainer_kw)
    for _ in range(steps):
        with pkg.autograd.record():
            loss = lossf(net(xb), yb).mean()
        loss.backward()
        tr.step(x.shape[0])
    return _weights(net), tr


def _close(a, b, tol, tag):
    for i, (u, v) in enumerate(zip(a, b)):
        np.testing.assert_allclose(u, v, err_msg=f"{tag} param {i}", **tol)


def _three_ways(opt, x, y, tol=None, **kw):
    """The JAX fused Trainer, the port's fused and per-parameter ones."""
    tol = tol or (ADAM_TOL if opt == "adam" else TOL)
    jnet, tnet = _nets(x)
    jw, _ = _train(mxj, jnet, opt, x, y, fused=True, **kw)
    fw, tr = _train(mx, tnet, opt, x, y, fused=True, **kw)
    assert tr._fused
    _, tnet2 = _nets(x)
    uw, tr2 = _train(mx, tnet2, opt, x, y, fused=False, **kw)
    assert not tr2._fused
    _close(fw, jw, tol, f"{opt} port fused vs JAX")
    _close(fw, uw, tol, f"{opt} port fused vs per-parameter")
    return fw


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"wd": 0.01, "momentum": 0.9}),
    ("adam", {"wd": 0.01}),
], ids=["sgd-momentum", "adam"])
def test_fused_parity(opt, params):
    x, y = _data()
    _three_ways(opt, x, y, opt_params=params)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fused_parity_multi_precision(opt):
    """bf16 weights with fp32 masters: the fused kernel updates the
    master and rounds it into the weight, every state in fp32. Both
    packages step on the JAX package's gradients (carried bit for bit
    into the port's gradient buffers): the two bf16 forwards round
    differently, and Adam turns a gradient near 0 into a step of +-lr
    whichever sign its rounding gave it, so only the same gradients test
    the update. The port's per-parameter path on the same gradients too."""
    x, y = _data()
    params = {"learning_rate": 0.05, "multi_precision": True}
    if opt == "sgd":
        params["momentum"] = 0.9
    jnet, tnet = _nets(x)
    tnet2 = _nets(x)[1]
    for net in (jnet, tnet, tnet2):
        net.cast("bfloat16")
    jtr = mxj.gluon.Trainer(jnet.collect_params(), opt, dict(params))
    trs = [mx.gluon.Trainer(n.collect_params(), opt, dict(params),
                            fused=f) for n, f in ((tnet, True),
                                                  (tnet2, False))]
    xb, yb = _batch(mxj, x, y)
    lossf = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    names = list(jnet._collect_params_with_prefix())
    for _ in range(3):
        with mxj.autograd.record():
            loss = lossf(jnet(xb.astype("bfloat16")), yb).mean()
        loss.backward()
        grads = {n: np.asarray(p.grad()._data.astype("float32"))
                 for n, p in jnet._collect_params_with_prefix().items()}
        jtr.step(x.shape[0])
        for net, tr in zip((tnet, tnet2), trs):
            tp = net._collect_params_with_prefix()
            for n in names:
                tp[n].grad()._data.copy_(torch.tensor(grads[n]))
            tr.step(x.shape[0])
    jw = _weights(jnet)
    _close(_weights(tnet), jw, MP_TOL, f"{opt} port fused vs JAX")
    for a, b in zip(_weights(tnet), _weights(tnet2)):
        np.testing.assert_array_equal(a, b)
    jst, tst = jtr._updater.states, trs[0]._updater.states
    for k in tst:
        np.testing.assert_allclose(tst[k][0].asnumpy(),
                                   np.asarray(jst[k][0]._data),
                                   err_msg=f"master {k}", **TOL)
        assert all(s._data.dtype in (torch.float32, torch.int32)
                   for s in tst[k])
    for p in tnet.collect_params().values():
        assert p.data()._data.dtype == torch.bfloat16


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"momentum": 0.9, "wd": 1e-3}),
    ("adam", {"multi_precision": True}),
], ids=["sgd-momentum", "adam-mp-bf16"])
def test_fused_matches_per_parameter_bits(opt, params):
    """On the same forward the port's fused and per-parameter updates
    give the same bits here on the CPU (fp32 SGD; bf16 weights with fp32
    masters under Adam at the default epsilon)."""
    x, y = _data()
    cast = "bfloat16" if params.get("multi_precision") else None
    fw, _ = _train(mx, _nets(x)[1], opt, x, y, opt_params=params,
                   cast=cast)
    uw, _ = _train(mx, _nets(x)[1], opt, x, y, opt_params=params,
                   cast=cast, fused=False)
    for a, b in zip(fw, uw):
        np.testing.assert_array_equal(a, b)


def test_fused_skip_nonfinite_and_null_grads():
    """A nan gradient skips the whole update in both packages; a
    grad_req="null" head rides along untouched; finite gradients then
    update as in JAX."""
    x, y = _data()
    out = {}
    for pkg, net in zip((mxj, mx), _nets(x)):
        params = net.collect_params()
        list(params.values())[-1].grad_req = "null"
        tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.5},
                               skip_nonfinite=True)
        assert tr._fused
        xb, yb = _batch(pkg, x, y)
        lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = lossf(net(xb), yb).mean()
        loss.backward()
        before = _weights(net)
        poisoned = next(p for p in params.values() if p._grad is not None)
        if pkg is mx:
            poisoned._grad._data.mul_(float("nan"))
        else:
            poisoned._grad._rebind(poisoned._grad._data * np.nan)
        tr.step(x.shape[0])
        for a, b in zip(before, _weights(net)):
            np.testing.assert_array_equal(a, b)
        assert tr.consecutive_skipped_steps == 1
        with pkg.autograd.record():
            loss = lossf(net(xb), yb).mean()
        loss.backward()
        tr.step(x.shape[0])
        after = _weights(net)
        assert tr.consecutive_skipped_steps == 0
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))
        np.testing.assert_array_equal(before[-1], after[-1])
        out[pkg] = after
    _close(out[mx], out[mxj], TOL, "skip then step")


def test_skip_streak_raises_past_max_skipped_steps():
    """max_skipped_steps=1: the second skip in a row raises in both
    packages, with the same streak and skip counter."""
    x, y = _data()
    for pkg, net in zip((mxj, mx), _nets(x)):
        pkg.fault.injection.clear()
        pkg.fault.injection.inject("grad.nan", prob=1.0)
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05},
                                   skip_nonfinite=True, max_skipped_steps=1)
            xb, yb = _batch(pkg, x, y)
            lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            for k in range(2):
                with pkg.autograd.record():
                    loss = lossf(net(xb), yb).mean()
                loss.backward()
                if k == 0:
                    tr.step(x.shape[0])
                    assert tr.consecutive_skipped_steps == 1
                else:
                    with pytest.raises(Exception,
                                       match="consecutive skipped"):
                        tr.step(x.shape[0])
            assert tr.consecutive_skipped_steps == 2
        finally:
            pkg.fault.injection.clear()


@pytest.mark.parametrize("fused", [True, False])
def test_fused_amp_overflow_skip_parity(fused):
    """float16 AMP: an inf gradient at step 2 skips the update and halves
    the scale, as in the JAX package; the weights agree after 3 steps."""
    x, y = _data()
    res = {}
    for pkg, net in zip((mxj, mx), _nets(x)):
        pkg.amp.reset()
        pkg.amp.init("float16")
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05}, fused=fused)
            xb, yb = _batch(pkg, x, y)
            lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            for i in range(3):
                with pkg.autograd.record():
                    loss = pkg.amp.scale_loss(lossf(net(xb), yb).mean())
                loss.backward()
                if i == 1:
                    p0 = list(net.collect_params().values())[0]
                    if pkg is mx:
                        p0._grad._data.mul_(float("inf"))
                    else:
                        p0._grad._rebind(p0._grad._data * np.inf)
                tr.step(x.shape[0])
            res[pkg] = (_weights(net), pkg.amp._state["scaler"].loss_scale)
        finally:
            pkg.amp.reset()
    assert res[mx][1] == res[mxj][1] < 2.0 ** 16
    _close(res[mx][0], res[mxj][0], TOL, f"amp fused={fused}")


def test_fused_matches_with_per_param_buckets():
    """set_bulk_size(0): one parameter a bucket, the same numbers."""
    x, y = _data()
    prev = mx.engine.set_bulk_size(0)
    try:
        fw = _three_ways("adam", x, y)
    finally:
        mx.engine.set_bulk_size(prev)
    assert len(fw) == 8


def test_build_buckets_layouts_equal_jax():
    """Caps 0, 8 bytes, 1 GiB and a cap that splits the fp32 run, and a
    bf16 parameter that breaks a bucket: the same index layout as the
    JAX function on the same parameters."""
    x, _ = _data()
    jnet, tnet = _nets(x)
    jpairs = list(enumerate(jnet.collect_params().values()))
    tpairs = list(enumerate(tnet.collect_params().values()))

    def layout(fn, pairs, cap):
        return [[i for i, _ in b] for b in fn(pairs, cap)]

    for cap in (0, 8, 1 << 30, 1200):
        assert layout(multi_tensor.build_buckets, tpairs, cap) == \
            layout(jmt.build_buckets, jpairs, cap), cap
    assert len(multi_tensor.build_buckets(tpairs, 1 << 30)) == 1
    assert [len(b) for b in multi_tensor.build_buckets(tpairs, 0)] == \
        [1] * len(tpairs)
    jpairs[1][1].cast("bfloat16")
    tpairs[1][1].cast("bfloat16")
    want = layout(jmt.build_buckets, jpairs, 1 << 30)
    assert layout(multi_tensor.build_buckets, tpairs, 1 << 30) == want
    assert len(want) == 3          # fp32 | bf16 | fp32


def test_bucket_cache_invalidates_on_bulk_size_change():
    x, y = _data()
    _, tnet = _nets(x)
    _, tr = _train(mx, tnet, "sgd", x, y, steps=1)
    assert len(tr._buckets) == 1
    assert mx.profiler.bucket_sizes() == [sum(
        p.grad()._data.numel() * 4 for p in tnet.collect_params().values())]
    prev = mx.engine.set_bulk_size(0)
    try:
        xb, yb = _batch(mx, x, y)
        lossf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            loss = lossf(tnet(xb), yb).mean()
        loss.backward()
        tr.step(x.shape[0])
        assert len(tr._buckets) == len(tnet.collect_params())
    finally:
        mx.engine.set_bulk_size(prev)


def test_set_bulk_size_roundtrip_and_scope():
    """The port's engine knob gives the JAX engine's values for the same
    calls; the rest of the engine (ROADMAP.md Queue 1 [9]) is ported
    beside it: the JAX engine's names, with its constants."""
    def drive(engine):
        seen = [engine.get_bulk_size()]
        base = engine.get_bulk_size()
        seen.append(engine.set_bulk_size(12345))
        seen.append(engine.get_bulk_size())
        with engine.bulk(1 << 20):
            seen.append(engine.get_bulk_size())
        seen.append(engine.get_bulk_size())
        with engine.bulk(15):
            seen.append(engine.get_bulk_size())
        with engine.bulk(0):
            seen.append(engine.get_bulk_size())
        engine.set_bulk_size(15)
        seen.append(engine.get_bulk_size())
        engine.set_bulk_size(base)
        seen.append(engine.get_bulk_size())
        return seen

    got = drive(mx.engine)
    assert got == drive(mxj.engine)
    assert got[0] == mx.engine._DEFAULT_BULK_BYTES == 64 << 20
    assert got[5] == mx.engine._DEFAULT_BULK_BYTES and got[6] == 0
    assert sorted(mx.engine.__all__) == sorted(mxj.engine.__all__ + [
        "bulk"])
    for name in ("PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_BACKGROUND",
                 "PRIORITY_NAMES", "NUM_PRIORITIES"):
        assert getattr(mx.engine, name) == getattr(mxj.engine, name)
    v = mx.engine.Var()
    assert mx.engine.push(lambda: 7, write_vars=[v]).result(timeout=60) == 7
    mx.engine.wait_for_all()


def test_hyperparam_mutation_recompiles():
    """momentum 0.9 -> 0 after two steps: a new cache entry (a miss),
    the stale momentum kept, and the weights of both paths and of JAX
    agree."""
    x, y = _data()
    res = {}
    for pkg, fused, net in ((mxj, True, _nets(x)[0]), (mx, True,
                            _nets(x)[1]), (mx, False, _nets(x)[1])):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9},
                               fused=fused)
        xb, yb = _batch(pkg, x, y)
        lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        pkg.profiler.reset_dispatches()
        for step in range(4):
            if step == 2:
                tr._optimizer.momentum = 0.0
            with pkg.autograd.record():
                loss = lossf(net(xb), yb).mean()
            loss.backward()
            tr.step(x.shape[0])
        if fused:
            assert pkg.profiler.jit_cache_stats()[1] == 2, pkg
        res[(pkg, fused)] = _weights(net)
    _close(res[(mx, True)], res[(mxj, True)], TOL, "momentum change")
    _close(res[(mx, True)], res[(mx, False)], TOL, "momentum change")


class _SGDOwnUpdate(mx.optimizer.SGD):
    """An optimizer with its own imperative `update`: the fused rule
    cannot stand for it."""

    def update(self, index, weight, grad, state):
        super().update(index, weight, grad, state)


def test_unsupported_optimizer_falls_back():
    """`supports` is False for an overridden `update`: the Trainer takes
    the per-parameter path and still trains as JAX's SGD does."""
    x, y = _data()
    jnet, tnet = _nets(x)
    assert not multi_tensor.supports(_SGDOwnUpdate())
    assert multi_tensor.supports(mx.optimizer.create("adam"))
    jw, _ = _train(mxj, jnet, "sgd", x, y, fused=False)
    tw, tr = _train(mx, tnet, _SGDOwnUpdate(learning_rate=0.05), x, y)
    assert not tr._fused
    _close(tw, jw, TOL, "own update")


def test_fused_save_load_states_roundtrip(tmp_path):
    """Adam's (m, v, t) after a fused step: t is a 0-d int32 tensor on the
    device; save_states / load_states bring back the update count and
    every state, equal to JAX's within the tolerance."""
    x, y = _data()
    jnet, tnet = _nets(x)
    _, jtr = _train(mxj, jnet, "adam", x, y, steps=2)
    _, tr = _train(mx, tnet, "adam", x, y, steps=2)
    f = str(tmp_path / "states.bin")
    tr.save_states(f)
    tr2 = mx.gluon.Trainer(tnet.collect_params(), "adam",
                           {"learning_rate": 0.05})
    tr2.load_states(f)
    assert tr2._optimizer.num_update == tr._optimizer.num_update == 2
    for k, v in tr._updater.states.items():
        m, v_, t = v
        assert t._data.dtype == torch.int32 and t._data.dim() == 0
        assert int(t._data) == 2
        for a, b, c in zip(v, tr2._updater.states[k],
                           jtr._updater.states[k]):
            assert torch.equal(a._data, b._data)
            np.testing.assert_allclose(a.asnumpy(), np.asarray(c._data),
                                       err_msg=f"state of {k}", **ADAM_TOL)


def test_dispatch_count_50_param_mlp():
    """25 Dense layers, 50 parameters: a warm fused step takes one
    `fused_update` dispatch and one cache hit in both packages, and the
    per-parameter path one dispatch a parameter."""
    x, y = _data()
    counts = {}
    for fused in (True, False):
        for pkg, net in zip((mxj, mx), _nets(x, layers=24)):
            params = net.collect_params()
            assert len(params) == 50
            tr = pkg.gluon.Trainer(params, "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9},
                                   fused=fused)
            xb, yb = _batch(pkg, x, y)
            lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            for k in range(3):
                with pkg.autograd.record():
                    loss = lossf(net(xb), yb).mean()
                loss.backward()
                if k == 2:
                    pkg.profiler.reset_dispatches()
                tr.step(x.shape[0])
            counts[(pkg, fused)] = (pkg.profiler.dispatch_count(),
                                    pkg.profiler.jit_cache_stats())
            if pkg is mx:
                assert "[dispatch]" in pkg.profiler.dumps()
                pkg.profiler.dumps(reset=True)
                assert pkg.profiler.dispatch_count() == 0
                assert pkg.profiler.jit_cache_stats() == (0, 0)
    assert counts[(mx, True)] == counts[(mxj, True)] == (1, (1, 0))
    assert counts[(mx, False)][0] == counts[(mxj, False)][0] == 50


def test_multi_sgd_matches_jax():
    """`multi_sgd_mom_update` / `multi_sgd_update` on mixed fp32 and bf16
    weights: the JAX package's values (fp32 arithmetic, each output in
    its own dtype)."""
    rng = np.random.RandomState(3)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    ms = [rng.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(lr=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5)
    jw = [mxj.nd.array(w) for w in ws]
    jm = [mxj.nd.array(m) for m in ms]
    tw = [mx.nd.array(w, ctx=CPU) for w in ws]
    tm = [mx.nd.array(m, ctx=CPU) for m in ms]
    mxj.optimizer.optimizer.multi_sgd_mom_update(jw, [mxj.nd.array(g) for g in gs],
                                       jm, **kw)
    mx.optimizer.multi_sgd_mom_update(tw, [mx.nd.array(g, ctx=CPU)
                                           for g in gs], tm, **kw)
    for a, b in zip(tw + tm, jw + jm):
        np.testing.assert_allclose(a.asnumpy(), np.asarray(b._data), **TOL)
    jw2 = [mxj.nd.array(w) for w in ws]
    tw2 = [mx.nd.array(w, ctx=CPU, dtype="bfloat16") for w in ws]
    mxj.optimizer.optimizer.multi_sgd_update(jw2, [mxj.nd.array(g) for g in gs],
                                   0.1, wd=1e-3)
    mx.optimizer.multi_sgd_update(tw2, [mx.nd.array(g, ctx=CPU)
                                        for g in gs], 0.1, wd=1e-3)
    for a, b in zip(tw2, jw2):
        assert a._data.dtype == torch.bfloat16
        np.testing.assert_allclose(a.asnumpy().astype(np.float32),
                                   np.asarray(b._data), rtol=1e-2,
                                   atol=1e-2)


def test_apply_param_update_matches_the_bucket():
    """One parameter's `apply_param_update` with float scalars gives the
    bucket kernel's bits (Adam, a clip, a fold of the inverse loss scale
    that leaves the gradient unscaled), and refuses nothing; the sparse
    arms raise naming Queue 1 [5d]."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(6, 3).astype(np.float32)
    g0 = rng.randn(6, 3).astype(np.float32) * 8
    opt = mx.optimizer.create("adam", learning_rate=0.01,
                              clip_gradient=2.0)
    w, g = torch.tensor(w0), torch.tensor(g0)
    sv = opt.init_state(w)
    multi_tensor.apply_param_update(opt, w, g, sv, 0.01, 1e-3, False, 2.0,
                                    0.5, inv_scale=0.25)
    np.testing.assert_array_equal(g.numpy(), g0 * 0.25)
    ref_w, ref_sv = torch.tensor(w0), opt.init_state(torch.tensor(w0))
    gg = (torch.tensor(g0) * 0.25 * 0.5).clamp_(-2.0, 2.0)
    opt._step(ref_w, gg, ref_sv, 0.01, 1e-3)
    np.testing.assert_allclose(w.numpy(), ref_w.numpy(), **TOL)
    assert int(sv[2]) == 1
    for fn in (multi_tensor.sparse_update_rows,
               multi_tensor.classify_state_rows):
        with pytest.raises(MXNetError, match=r"Queue 1 \[5d\]"):
            fn()
