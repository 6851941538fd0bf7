"""The port's captured training step (`cachedop.CachedStep`,
`Trainer.capture`, `mx.jit_step`) on the CPU against the JAX package's
captured step: the cases of `tests/test_cachedop.py` that need no mesh,
prefetcher or shard plan. On the CPU the port runs its step program
eagerly through the same cache (no graph); the same MLP in both
packages (the JAX weights carried over by name), the same seeded numpy
batch, the same calls.

Tolerances: fp32 weights and losses within rtol 1e-4, atol 1e-6 across
the packages (the JAX test's limits between its own two paths; the
updates run their sums in other orders), bf16 weights with fp32 masters
within rtol 2e-2, atol 1e-3 (the JAX test's). The port's captured step
and its eager fused step make the same launches on the same values, so
they are held bit for bit. Cache hits, misses with their reasons,
fallback reasons, skip decisions and loss scales are compared exactly.

The `card` tests need a CUDA card and skip here: one graph launch and
no eager op in a warm step, and a replay equal to its eager step. They
need no JAX, so they run on the card's machine with `python3 -m pytest
--noconftest -m card tests/test_torch_cachedop.py`."""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

try:        # the card's machine has no JAX: its `card` tests need none
    import mxnet_tpu as mxj
except ImportError:
    mxj = None

CPU = mx.cpu()
BATCH, DIM, CLS = 8, 16, 4
TOL = dict(rtol=1e-4, atol=1e-6)
MP_TOL = dict(rtol=2e-2, atol=1e-3)
# Adam across the packages: JAX takes 1 - beta2^t in fp32 (5e-5 of
# relative error at t = 1), up to 3e-5 of lr a step in the update
# (tests/test_torch_bf16_bert.py); the port takes it in float64. Four
# steps at lr 0.05: 6e-6.
ADAM_TOL = dict(rtol=1e-4, atol=6e-6)


def _data(n=BATCH):
    rng = np.random.RandomState(0 if n == BATCH else 1)
    return (rng.randn(n, DIM).astype(np.float32),
            rng.randint(0, CLS, n).astype(np.float32))


def _mlp(pkg, layers, bn):
    net = pkg.gluon.nn.Sequential()
    for _ in range(layers):
        net.add(pkg.gluon.nn.Dense(16, activation="relu"))
    if bn:
        net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(CLS))
    return net


def _nets(layers=3, bn=False, ctx=CPU):
    """The JAX MLP (Xavier from seed 0, materialised) and the port's with
    the same weights on `ctx`."""
    x, _ = _data()
    mxj.random.seed(0)
    jnet = _mlp(mxj, layers, bn)
    jnet.initialize(mxj.init.Xavier())
    jnet(mxj.nd.array(x))
    arrays = {n: np.asarray(p.data()._data)
              for n, p in jnet._collect_params_with_prefix().items()}
    tnet = _mlp(mx, layers, bn)
    mx.convert.load_jax_parameters(tnet, arrays, ctx=ctx)
    return jnet, tnet


def _batch(pkg, n=BATCH, ctx=CPU):
    x, y = _data(n)
    if pkg is mx:
        return mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    return mxj.nd.array(x), mxj.nd.array(y)


def _lossf(pkg):
    return pkg.gluon.loss.SoftmaxCrossEntropyLoss()


def _weights(net):
    return [p.data().asnumpy().astype(np.float32)
            for p in net.collect_params().values()]


def _close(a, b, tol, tag):
    for i, (u, v) in enumerate(zip(a, b)):
        np.testing.assert_allclose(u, v, err_msg=f"{tag} param {i}", **tol)


def _imperative(pkg, net, tr, steps, xb, yb):
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = _lossf(pkg)(net(xb), yb).mean()
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.asnumpy()))
    return losses


def _captured(pkg, net, tr, steps, xb, yb):
    lossf = _lossf(pkg)
    step = tr.capture(lambda a, b: lossf(net(a), b).mean())
    losses = []
    for _ in range(steps):
        losses.append(float(step(xb, yb).asnumpy()))
        assert step.last_fallback_reason is None, step.last_fallback_reason
    assert step.cache_size == 1
    return losses


def _both_captured(opt, kw, steps, **trainer_kw):
    """The JAX and the port's captured steps from the same weights:
    (JAX weights, port weights, JAX losses, port losses)."""
    out = []
    for pkg, net in zip((mxj, mx), _nets()):
        tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw),
                               **trainer_kw)
        losses = _captured(pkg, net, tr, steps, *_batch(pkg))
        out.append((_weights(net), losses))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_captured_parity_fused(opt):
    """4 captured steps match the JAX captured step (weights and each
    step's loss), and the port's eager fused Trainer bit for bit."""
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    jw, tw, jl, tl = _both_captured(opt, kw, 4)
    _close(tw, jw, ADAM_TOL if opt == "adam" else TOL, opt)
    np.testing.assert_allclose(tl, jl, **TOL)
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw))
    il = _imperative(mx, net, tr, 4, *_batch(mx))
    for a, b in zip(_weights(net), tw):
        np.testing.assert_array_equal(a, b)
    assert il == tl
    if opt == "adam":
        assert all(int(st[2]._data) == 4
                   for st in tr._updater.states.values())


def test_captured_parity_unfused_trainer():
    """A fused=False Trainer: the captured step still applies the fused
    rule, and matches the JAX captured step and the port's
    per-parameter path."""
    kw = {"learning_rate": 0.05}
    jw, tw, _, _ = _both_captured("adam", kw, 3, fused=False)
    _close(tw, jw, ADAM_TOL, "unfused")
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), "adam", dict(kw),
                          fused=False)
    _imperative(mx, net, tr, 3, *_batch(mx))
    _close(_weights(net), tw, TOL, "per-parameter")


def test_captured_batchnorm_aux_carried():
    """BatchNorm's running statistics move with each captured step as
    with the JAX captured step."""
    out = {}
    for pkg, net in zip((mxj, mx), _nets(bn=True)):
        fresh = _weights(net)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05})
        _captured(pkg, net, tr, 3, *_batch(pkg))
        out[pkg] = _weights(net)
        names = [n for n in net._collect_params_with_prefix()
                 if "running" in n]
        assert len(names) == 2
        moved = [not np.array_equal(a, b) for a, b in zip(out[pkg], fresh)]
        assert all(moved)
    _close(out[mx], out[mxj], TOL, "bn")


def test_captured_amp_overflow_skip_parity():
    """float16 AMP with grad.nan at step 2: the captured guard skips that
    update and halves the scale, as the JAX captured step and the port's
    imperative path do."""
    def run(pkg, net, captured):
        pkg.amp.reset()
        pkg.amp.init("float16")
        pkg.fault.injection.clear()
        pkg.fault.injection.inject("grad.nan", at=[2])
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05})
            xb, yb = _batch(pkg)
            if captured:
                _captured(pkg, net, tr, 4, xb, yb)
            else:
                for _ in range(4):
                    with pkg.autograd.record():
                        loss = pkg.amp.scale_loss(
                            _lossf(pkg)(net(xb), yb).mean())
                    loss.backward()
                    tr.step(BATCH)
            return _weights(net), pkg.amp._state["scaler"].loss_scale
        finally:
            pkg.amp.reset()
            pkg.fault.injection.clear()

    jnet, tnet = _nets()
    jw, js = run(mxj, jnet, True)
    tw, ts = run(mx, tnet, True)
    iw, is_ = run(mx, _nets()[1], False)
    assert ts == js == is_ < 2.0 ** 16
    _close(tw, jw, TOL, "amp captured")
    _close(tw, iw, TOL, "amp imperative")


def test_captured_skip_nonfinite_and_streak():
    """skip_nonfinite: the poisoned step leaves every weight and state
    bit for bit; the streak goes to 1 and resets; with
    max_skipped_steps=1 the second skip raises, in both packages."""
    for pkg, net in zip((mxj, mx), _nets()):
        pkg.fault.injection.clear()
        pkg.fault.injection.inject("grad.nan", at=[2])
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.05},
                                   skip_nonfinite=True)
            lossf = _lossf(pkg)
            step = tr.capture(lambda a, b: lossf(net(a), b).mean())
            xb, yb = _batch(pkg)
            step(xb, yb)
            before = _weights(net)
            states = {k: [np.asarray(s.asnumpy() if pkg is mx
                                     else s._data) for s in v]
                      for k, v in tr._updater.states.items()}
            count = tr._optimizer.num_update
            step(xb, yb)
            for a, b in zip(before, _weights(net)):
                np.testing.assert_array_equal(a, b)
            for k, v in tr._updater.states.items():
                for a, b in zip(states[k], v):
                    np.testing.assert_array_equal(
                        a, b.asnumpy() if pkg is mx else b._data)
            assert tr._optimizer.num_update == count
            assert tr.consecutive_skipped_steps == 1
            step(xb, yb)
            assert tr.consecutive_skipped_steps == 0
            assert step.last_fallback_reason is None
        finally:
            pkg.fault.injection.clear()
        pkg.fault.injection.inject("grad.nan", prob=1.0)
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05},
                                   skip_nonfinite=True, max_skipped_steps=1)
            step = tr.capture(lambda a, b: lossf(net(a), b).mean())
            step(xb, yb)
            with pytest.raises(Exception, match="consecutive skipped"):
                step(xb, yb)
        finally:
            pkg.fault.injection.clear()


def test_captured_skip_with_bf16_gradients():
    """The guard on bf16 gradients (which the AMP kernel does not take):
    with `grad.nan` at step 2 the captured step skips it, leaving every
    bf16 weight and fp32 master bit for bit, in both packages; the other
    steps update as the JAX captured step does."""
    out = {}
    for pkg, net in zip((mxj, mx), _nets()):
        net.cast("bfloat16")
        xb, yb = _batch(pkg)
        xb = xb.astype("bfloat16")
        pkg.fault.injection.clear()
        pkg.fault.injection.inject("grad.nan", at=[2])
        try:
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9,
                                    "multi_precision": True},
                                   skip_nonfinite=True)
            lossf = _lossf(pkg)
            step = tr.capture(lambda a, b: lossf(net(a), b).mean())
            step(xb, yb)
            before = _weights(net)
            masters = [np.asarray(st[0].asnumpy() if pkg is mx
                                  else st[0]._data.astype("float32"))
                       for st in tr._updater.states.values()]
            step(xb, yb)
            assert tr.consecutive_skipped_steps == 1
            for a, b in zip(before, _weights(net)):
                np.testing.assert_array_equal(a, b)
            for a, st in zip(masters, tr._updater.states.values()):
                np.testing.assert_array_equal(
                    a, st[0].asnumpy() if pkg is mx
                    else np.asarray(st[0]._data.astype("float32")))
            step(xb, yb)
            assert tr.consecutive_skipped_steps == 0
            assert step.last_fallback_reason is None
            out[pkg] = _weights(net)
        finally:
            pkg.fault.injection.clear()
    _close(out[mx], out[mxj], MP_TOL, "bf16 skip")


def _series(pkg, name):
    snap = pkg.observability.registry().snapshot().get(name, [])
    return {tuple(sorted(s["labels"].items())): s["value"] for s in snap}


def test_cache_hit_miss_counters_and_reasons():
    """The same calls give the same hits, the same labelled misses
    (first, shape_change, scale_mode) and the same cache size in both
    packages."""
    deltas = {}
    for pkg, net in zip((mxj, mx), _nets()):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05})
        lossf = _lossf(pkg)
        step = tr.capture(lambda a, b: lossf(net(a), b).mean())
        h0 = _series(pkg, "cachedop_cache_hits").get((), 0)
        m0 = _series(pkg, "cachedop_cache_misses")
        seen = []
        xb, yb = _batch(pkg)
        x2, y2 = _batch(pkg, 4)
        for b in ((xb, yb), (xb, yb), (x2, y2), (xb, yb)):
            step(*b)
            seen.append(step.cache_size)
        pkg.amp.reset()
        pkg.amp.init("float16")
        try:
            step(xb, yb)
        finally:
            pkg.amp.reset()
        m1 = _series(pkg, "cachedop_cache_misses")
        deltas[pkg] = (
            _series(pkg, "cachedop_cache_hits").get((), 0) - h0,
            {k: v - m0.get(k, 0) for k, v in m1.items()
             if v != m0.get(k, 0)}, seen + [step.cache_size])
    assert deltas[mx] == deltas[mxj]
    assert deltas[mx][0] == 2
    assert deltas[mx][1] == {(("reason", "first"),): 1,
                             (("reason", "shape_change"),): 1,
                             (("reason", "scale_mode"),): 1}


def test_fallback_transparent_and_labelled():
    """A loss_fn that reads the loss on the host cannot be captured: the
    step still trains (the imperative path) and the reason starts with
    trace_error in both packages; the failed trial leaves no trace."""
    for pkg, net in zip((mxj, mx), _nets(bn=True)):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05})
        lossf = _lossf(pkg)

        def bad_loss(a, b):
            loss = lossf(net(a), b).mean()
            float(loss.asnumpy())
            return loss
        before = _weights(net)
        step = tr.capture(bad_loss)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            loss = step(*_batch(pkg))
        assert step.last_fallback_reason.startswith("trace_error")
        assert np.isfinite(float(loss.asnumpy()))
        after = _weights(net)
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))
        reasons = {s["labels"].get("reason", "") for s in
                   pkg.observability.registry().snapshot().get(
                       "cachedop_fallbacks", [])}
        assert any(r.startswith("trace_error") for r in reasons)
        if pkg is mx:
            assert step.last_fallback_reason == "trace_error:CaptureHostRead"
            # one imperative step from the same start: the failed trial
            # moved no weight and no running statistic
            ref = _nets(bn=True)[1]
            rtr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                                   {"learning_rate": 0.05})
            _imperative(mx, ref, rtr, 1, *_batch(mx))
            for a, b in zip(_weights(ref), after):
                np.testing.assert_array_equal(a, b)


class _SGDOwnUpdate(mx.optimizer.SGD):
    """An optimizer with its own imperative `update`."""

    def update(self, index, weight, grad, state):
        super().update(index, weight, grad, state)


def test_unsupported_optimizer_and_other_fallbacks():
    """An optimizer the fused rule cannot stand for falls back with the
    JAX reason `optimizer` (JAX: DCASGD); a Trainer without gradients
    with `no_grads`; a deferred initialisation with `deferred_init`."""
    jnet, tnet = _nets()
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "dcasgd",
                            {"learning_rate": 0.05})
    ttr = mx.gluon.Trainer(tnet.collect_params(),
                           _SGDOwnUpdate(learning_rate=0.05))
    reasons = []
    for pkg, net, tr in ((mxj, jnet, jtr), (mx, tnet, ttr)):
        lossf = _lossf(pkg)
        step = tr.capture(lambda a, b: lossf(net(a), b).mean())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            step(*_batch(pkg))
        reasons.append(step.last_fallback_reason)
    assert reasons == ["optimizer", "optimizer"]
    frozen = _nets()[1]
    for p in frozen.collect_params().values():
        p.grad_req = "null"
    tr = mx.gluon.Trainer(frozen.collect_params(), "sgd")
    step = tr.capture(lambda a, b: _lossf(mx)(frozen(a), b).mean())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(MXNetError):
            step(*_batch(mx))      # the imperative path has nothing either
    assert step.last_fallback_reason == "no_grads"
    lazy = _mlp(mx, 1, False)
    lazy.initialize(ctx=CPU)
    tr = mx.gluon.Trainer(lazy.collect_params(), "sgd")
    step = tr.capture(lambda a, b: _lossf(mx)(lazy(a), b).mean())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        step(*_batch(mx))
    assert step.last_fallback_reason == "deferred_init"
    with pytest.raises(MXNetError, match="sharded_update=True needs"):
        tr.capture(lambda a, b: a, sharded_update=True)


def test_captured_step_span_and_counters():
    """A `Trainer.captured_step` span while tracing, one
    `captured_step` dispatch a step, and the step counter ticks."""
    tracer = mx.observability.tracer
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05})
    step = tr.capture(lambda a, b: _lossf(mx)(net(a), b).mean())
    xb, yb = _batch(mx)
    step(xb, yb)
    steps0 = _series(mx, "trainer_steps")[()]
    mx.profiler.reset_dispatches()
    tracer.start()
    try:
        step(xb, yb)
    finally:
        tracer.stop()
    names = {e.get("name") for e in tracer.to_chrome_trace()["traceEvents"]}
    tracer.clear()
    assert "Trainer.captured_step" in names
    assert _series(mx, "trainer_steps")[()] == steps0 + 1
    assert mx.profiler.dispatch_count() == 1
    assert mx.profiler.jit_cache_stats() == (1, 0)
    assert step.last_compile_seconds is not None


def test_jit_step_convenience_and_save_load_states(tmp_path):
    """`mx.jit_step` is `Trainer.capture`; Adam's state after two captured
    steps (t on the device) round-trips through save_states / load_states
    and matches the JAX captured step's."""
    jnet, tnet = _nets()
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 0.05})
    tr = mx.gluon.Trainer(tnet.collect_params(), "adam",
                          {"learning_rate": 0.05})
    for pkg, net, t in ((mxj, jnet, jtr), (mx, tnet, tr)):
        lossf = _lossf(pkg)
        step = pkg.jit_step(t, lambda a, b: lossf(net(a), b).mean())
        assert isinstance(step, pkg.CachedStep)
        step(*_batch(pkg))
        step(*_batch(pkg))
    f = str(tmp_path / "states.bin")
    tr.save_states(f)
    tr2 = mx.gluon.Trainer(tnet.collect_params(), "adam",
                           {"learning_rate": 0.05})
    tr2.load_states(f)
    assert tr2._optimizer.num_update == tr._optimizer.num_update == 2
    for k, v in tr._updater.states.items():
        assert int(v[2]._data) == 2
        for a, b, c in zip(v, tr2._updater.states[k],
                           jtr._updater.states[k]):
            assert torch.equal(a._data, b._data)
            np.testing.assert_allclose(a.asnumpy(), np.asarray(c._data),
                                       **ADAM_TOL)


def test_lr_schedule_rides_without_a_new_entry():
    """A new learning rate between captured steps makes no new cache
    entry and is honoured, in both packages, and matches the JAX
    package and the port's imperative steps."""
    out = {}
    for pkg, net in zip((mxj, mx), _nets()):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05})
        lossf = _lossf(pkg)
        step = tr.capture(lambda a, b: lossf(net(a), b).mean())
        step(*_batch(pkg))
        tr.set_learning_rate(0.005)
        step(*_batch(pkg))
        assert step.cache_size == 1
        out[pkg] = _weights(net)
    _close(out[mx], out[mxj], TOL, "lr schedule")
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05})
    _imperative(mx, net, tr, 1, *_batch(mx))
    tr.set_learning_rate(0.005)
    _imperative(mx, net, tr, 1, *_batch(mx))
    for a, b in zip(_weights(net), out[mx]):
        np.testing.assert_array_equal(a, b)


def test_captured_parity_multi_precision():
    """bf16 weights with fp32 masters: the captured update stages the
    master as the JAX captured step does."""
    out = {}
    for pkg, net in zip((mxj, mx), _nets()):
        net.cast("bfloat16")
        xb, yb = _batch(pkg)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "multi_precision": True})
        _captured(pkg, net, tr, 3, xb.astype("bfloat16"), yb)
        out[pkg] = _weights(net)
        if pkg is mx:
            assert all(st[0]._data.dtype == torch.float32
                       for st in tr._updater.states.values())
    _close(out[mx], out[mxj], MP_TOL, "mp")


def test_captured_interleaves_with_imperative_steps():
    """Captured and imperative steps share the optimizer state: a mixed
    loop equals an all-imperative one, and the JAX mixed loop."""
    out = {}
    for pkg, net in zip((mxj, mx), _nets()):
        tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.05})
        lossf = _lossf(pkg)
        step = tr.capture(lambda a, b: lossf(net(a), b).mean())
        xb, yb = _batch(pkg)
        for k in range(4):
            if k % 2 == 0:
                step(xb, yb)
            else:
                _imperative(pkg, net, tr, 1, xb, yb)
        out[pkg] = _weights(net)
    _close(out[mx], out[mxj], ADAM_TOL, "mixed")
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.05})
    _imperative(mx, net, tr, 4, *_batch(mx))
    for a, b in zip(_weights(net), out[mx]):
        np.testing.assert_array_equal(a, b)


def test_frozen_params_read_live():
    """Fine-tuning a head over a frozen backbone outside the Trainer:
    `set_data` on the backbone shows in the next captured loss at once,
    with no new entry, as in the JAX package."""
    for pkg in (mxj, mx):
        pkg.random.seed(0)
        backbone = pkg.gluon.nn.Dense(16, activation="relu")
        head = pkg.gluon.nn.Dense(CLS)
        net = pkg.gluon.nn.Sequential()
        net.add(backbone, head)
        if pkg is mx:
            net.initialize(mx.init.Xavier(), ctx=CPU)
        else:
            net.initialize(mxj.init.Xavier())
        xb, yb = _batch(pkg)
        net(xb)
        tr = pkg.gluon.Trainer(head.collect_params(), "sgd",
                               {"learning_rate": 0.05})
        lossf = _lossf(pkg)
        step = tr.capture(lambda a, b: lossf(net(a), b).mean())
        l0 = float(step(xb, yb).asnumpy())
        for p in backbone.collect_params().values():
            if pkg is mx:
                p.set_data(mx.nd.zeros(p.shape, ctx=CPU))
            else:
                p.set_data(mxj.nd.zeros(p.shape))
        expected = float(lossf(net(xb), yb).mean().asnumpy())
        l1 = float(step(xb, yb).asnumpy())
        assert step.last_fallback_reason is None
        assert step.cache_size == 1
        assert abs(l1 - l0) > 1e-4
        np.testing.assert_allclose(l1, expected, rtol=2e-4)


def test_captured_single_dispatch_per_step():
    """One dispatch a warm captured step and a pure cache hit, where the
    per-parameter path takes one a parameter (the JAX test's counts).
    On the CPU the step program runs its ops eagerly; the card test
    below checks that no eager op runs there."""
    net_u = _nets()[1]
    tr_u = mx.gluon.Trainer(net_u.collect_params(), "sgd",
                            {"learning_rate": 0.05}, fused=False)
    xb, yb = _batch(mx)
    with mx.autograd.record():
        loss = _lossf(mx)(net_u(xb), yb).mean()
    loss.backward()
    mx.profiler.reset_dispatches()
    tr_u.step(BATCH)
    imperative = mx.profiler.dispatch_count()
    assert imperative == len(net_u.collect_params())
    net = _nets()[1]
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    step = tr.capture(lambda a, b: _lossf(mx)(net(a), b).mean())
    for _ in range(2):
        step(xb, yb)
    mx.profiler.reset_dispatches()
    step(xb, yb)
    assert mx.profiler.dispatch_count() == 1 < imperative
    assert mx.profiler.jit_cache_stats() == (1, 0)


def _dropout_losses(ctx, steps=3):
    """Losses of `steps` captured steps of a Dropout(0.5) MLP at lr 0
    (the weights never move, so only the masks change the loss)."""
    mx.random.seed(0)
    net = mx.gluon.nn.Sequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu"),
            mx.gluon.nn.Dropout(0.5), mx.gluon.nn.Dense(CLS))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    xb, yb = _batch(mx, ctx=ctx)
    net(xb)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.0})
    before = _weights(net)
    step = tr.capture(lambda a, b: _lossf(mx)(net(a), b).mean())
    losses = [float(step(xb, yb).asnumpy()) for _ in range(steps)]
    assert step.last_fallback_reason is None and step.cache_size == 1
    for a, b in zip(before, _weights(net)):
        np.testing.assert_array_equal(a, b)
    return losses


def test_dropout_draws_new_masks_each_step():
    """Dropout inside a captured step draws from the device's generator
    at every call: at lr 0 the losses of three steps all differ."""
    losses = _dropout_losses(CPU)
    assert len(set(losses)) == 3, losses


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is a CUDA graph only there")
    return mx.gpu(0)


def _port_net(ctx):
    """The MLP in the port alone (Xavier from `mx.random.seed(0)`)."""
    mx.random.seed(0)
    net = _mlp(mx, 3, False)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(_batch(mx, ctx=ctx)[0])
    return net


@pytest.mark.card
def test_card_warm_step_is_one_graph_launch():
    """On the card a warm captured step is one graph replay: no NDArray
    op runs eagerly, one `captured_step` dispatch, one more
    `cudagraph_replays`."""
    from mxnet_tpu_torch.ndarray import ndarray as nd_mod
    ctx = _card()
    net = _port_net(ctx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    step = tr.capture(lambda a, b: _lossf(mx)(net(a), b).mean())
    xb, yb = _batch(mx, ctx=ctx)
    for _ in range(2):
        step(xb, yb)
    calls = [0]
    orig = nd_mod._apply

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)
    replays = _series(mx, "cudagraph_replays").get((), 0)
    mx.profiler.reset_dispatches()
    nd_mod._apply = counting
    try:
        step(xb, yb)
    finally:
        nd_mod._apply = orig
    assert calls[0] == 0
    assert mx.profiler.dispatch_count() == 1
    assert _series(mx, "cudagraph_replays")[()] == replays + 1
    assert step.last_fallback_reason is None


@pytest.mark.card
def test_card_replay_equals_its_eager_step():
    """On the card 3 replays give the weights and losses of 3 eager
    fused steps from the same start, bit for bit (Dense layers only:
    cuBLAS runs the same products, and no atomic sum is involved)."""
    ctx = _card()
    out = {}
    for captured in (True, False):
        net = _port_net(ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.05})
        xb, yb = _batch(mx, ctx=ctx)
        fn = _captured if captured else _imperative
        out[captured] = (fn(mx, net, tr, 3, xb, yb), _weights(net))
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.card
def test_card_dropout_draws_new_masks_each_replay():
    """On the card the graph registers the device's dropout generator:
    each replay draws new masks (three different losses at lr 0)."""
    losses = _dropout_losses(_card())
    assert len(set(losses)) == 3, losses
