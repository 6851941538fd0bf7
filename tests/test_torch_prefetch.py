"""`mxnet_tpu_torch.prefetch.DevicePrefetcher` and the DataLoader's
`prefetch_to_device=` / `pin_memory=True`: the same batches in the same
order as the plain loader, the telemetry (`prefetch_batches`,
`prefetch_depth`, `prefetch_starved`, the staging histograms), failure
and cancellation, the bounded-queue degrade, and the refusals (no
quiet staging on the CPU for a card, `RowPrefetcher`
[5d]). No JAX here: the reference is the port's own plain loader, so
the `card` tests run on the card's machine (`--noconftest -m card`)."""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine, prefetch
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import registry

CPU = mx.cpu()


def _value(name):
    return registry().counter(name).value


def _dataset(n=50, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, 4).astype(np.float32)
    ids = rng.randint(0, 100, size=(n, 5)).astype(np.int32)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    return mx.gluon.data.ArrayDataset(x, ids, y)


def _as_numpy(batches):
    return [tuple(b.asnumpy() for b in batch) for batch in batches]


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(prefetch_to_device=True),
    dict(pin_memory=True),
    dict(prefetch_to_device=True, prefetch=0),
    dict(prefetch_to_device=CPU, num_workers=2, last_batch="discard"),
    dict(prefetch_to_device=True, last_batch="rollover"),
], ids=["device", "pin_memory", "no_host_prefetch", "explicit_ctx",
        "rollover"])
def test_loader_gives_the_plain_loaders_batches_in_order(kw):
    """Two epochs of each staged loader against the plain one (the same
    sampler, seeded), batch by batch, every field's dtype and values; the
    staged batches are NDArrays on the loader's device."""
    ds = _dataset()
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("prefetch_to_device", "pin_memory")}
    for shuffle in (False, True):
        np.random.seed(3)
        staged = mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU,
                                          shuffle=shuffle, **kw)
        got = [_as_numpy(staged) for _ in range(2)]
        np.random.seed(3)
        plain = mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU,
                                         shuffle=shuffle, **plain_kw)
        ref = [_as_numpy(plain) for _ in range(2)]
        for g, r in zip(got, ref):
            _assert_same(g, r)
    batch = next(iter(staged))
    assert all(isinstance(b, mx.nd.NDArray) and b.context == CPU
               for b in batch)


def test_explicit_false_keeps_the_host_path():
    dl = mx.gluon.data.DataLoader(_dataset(), batch_size=8, ctx=CPU,
                                  pin_memory=True, prefetch_to_device=False)
    b0 = _value("prefetch_batches")
    assert len(list(dl)) == 7
    assert _value("prefetch_batches") == b0


def test_prefetcher_over_any_iterable_and_its_counters():
    """Nested tuples / lists of numpy arrays, tensors and NDArrays: the
    same structure back as CPU NDArrays (float64 narrowed to float32),
    one `prefetch_batches` a batch, the depth gauge back to 0 at the end,
    a `prefetch_h2d_bytes` observation a batch."""
    rng = np.random.RandomState(1)
    src = [(rng.randn(2, 3), [torch.arange(4) + i,
                              mx.nd.array(np.full(2, i), ctx=CPU)])
           for i in range(6)]
    b0 = _value("prefetch_batches")
    h = registry().histogram("prefetch_h2d_bytes", base=1.0)
    n0 = h.snapshot()["count"]
    with prefetch.DevicePrefetcher(src, device=CPU, depth=3) as pf:
        assert pf.depth == 3
        out = list(pf)
    assert len(out) == 6
    for (x, (t, a)), (gx, (gt, ga)) in zip(src, out):
        assert gx.dtype == np.float32
        np.testing.assert_array_equal(gx.asnumpy(), x.astype(np.float32))
        np.testing.assert_array_equal(gt.asnumpy(), t.numpy())
        np.testing.assert_array_equal(ga.asnumpy(), a.asnumpy())
    assert _value("prefetch_batches") == b0 + 6
    assert registry().gauge("prefetch_depth").value == 0
    assert h.snapshot()["count"] == n0 + 6
    assert pf.in_flight == 0


def test_starved_counts_an_input_bound_loop():
    """A source slower than the loop: after the first `depth` batches
    (the fill), each batch the consumer waits for counts as starved."""
    def slow():
        for i in range(6):
            time.sleep(0.05)
            yield np.full(3, i, np.float32)
    s0 = _value("prefetch_starved")
    out = list(prefetch.DevicePrefetcher(slow(), device=CPU, depth=2))
    assert [int(b.asnumpy()[0]) for b in out] == list(range(6))
    assert _value("prefetch_starved") >= s0 + 3


def test_staging_failure_raises_once_and_the_pipeline_goes_on():
    def src():
        for i in range(6):
            if i == 2:
                raise ValueError("bad record")
            yield np.full(2, i, np.float32)
    pf = prefetch.DevicePrefetcher(src(), device=CPU, depth=2)
    got = [next(pf).asnumpy()[0], next(pf).asnumpy()[0]]
    with pytest.raises(ValueError, match="bad record"):
        next(pf)
    # a generator is finished once it raised: the pipeline ends cleanly
    assert list(pf) == []
    pf.close()
    engine.clear_failures()
    assert got == [0.0, 1.0]


def test_close_cancels_and_closes_the_source():
    closed = threading.Event()

    def gen():
        try:
            for i in range(1000):
                yield np.full(2, i, np.float32)
        finally:
            closed.set()
    pf = prefetch.DevicePrefetcher(gen(), device=CPU)
    assert next(pf).asnumpy()[0] == 0.0
    pf.close()
    engine.wait_for_all()
    assert closed.is_set() and pf.in_flight == 0
    with pytest.raises(StopIteration):
        next(pf)


def test_rejected_staging_degrades_to_inline():
    """A bounded background class under `reject`: each slot stages in the
    consuming thread instead of raising; the batches stay in order."""
    gate = threading.Event()
    blockers = [engine.push(gate.wait) for _ in range(engine.num_workers())]
    time.sleep(0.05)
    engine.push(lambda: None, priority=engine.PRIORITY_BACKGROUND)
    time.sleep(0.05)
    prev = engine.set_queue_limit(engine.PRIORITY_BACKGROUND, 1, "reject")
    try:
        src = [np.full(2, i, np.float32) for i in range(5)]
        pf = prefetch.DevicePrefetcher(src, device=CPU)
        got = [int(b.asnumpy()[0]) for b in pf]
    finally:
        engine.set_queue_limit(engine.PRIORITY_BACKGROUND, *prev)
        gate.set()
        engine.wait_for_all()
    assert got == list(range(5))


def test_the_card_is_never_quietly_replaced(monkeypatch):
    """Without CUDA, staging for the card raises instead of staging on
    the CPU, for a store on the card too; RowPrefetcher raises [5d]."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        prefetch.DevicePrefetcher([np.zeros(2)])
    with pytest.raises(MXNetError, match="CUDA"):
        mx.gluon.data.DataLoader(_dataset(), batch_size=4,
                                 prefetch_to_device=True)
    with pytest.raises(MXNetError, match="CUDA"):
        prefetch.resolve_placement("cuda:0")

    class Store:
        device = "cuda:0"

        def batch_sharding(self):
            return None
    with pytest.raises(MXNetError, match="CUDA"):
        prefetch.resolve_placement(Store())
    with pytest.raises(MXNetError, match="CUDA"):
        mx.kv.create("dist_sync")
    with pytest.raises(MXNetError, match=r"\[5d\]"):
        prefetch.RowPrefetcher([], None, {})
    assert prefetch.resolve_placement(None) is None
    assert prefetch.resolve_placement(False) is None


def test_place_equals_the_plain_loaders_batch():
    """`place(batch, device)` on each of the plain loader's host batches,
    whole and nested in a list: the same structure back, each leaf an
    NDArray on the device equal to the plain loader's."""
    ds = _dataset()
    plain = list(mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU))
    host = list(mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU)
                ._plain_iter(to_device=False))
    assert len(host) == len(plain)
    for h, ref in zip(host, plain):
        got = prefetch.place(h, CPU)
        assert type(got) is type(h)
        assert all(isinstance(g, mx.nd.NDArray) and g.context == CPU
                   for g in got)
        _assert_same([tuple(g.asnumpy() for g in got)], _as_numpy([ref]))
        nested = prefetch.place([h[0], (h[1], h[2])], CPU)
        _assert_same([(nested[0].asnumpy(), nested[1][0].asnumpy(),
                       nested[1][1].asnumpy())], _as_numpy([ref]))


def test_a_pinned_set_fits_only_its_batchs_host_leaves():
    """A set fits a batch when it holds a CPU buffer of each CPU leaf's
    shape and dtype and no slot (None) for a leaf off the CPU (here on
    the meta device, standing in for a card): a leaf already on a card
    is never copied into."""
    host = [torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32),
            torch.empty(2, device="meta")]
    fits = [torch.empty(4, 3), torch.empty(4, dtype=torch.int32), None]
    assert prefetch._matches(fits, host)
    assert not prefetch._matches(None, host)
    assert not prefetch._matches(fits[:2], host)
    assert not prefetch._matches(fits[:2] + [torch.empty(2)], host)
    assert not prefetch._matches(fits[:2] + [host[2]], host)
    assert not prefetch._matches([torch.empty(4, 4)] + fits[1:], host)
    assert not prefetch._matches(
        [fits[0], torch.empty(4, dtype=torch.int64), None], host)
    assert not prefetch._matches(
        [torch.empty(4, 3, device="meta")] + fits[1:], host)
    assert not prefetch._matches([None] + fits[1:], host)


def _mlp(ctx):
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, in_units=12, activation="relu"),
                mx.gluon.nn.Dense(10, in_units=16))
    net.initialize(ctx=ctx)
    return net


def _train(ctx, staged, captured, steps=4):
    """A few SGD steps of a small MLP on the loader's batches, staged or
    not, eager or captured: the losses."""
    net = _mlp(ctx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(x, ids, y):
        return ce(net(x.reshape((x.shape[0], -1))), y).mean()
    step = tr.capture(loss_fn) if captured else None
    kw = dict(prefetch_to_device=tr) if staged else {}
    dl = mx.gluon.data.DataLoader(_dataset(40), batch_size=8, ctx=ctx, **kw)
    losses = []
    for i, (x, ids, y) in enumerate(dl):
        if i == steps:
            break
        if step is not None:
            losses.append(float(step(x, ids, y).asnumpy()))
        else:
            with mx.autograd.record():
                loss = loss_fn(x, ids, y)
            loss.backward()
            tr.step(x.shape[0])
            losses.append(float(loss.asnumpy()))
    return losses, step


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_training_from_the_prefetcher_equals_the_plain_loader(captured):
    """`prefetch_to_device=trainer` (the device of its parameters) feeds
    the eager step and `Trainer.capture` the same batches: the same
    losses, bit for bit, as the plain loader's."""
    ref, _ = _train(CPU, False, captured)
    got, step = _train(CPU, True, captured)
    assert got == ref
    if step is not None:
        assert step.last_fallback_reason is None


# -------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned buffers and streams")
    return mx.gpu(0)


@pytest.mark.card
def test_card_batches_equal_the_host_batches_behind_a_long_kernel():
    """On the card, with a long kernel queued ahead of every batch on the
    step's stream: each delivered batch equals its host batch (the
    copies ride the side stream, the step's stream waits on their
    events, the pinned sets are reused only after their copies), and
    fetching a warm batch makes no synchronizing call."""
    dev = _card()
    rng = np.random.RandomState(0)
    host = [(rng.randn(64, 256).astype(np.float32),
             rng.randint(0, 1000, size=(64, 128)).astype(np.int32))
            for _ in range(12)]
    pf = prefetch.DevicePrefetcher(host, device=dev)
    out = []
    syncs = 0
    for i in range(len(host)):
        torch.cuda._sleep(20_000_000)            # tens of ms of device time
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                x, ids = next(pf)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if i >= 2:
            syncs += sum("synchroniz" in str(w.message) for w in caught)
        out.append((x._data * 1.0, ids._data + 0))   # read on the stream
    pf.close()
    torch.cuda.synchronize()
    for (hx, hi), (x, ids) in zip(host, out):
        assert x.is_cuda and ids.dtype == torch.int32
        assert torch.equal(x.cpu(), torch.from_numpy(hx))
        assert torch.equal(ids.cpu(), torch.from_numpy(hi))
    assert syncs == 0


@pytest.mark.card
def test_card_captured_step_gets_no_synchronous_copy():
    """On the card the DataLoader's staged batches reach the captured
    step on its device: `prefetch_h2d_sync` does not move, and the
    losses equal those of batches already on the card."""
    dev = _card()
    s0 = prefetch.sync_h2d_count()
    got, step = _train(dev, True, True)
    assert prefetch.sync_h2d_count() == s0
    assert step.last_fallback_reason is None
    ref, _ = _train(dev, False, True)
    assert got == ref


@pytest.mark.card
def test_card_source_already_on_the_card_passes_through():
    """A source of batches whose first leaf already lies on the card (a
    card NDArray) and whose second is host numpy: every delivered batch,
    all held to the end, still equals its source; the card leaf is the
    source's own tensor, and the pinned sets hold no slot for it."""
    dev = _card()
    rng = np.random.RandomState(2)
    src = [(mx.nd.array(rng.randn(32, 64).astype(np.float32), ctx=dev),
            rng.randint(0, 1000, size=(32, 16)).astype(np.int32))
           for _ in range(10)]
    keep = [(a.asnumpy(), b.copy()) for a, b in src]
    pf = prefetch.DevicePrefetcher(src, device=dev)
    out = list(pf)
    torch.cuda.synchronize()
    assert len(out) == len(src)
    for (a, _), (x, ids) in zip(src, out):
        assert x._data is a._data
    for (ka, kb), (x, ids) in zip(keep, out):
        np.testing.assert_array_equal(x.asnumpy(), ka)
        np.testing.assert_array_equal(ids.asnumpy(), kb)
    assert pf._owned and all(s[0] is None and s[1].device.type == "cpu"
                             for s in pf._owned)
    pf.close()
    # every leaf on the card: nothing is pinned at all
    pf = prefetch.DevicePrefetcher([a for a, _ in src], device=dev)
    got = list(pf)
    assert [g._data is a._data for g, (a, _) in zip(got, src)] == \
        [True] * len(src)
    assert pf._owned == []
    pf.close()


@pytest.mark.card
def test_card_alternating_shapes_keep_the_pinned_sets_bounded():
    """Batches of two shapes in turn (a bucketed loader): at most
    `2 * depth` pinned sets live at any time, sets are reused rather
    than made a batch, and every batch, held to the end, is right."""
    dev = _card()
    rng = np.random.RandomState(3)
    host = [rng.randn(64 if i % 2 else 48, 32).astype(np.float32)
            for i in range(40)]
    pf = prefetch.DevicePrefetcher(host, device=dev)
    out, most, seen = [], 0, set()
    for b in pf:
        out.append(b)
        most = max(most, len(pf._owned))
        seen.update(id(s) for s in pf._owned)
    torch.cuda.synchronize()
    assert most <= 2 * pf.depth
    assert len(seen) < len(host) // 2
    for h, b in zip(host, out):
        np.testing.assert_array_equal(b.asnumpy(), h)
    pf.close()


@pytest.mark.card
def test_card_place_equals_the_plain_loaders_batch():
    dev = _card()
    ds = _dataset()
    plain = list(mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU))
    host = mx.gluon.data.DataLoader(ds, batch_size=8, ctx=CPU) \
        ._plain_iter(to_device=False)
    for h, ref in zip(host, plain):
        got = prefetch.place(h, torch.device(dev))
        assert all(g._data.is_cuda for g in got)
        _assert_same([tuple(g.asnumpy() for g in got)], _as_numpy([ref]))
