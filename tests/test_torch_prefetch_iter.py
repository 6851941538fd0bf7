"""`io.PrefetchingIter` on the dependency engine, without JAX (its `card`
tests run on the card's machine too): the batches of the iterator it
wraps, in order, through its own TaskGroup (an iterator that is not the
port's) or a `prefetch.DevicePrefetcher` (the port's iterators, or
`prefetch_to_device=`); `close()` drops the queued fetch and stops
consuming the backing iterator, `reset()` reopens it; a worker error
surfaces once and the next call goes on. On a card: the batch staged by
`prefetch_to_device=mx.gpu(0)` equals the `ctx=mx.cpu()` batch bit for
bit, and no engine thread makes a CUDA call."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine
from mxnet_tpu_torch import io as mio

CPU = mx.cpu()


def _arrays(n=10):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 3, 4).astype(np.float32),
            np.arange(n).astype(np.float32))


class CountingIter(mio.DataIter):
    """A foreign iterator (no ctx): counts the batches it is asked for."""

    def __init__(self, limit=100):
        super().__init__(2)
        self.calls = 0
        self.limit = limit

    def reset(self):
        self.calls = 0

    def next(self):
        self.calls += 1
        if self.calls > self.limit:
            raise StopIteration
        return mio.DataBatch([mx.nd.array(np.full((2, 3), self.calls),
                                          ctx=CPU)],
                             [mx.nd.array(np.zeros(2), ctx=CPU)])


class SlowIndexedIter(mio.NDArrayIter):
    """The port's NDArrayIter (ctx: the DevicePrefetcher path) whose
    host batches count and wait on an event."""

    def __init__(self, gate, **kw):
        super().__init__(*_arrays(40), batch_size=2, ctx=CPU, **kw)
        self.gate = gate
        self.made = 0

    def _next_host(self):
        self.gate.wait(10)
        self.made += 1
        return super()._next_host()


@pytest.mark.parametrize("target", [None, "cpu"])
def test_batches_match_the_plain_iterator(target):
    data, label = _arrays()
    for handle in ("pad", "discard", "roll_over"):
        plain = mio.NDArrayIter(data, label, batch_size=4, ctx=CPU,
                                last_batch_handle=handle)
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in plain]
        pf = mio.PrefetchingIter(
            mio.NDArrayIter(data, label, batch_size=4, ctx=CPU,
                            last_batch_handle=handle),
            prefetch_to_device=CPU if target else None)
        assert pf._pf is not None          # the port's iterator: staged
        for _ in range(2):                 # and again after reset()
            got = [(b.data[0], b.label[0], b.pad) for b in pf]
            assert len(got) == len(want)
            for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
                assert gd.context == CPU and gp == wp
                np.testing.assert_array_equal(gd.asnumpy(), wd)
                np.testing.assert_array_equal(gl.asnumpy(), wl)
            pf.reset()
        pf.close()


def test_a_resize_iter_over_the_ports_iterator_is_staged():
    """ResizeIter passes its inner iterator's host batches and ctx on, so
    a PrefetchingIter over it stages them (no device copy on an engine
    thread)."""
    data, label = _arrays()
    want = [b.data[0].asnumpy() for b in mio.ResizeIter(
        mio.NDArrayIter(data, label, batch_size=4, ctx=CPU), 5)]
    pf = mio.PrefetchingIter(mio.ResizeIter(
        mio.NDArrayIter(data, label, batch_size=4, ctx=CPU), 5))
    assert pf._pf is not None
    got = [b.data[0].asnumpy() for b in pf]
    pf.close()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("staged", [False, True])
def test_close_drops_the_queued_fetch_and_reset_reopens(staged):
    """close() / __del__: the queued fetch never runs and the backing
    iterator stops being consumed; next() then raises StopIteration;
    reset() reopens."""
    base = CountingIter()
    pf = mio.PrefetchingIter(base, prefetch_to_device=CPU if staged
                             else None)
    assert (pf._pf is not None) == staged
    first = pf.next()
    assert first.data[0].asnumpy()[0, 0] == 1
    pf.close()
    engine.wait_for_all()
    settled = base.calls
    assert settled <= 4
    with pytest.raises(StopIteration):
        pf.next()
    engine.wait_for_all()
    assert base.calls == settled
    pf.reset()
    assert pf.next().data[0].asnumpy()[0, 0] == 1
    pf.close()


def test_close_cancels_a_fetch_still_queued_behind_a_slow_one():
    """With the first staging task held, close() cancels the tasks queued
    behind it: they never make a batch."""
    gate = threading.Event()
    base = SlowIndexedIter(gate)
    pf = mio.PrefetchingIter(base)
    assert pf._pf is not None and pf._pf.depth >= 1
    staged = pf._pf
    closer = threading.Thread(target=pf.close)
    closer.start()
    for _ in range(1000):            # close() has flagged its tasks
        if staged._state.closed:
            break
        threading.Event().wait(0.01)
    assert staged._state.closed
    gate.set()                       # the held task finishes; no other
    closer.join(10)
    assert not closer.is_alive()
    engine.wait_for_all()
    assert base.made <= 1
    with pytest.raises(StopIteration):
        pf.next()


@pytest.mark.parametrize("staged", [False, True])
def test_a_worker_error_surfaces_once(staged):
    class Flaky(CountingIter):
        def __init__(self):
            super().__init__(limit=4)
            self.fail_once = True

        def next(self):
            if self.calls == 1 and self.fail_once:
                self.calls += 1
                self.fail_once = False
                raise RuntimeError("worker-boom")
            return super().next()

    pf = mio.PrefetchingIter(Flaky(), prefetch_to_device=CPU if staged
                             else None)

    def first(b):
        return int(b.data[0].asnumpy()[0, 0])
    assert first(pf.next()) == 1
    with pytest.raises(RuntimeError, match="worker-boom"):
        pf.next()
    assert first(pf.next()) == 3          # usable right after the error
    assert [first(b) for b in pf] == [4]
    pf.reset()
    assert [first(b) for b in pf] == [1, 2, 3, 4]
    pf.close()


def test_many_prefetching_iters_at_once_keep_order_and_pads():
    """More consumers than cores, each with its own PrefetchingIter, at a
    short switch interval: every batch, its pad and its order as the
    plain iterator's (the fields a staging task hands over beside the
    arrays)."""
    import sys
    data, label = _arrays(13)
    plain = [(b.data[0].asnumpy(), b.pad) for b in mio.NDArrayIter(
        data, label, batch_size=3, ctx=CPU)]
    errors = []

    def consume():
        try:
            for _ in range(3):
                pf = mio.PrefetchingIter(mio.NDArrayIter(
                    data, label, batch_size=3, ctx=CPU))
                got = [(b.data[0].asnumpy(), b.pad) for b in pf]
                pf.close()
                assert len(got) == len(plain)
                for (g, gp), (w, wp) in zip(got, plain):
                    assert gp == wp and np.array_equal(g, w)
        except BaseException as e:      # reported below
            errors.append(e)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_one_backing_iterator_only():
    data, label = _arrays()
    it = mio.NDArrayIter(data, label, batch_size=2, ctx=CPU)
    with pytest.raises(mx.MXNetError, match="one backing iter"):
        mio.PrefetchingIter([it, it])


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mx.gpu(0)


class _CudaCallThreads:
    """Spies on the tensor methods that reach the card from a host batch
    (`to` / `copy_` with a CUDA end, `pin_memory`) and records the name
    of each calling thread."""

    def __init__(self):
        self.names = []
        self._real = {}

    def __enter__(self):
        names = self.names

        def wrap(name, touches):
            real = getattr(torch.Tensor, name)

            def spy(t, *args, **kwargs):
                out = real(t, *args, **kwargs)
                if touches(t, out, args):
                    names.append(threading.current_thread().name)
                return out
            self._real[name] = real
            setattr(torch.Tensor, name, spy)
        wrap("to", lambda t, out, a: out.is_cuda or t.is_cuda)
        wrap("copy_", lambda t, out, a: t.is_cuda or (
            a and isinstance(a[0], torch.Tensor) and a[0].is_cuda))
        wrap("pin_memory", lambda t, out, a: True)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(torch.Tensor, name, real)


@pytest.mark.card
def test_card_prefetch_to_device_delivers_the_cpu_batch(card):
    """`prefetch_to_device=mx.gpu(0)` over a ctx=mx.cpu() iterator: each
    batch on the card, bit for bit the host batch, and every call that
    reaches the card made by the consuming thread, none by an engine
    thread."""
    data, label = _arrays(12)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b in mio.NDArrayIter(data, label, batch_size=4, ctx=CPU)]
    with _CudaCallThreads() as spy:
        pf = mio.PrefetchingIter(
            mio.NDArrayIter(data, label, batch_size=4, ctx=CPU),
            prefetch_to_device=card)
        got = [(b.data[0], b.label[0]) for b in pf]
        pf.close()
    torch.cuda.synchronize()
    assert len(got) == len(want) == 3
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd._data.is_cuda and gl._data.is_cuda
        np.testing.assert_array_equal(gd.asnumpy(), wd)
        np.testing.assert_array_equal(gl.asnumpy(), wl)
    main = threading.current_thread().name
    assert spy.names and set(spy.names) == {main}, spy.names


@pytest.mark.card
def test_card_image_iter_on_the_card_equals_the_cpu_batch(card, tmp_path):
    """An ImageIter over a PNG pack with ctx=mx.gpu(0), through a
    PrefetchingIter, gives the ctx=mx.cpu() iterator's batches bit for
    bit (the decode and the augmenters run on the host either way)."""
    rng = np.random.RandomState(0)
    rec, idx = str(tmp_path / "p.rec"), str(tmp_path / "p.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(8):
        img = rng.randint(0, 256, (24, 30, 3)).astype(np.uint8)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".png"))
    w.close()

    def batches(ctx, prefetch):
        aug = mx.image.CreateAugmenter((3, 20, 20), rand_crop=True,
                                       rand_mirror=True, mean=True, std=True)
        it = mx.image.ImageIter(4, (3, 20, 20), path_imgrec=rec,
                                path_imgidx=idx, shuffle=True, aug_list=aug,
                                ctx=ctx)
        if prefetch:
            it = mio.PrefetchingIter(it)
        np.random.seed(1)
        out = [(b.data[0], b.label[0]) for b in it]
        if prefetch:
            it.close()
        return out
    want = batches(CPU, False)
    with _CudaCallThreads() as spy:
        got = batches(card, True)
    assert set(spy.names) == {threading.current_thread().name}
    assert len(got) == len(want) == 2
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd._data.is_cuda
        assert torch.equal(gd._data.cpu(), wd._data)
        assert torch.equal(gl._data.cpu(), wl._data)
