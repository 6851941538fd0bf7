"""The port's `gluon.data` on the CPU against the JAX package's: datasets
and their transforms / filters / shards, the samplers, `BatchSampler`'s
last-batch modes, DataLoader batches and their order for the same numpy
seed (on the engine, prefetch 0 and a custom batchify), the procedurally
generated MNIST / FashionMNIST / CIFAR samples bit for bit, and the
vision transforms. Integer and structural outputs must match exactly;
float transforms within the rtol / atol stated beside each (one fp32
rounding where the two frameworks order a product differently, and the
antialiased resize's filter arithmetic)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

CPU = mx.cpu()


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------
def test_datasets_match():
    xs = np.arange(20, dtype=np.float32).reshape(10, 2)
    ys = np.arange(10)
    for mod in (jdata, tdata):
        assert len(mod.ArrayDataset(xs, ys)) == 10
    pairs = [(jdata.ArrayDataset(xs, ys), tdata.ArrayDataset(xs, ys)),
             (jdata.SimpleDataset(list(range(7))),
              tdata.SimpleDataset(list(range(7))))]
    for jd, td in pairs:
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _same(td[i], jd[i])
        for derive in (lambda d: d.take(4), lambda d: d.shard(3, 1),
                       lambda d: d.filter(lambda it: (
                           (it[1] if isinstance(it, tuple) else it) % 2)
                           == 0),
                       lambda d: d.transform(
                           lambda *a: a[0] * 2 if len(a) > 1 else a[0] + 1),
                       lambda d: d.transform_first(lambda x: x * 3)):
            jd2, td2 = derive(jd), derive(td)
            assert len(td2) == len(jd2)
            for i in range(len(jd2)):
                _same(td2[i], jd2[i])


def test_samplers_match():
    for seed in (0, 3):
        np.random.seed(seed)
        want = list(jdata.RandomSampler(17))
        np.random.seed(seed)
        assert list(tdata.RandomSampler(17)) == want
    assert list(tdata.SequentialSampler(5, start=2)) == \
        list(jdata.SequentialSampler(5, start=2))
    for rollover in (True, False):
        assert list(tdata.IntervalSampler(10, 3, rollover)) == \
            list(jdata.IntervalSampler(10, 3, rollover))
    ds = list(range(12))
    assert list(tdata.FilterSampler(lambda x: x % 3 == 0, ds)) == \
        list(jdata.FilterSampler(lambda x: x % 3 == 0, ds))


@pytest.mark.parametrize("mode", ["keep", "discard", "rollover"])
def test_batch_sampler_last_batch_modes(mode):
    """Each mode over two epochs (rollover carries the tail into the
    next epoch) and len() before and after, as the JAX sampler."""
    j = jdata.BatchSampler(jdata.SequentialSampler(10), 4, mode)
    t = tdata.BatchSampler(tdata.SequentialSampler(10), 4, mode)
    for _ in range(2):
        assert len(t) == len(j)
        assert list(t) == list(j)
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bogus"))


# ---------------------------------------------------------------------------
# the vision datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,train", [("MNIST", True), ("MNIST", False),
                                        ("FashionMNIST", True),
                                        ("CIFAR10", True),
                                        ("CIFAR100", False)])
def test_vision_samples_bit_for_bit(name, train):
    """Samples, labels, lengths and the host placement: the JAX
    package's bits (the same numpy draws)."""
    jd = getattr(jdata.vision, name)(train=train)
    td = getattr(tdata.vision, name)(train=train)
    assert len(td) == len(jd)
    for i in (0, 1, 7, 12345, len(jd) - 1):
        (tx, ty), (jx, jy) = td[i], jd[i]
        assert tx.context.type == "cpu"
        _same(tx, jx)
        assert type(ty) is type(jy) and ty == jy


def test_vision_samples_under_concurrent_readers():
    """Eight threads reading one dataset at once (the DataLoader's
    batchify tasks do), with a short interpreter switch interval, get
    the bits a serial read gets: each thread reseeds its own
    generator."""
    import sys
    import threading
    ds = tdata.vision.MNIST(train=False)
    idx = list(range(0, 4000, 7))
    want = {i: ds[i][0].asnumpy() for i in idx}
    got, errors = {}, []

    def reader(t):
        try:
            for i in idx[t * 71:] + idx[:t * 71]:     # each its own order
                got[(t, i)] = ds[i][0].asnumpy()
        except BaseException as exc:      # reported below
            errors.append(exc)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        sys.setswitchinterval(prev)
    assert len(got) == 8 * len(idx)
    for (_, i), img in got.items():
        np.testing.assert_array_equal(img, want[i])


def test_image_record_stand_in_and_file_datasets(tmp_path):
    jd = jdata.vision.ImageRecordDataset(length=8, shape=(6, 5, 3),
                                         num_classes=4, seed=2)
    td = tdata.vision.ImageRecordDataset(length=8, shape=(6, 5, 3),
                                         num_classes=4, seed=2)
    for i in range(8):
        _same(td[i][0], jd[i][0])
        assert td[i][1] == jd[i][1]
    # the file datasets read image files since [6c] landed (their items
    # against the JAX package's: tests/test_torch_io.py); over no files
    # they are empty, as the JAX package's are
    (tmp_path / "cls").mkdir()
    for mod in (jdata, tdata):
        folder = mod.vision.ImageFolderDataset(str(tmp_path))
        assert folder.synsets == ["cls"] and len(folder) == 0
        assert len(mod.vision.ImageListDataset(".", [])) == 0
    # RecordFileDataset reads RecordIO since [6b] landed: a missing file
    # raises as the JAX package's does (tests/test_torch_recordio.py
    # holds it against the JAX package on written packs)
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError):
            mod.RecordFileDataset("no-such-file.rec")


# ---------------------------------------------------------------------------
# the DataLoader
# ---------------------------------------------------------------------------
def _mnist_loaders(seed, **kw):
    out = []
    for mod, extra in ((jdata, {}), (tdata, {"ctx": CPU})):
        ds = mod.vision.MNIST(train=False).take(300).transform_first(
            lambda x: x.astype("float32") / 255.0)
        np.random.seed(seed)
        out.append(list(mod.DataLoader(ds, batch_size=64, shuffle=True,
                                       **kw, **extra)))
    return out


@pytest.mark.parametrize("kw", [{}, {"prefetch": 0}, {"last_batch":
                                                     "discard"},
                                {"num_workers": 3}],
                         ids=["engine", "inline", "discard", "workers"])
def test_loader_batches_and_order_match(kw):
    """Shuffled MNIST batches for one numpy seed: the same order,
    values and dtypes; the port's arrive on the loader's ctx."""
    want, got = _mnist_loaders(7, **kw)
    assert len(got) == len(want) == (4 if kw.get("last_batch") else 5)
    for (tx, ty), (jx, jy) in zip(got, want):
        assert tx.context.type == "cpu"
        _same(tx, jx)
        _same(ty, jy)


def test_loader_custom_batchify_and_sampler():
    xs = np.random.RandomState(1).randn(23, 3).astype(np.float32)
    ys = np.arange(23).astype(np.int32)

    def stack(items):
        return (np.stack([a for a, _ in items]),
                np.array([b for _, b in items]))
    sampler_j = jdata.BatchSampler(jdata.SequentialSampler(23), 5, "keep")
    sampler_t = tdata.BatchSampler(tdata.SequentialSampler(23), 5, "keep")
    want = list(jdata.DataLoader(jdata.ArrayDataset(xs, ys),
                                 batch_sampler=sampler_j, batchify_fn=stack))
    got = list(tdata.DataLoader(tdata.ArrayDataset(xs, ys),
                                batch_sampler=sampler_t, batchify_fn=stack,
                                ctx=CPU))
    assert len(got) == len(want) == 5
    for (tx, ty), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(tx.asnumpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.asnumpy(), np.asarray(jy))
    with pytest.raises(ValueError):
        tdata.DataLoader(tdata.ArrayDataset(xs), ctx=CPU)
    with pytest.raises(ValueError):
        tdata.DataLoader(tdata.ArrayDataset(xs), batch_size=2,
                         sampler=tdata.SequentialSampler(23), shuffle=True,
                         ctx=CPU)


def test_loader_runs_on_the_engine_and_cancels_on_break():
    """The batchify tasks are background tasks of a TaskGroup; breaking
    out of an epoch cancels the queued ones (the group drains, nothing
    is left pending); the shed fallback batchifies inline."""
    ds = tdata.vision.MNIST(train=False).take(512)
    seen = []
    orig = tdata.DataLoader._make_batch

    def spy(self, idx):
        import threading
        seen.append(threading.current_thread().name)
        return orig(self, idx)
    loader = tdata.DataLoader(ds, batch_size=16, prefetch=8, ctx=CPU)
    tdata.DataLoader._make_batch = spy
    try:
        it = iter(loader)
        next(it)
        it.close()
    finally:
        tdata.DataLoader._make_batch = orig
    engine.wait_for_all()
    assert engine.active_groups() == 0 and engine.pending_tasks() == 0
    assert len(seen) <= 9
    assert any(not n.startswith("MainThread") for n in seen)
    prev = engine.set_queue_limit(engine.PRIORITY_BACKGROUND, 1, "reject")
    try:
        batches = list(tdata.DataLoader(ds.take(64), batch_size=16,
                                        prefetch=4, ctx=CPU))
    finally:
        engine.set_queue_limit(engine.PRIORITY_BACKGROUND, *prev)
    assert [b[0].shape[0] for b in batches] == [16] * 4


def test_loader_refuses_device_staging_and_defaults_to_the_card(
        monkeypatch):
    """Device staging (`prefetch_to_device`, `pin_memory`, [6b]) stages
    onto the loader's ctx, here the CPU, with the plain loader's
    batches; without a card, the default ctx and staging for the card
    are refused instead of staging on the CPU."""
    ds = tdata.ArrayDataset(np.arange(8, dtype=np.float32).reshape(4, 2))
    plain = [b.asnumpy() for b in tdata.DataLoader(ds, batch_size=2,
                                                   ctx=CPU)]
    for kw in ({"prefetch_to_device": True}, {"pin_memory": True}):
        got = [b.asnumpy() for b in tdata.DataLoader(ds, batch_size=2,
                                                     ctx=CPU, **kw)]
        assert len(got) == len(plain) == 2
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        tdata.DataLoader(ds, batch_size=2)
    for kw in ({"prefetch_to_device": True}, {"pin_memory": True}):
        with pytest.raises(MXNetError, match="CUDA"):
            tdata.DataLoader(ds, batch_size=2, **kw)


def test_default_batchify_fn_stacks_on_the_host():
    items = [(mx.nd.array(np.full((2, 2), i, np.uint8), ctx=CPU),
              np.float32(i)) for i in range(3)]
    x, y = tdata.default_batchify_fn(items)
    jx, jy = jdata.default_batchify_fn(
        [(mxj.nd.array(np.full((2, 2), i, np.uint8)), np.float32(i))
         for i in range(3)])
    _same(x, jx)
    _same(y, jy)
    assert x.context.type == "cpu"
    _same(tdata.default_batchify_fn([1.0, 2.0]),
          jdata.default_batchify_fn([1.0, 2.0]))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def _img(seed, shape=(12, 10, 3), dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (rng.rand(*shape) * 255).astype(dtype)


EXACT = dict(rtol=0, atol=0)
ONE_ROUNDING = dict(rtol=1e-6, atol=1e-4)   # an fp32 product reordered
RESIZE = dict(rtol=1e-4, atol=2e-3)         # the antialiased filter's sums

TRANSFORMS = [
    ("ToTensor", lambda m: m.ToTensor(), np.uint8, EXACT),
    ("Cast", lambda m: m.Cast("float16"), np.uint8, EXACT),
    ("Normalize", lambda m: m.Normalize((0.5, 0.4, 0.3), (0.2, 0.3, 0.4)),
     np.float32, ONE_ROUNDING),
    ("Compose", lambda m: m.Compose([m.ToTensor(), m.Normalize(0.5, 0.25)]),
     np.uint8, ONE_ROUNDING),
    ("CenterCrop", lambda m: m.CenterCrop((6, 4)), np.uint8, EXACT),
    ("RandomCrop", lambda m: m.RandomCrop(5, pad=2), np.uint8, EXACT),
    ("FlipLR", lambda m: m.RandomFlipLeftRight(), np.uint8, EXACT),
    ("FlipTB", lambda m: m.RandomFlipTopBottom(), np.uint8, EXACT),
    ("Brightness", lambda m: m.RandomBrightness(0.4), np.uint8,
     ONE_ROUNDING),
    ("Contrast", lambda m: m.RandomContrast(0.4), np.uint8, ONE_ROUNDING),
    ("Saturation", lambda m: m.RandomSaturation(0.4), np.uint8,
     ONE_ROUNDING),
    ("Hue", lambda m: m.RandomHue(0.2), np.uint8, ONE_ROUNDING),
    ("Lighting", lambda m: m.RandomLighting(0.1), np.uint8, ONE_ROUNDING),
    ("ColorJitter", lambda m: m.RandomColorJitter(0.3, 0.3, 0.3, 0.1),
     np.uint8, ONE_ROUNDING),
    ("ResizeDown", lambda m: m.Resize((5, 4)), np.uint8, RESIZE),
    ("ResizeUp", lambda m: m.Resize(17), np.float32, RESIZE),
    ("ResizedCrop", lambda m: m.RandomResizedCrop(6), np.uint8, RESIZE),
    ("Rotate", lambda m: m.Rotate(30), np.float32, ONE_ROUNDING),
    ("RotateZoomIn", lambda m: m.Rotate(-20, zoom_in=True), np.float32,
     ONE_ROUNDING),
    ("RotateZoomOut", lambda m: m.Rotate(45, zoom_out=True), np.float32,
     ONE_ROUNDING),
]


@pytest.mark.parametrize("name,make,dtype,tol", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transforms_match(name, make, dtype, tol):
    """Each transform on the same image after the same numpy seed (the
    random ones draw the same crops, flips and jitters): the same shape
    and dtype, values within `tol`."""
    shape = (3, 12, 10) if name == "Normalize" else (12, 10, 3)   # CHW
    for seed in (0, 1):
        img = _img(seed, shape, dtype)
        np.random.seed(100 + seed)
        want = _np(make(jtf)(mxj.nd.array(img)))
        np.random.seed(100 + seed)
        got = _np(make(ttf)(mx.nd.array(img, ctx=CPU)))
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (got.shape, want.shape, got.dtype, want.dtype)
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), **tol)
