"""The port's `mx.io`, `mx.contrib.io` and image-file datasets on the CPU
against the JAX package's: `NDArrayIter` in every `last_batch_handle`,
`ResizeIter`, `CSVIter`, `MNISTIter` (idx files written here),
`DataLoaderIter`, `PrefetchingIter`, `ImageRecordIter` (its batches, a
corrupt record skipped and counted, an over-budget epoch raising, a read
fault retried), `ImageFolderDataset` / `ImageListDataset`; and the slice
as a whole: a narrow ResNet-50-shaped net (one bottleneck a stage) from
the same weights takes two fp32 steps fed by `ImageIter` over an 8-image
JPEG pack in each package.

Tolerances: batches of in-memory arrays exactly; `ImageRecordIter`'s
resize is PIL's bicubic (8-bit passes) in the JAX package and
`F.interpolate` bicubic antialiased on uint8 in the port, at most
RESIZE_LEVELS apart a sample, so the normalised batches within
RESIZE_LEVELS / std; the training losses within LOSS_TOL (the fp32
tolerance of tests/test_torch_resnet.py, the inputs' resize within
tests/test_torch_data.py's RESIZE).
"""
import gzip
import io
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import io as jio
from mxnet_tpu.contrib import io as jcio
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import io as tcio
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

Image = pytest.importorskip("PIL.Image")

CPU = mx.cpu()
RESIZE_LEVELS = 2
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it):
    return [([_np(d) for d in b.data], [_np(l) for l in b.label or []],
             b.pad) for b in it]


def _same_batches(got, want, **tol):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            if tol:
                np.testing.assert_allclose(g, w, **tol)
            else:
                np.testing.assert_array_equal(g, w)


def _arrays(n=10):
    rng = np.random.RandomState(1)
    return (rng.rand(n, 2, 3).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    data, label = _arrays()
    np.random.seed(3)
    t = tio.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                        last_batch_handle=handle, ctx=CPU)
    np.random.seed(3)
    j = jio.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                        last_batch_handle=handle)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    for epoch in range(2):
        _same_batches(_batches(t), _batches(j))
        np.random.seed(epoch)
        t.reset()
        np.random.seed(epoch)
        j.reset()
    # several named arrays, and NDArray sources
    two = {"a": data, "b": data * 2}
    _same_batches(_batches(tio.NDArrayIter(two, batch_size=3, ctx=CPU)),
                  _batches(jio.NDArrayIter(two, batch_size=3)))
    _same_batches(_batches(tio.NDArrayIter(mx.nd.array(data, ctx=CPU),
                                           batch_size=5, ctx=CPU)),
                  _batches(jio.NDArrayIter(mxj.nd.array(data),
                                           batch_size=5)))


def test_resize_iter_matches_jax():
    data, label = _arrays()
    t = tio.ResizeIter(tio.NDArrayIter(data, label, batch_size=4, ctx=CPU), 5)
    j = jio.ResizeIter(jio.NDArrayIter(data, label, batch_size=4), 5)
    _same_batches(_batches(t), _batches(j))
    t.reset()
    j.reset()
    _same_batches(_batches(t), _batches(j))


def test_csv_iter_matches_jax(tmp_path):
    data, label = _arrays(7)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data.reshape(7, -1), delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    for kw in ({"label_csv": lpath}, {}):
        t = tio.CSVIter(dpath, (2, 3), batch_size=3, ctx=CPU, **kw)
        j = jio.CSVIter(dpath, (2, 3), batch_size=3, **kw)
        assert t.provide_data == j.provide_data
        _same_batches(_batches(t), _batches(j))


def _idx(path, arr, magic, gz=False):
    head = struct.pack(">i", magic) + struct.pack(f">{arr.ndim}i",
                                                  *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_iter_matches_jax(gz, tmp_path):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (9, 28, 28))
    labs = rng.randint(0, 10, 9)
    sfx = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"i{sfx}"), str(tmp_path / f"l{sfx}")
    _idx(ip, imgs, 2051, gz)
    _idx(lp, labs, 2049, gz)
    for kw in ({}, {"flat": True, "shuffle": True, "seed": 4}):
        t = tio.MNISTIter(ip, lp, batch_size=4, ctx=CPU, **kw)
        j = jio.MNISTIter(ip, lp, batch_size=4, **kw)
        assert t.provide_data == j.provide_data
        _same_batches(_batches(t), _batches(j))
    for mod in (tio, jio):
        with pytest.raises(Exception, match="magic"):
            mod.MNISTIter(lp, ip, batch_size=4,
                          **({"ctx": CPU} if mod is tio else {}))


def test_dataloader_iter_matches_jax():
    data, label = _arrays(8)
    tl = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(data, label),
                                  batch_size=3, ctx=CPU)
    jl = mxj.gluon.data.DataLoader(mxj.gluon.data.ArrayDataset(data, label),
                                   batch_size=3)
    t, j = tcio.DataLoaderIter(tl), jcio.DataLoaderIter(jl)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    for _ in range(2):
        got, want = _batches(t), _batches(j)
        assert got[0][0][0].dtype == np.float32
        _same_batches(got, want)
        t.reset()
        j.reset()


def test_prefetching_iter_matches_jax():
    data, label = _arrays(11)
    t = tio.PrefetchingIter(tio.NDArrayIter(data, label, batch_size=4,
                                            ctx=CPU))
    j = jio.PrefetchingIter(jio.NDArrayIter(data, label, batch_size=4))
    assert t.provide_data == j.provide_data
    _same_batches(_batches(t), _batches(j))
    t.reset()
    j.reset()
    _same_batches(_batches(t), _batches(j))
    t.close()
    j.close()


def test_unported_iterators_raise_naming_their_item(tmp_path):
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.0\n")
    with pytest.raises(MXNetError, match=r"\[2\]"):
        tio.LibSVMIter(str(path), (3,))
    with pytest.raises(MXNetError, match=r"\[8\]"):
        tio.ImageDetRecordIter(2, (3, 8, 8))


# --------------------------------------------------------- ImageRecordIter
def _smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((h, w, 3), 128.0, np.float32)
    for ch in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.02, 0.12, 2)
            out[..., ch] += rng.uniform(10, 40) * np.sin(
                fx * x + fy * y + rng.uniform(0, 6.3))
    out += rng.normal(0, 5, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _pack(pkg, prefix, n, fmt=".jpg", bad=(), sizes=None, idx=True):
    """n records (label i % 7) of images of `sizes` (default 20-30 a
    side), written through `pkg`'s recordio; `bad` indices hold a JPEG
    header followed by garbage."""
    rng = np.random.RandomState(5)
    rec = f"{prefix}.rec"
    w = pkg.recordio.MXIndexedRecordIO(f"{prefix}.idx", rec, "w")
    for i in range(n):
        head = pkg.recordio.IRHeader(0, float(i % 7), i, 0)
        if i in bad:
            s = pkg.recordio.pack(head, b"\xff\xd8\xff\xe0" + bytes(40))
        else:
            h, wd = sizes or (int(rng.randint(20, 31)),
                              int(rng.randint(20, 31)))
            s = pkg.recordio.pack_img(head, _smooth(h, wd, i), quality=95,
                                      img_fmt=fmt)
        w.write_idx(i, s)
    w.close()
    if not idx:
        os.remove(f"{prefix}.idx")
    return rec


NORM = dict(mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
            std_g=57.0, std_b=57.5)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
@pytest.mark.parametrize("idx", [True, False])
def test_image_record_iter_matches_jax(fmt, idx, tmp_path):
    rec = _pack(mx, str(tmp_path / "p"), 10, fmt, idx=idx)
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=4, **NORM)
    t = tio.ImageRecordIter(ctx=CPU, **kw)
    j = jio.ImageRecordIter(**kw)
    assert t.num_samples == j.num_samples == 10
    assert t.provide_data == j.provide_data
    for _ in range(2):
        got, want = _batches(t), _batches(j)
        assert len(got) == 2
        _same_batches(got, want, rtol=0, atol=RESIZE_LEVELS / 57.0 + 1e-5)
        t.reset()
        j.reset()
    # grey, resized
    kw = dict(path_imgrec=rec, data_shape=(1, 24, 24), batch_size=4, **NORM)
    _same_batches(_batches(tio.ImageRecordIter(ctx=CPU, **kw)),
                  _batches(jio.ImageRecordIter(**kw)), rtol=0,
                  atol=RESIZE_LEVELS / 58.0 + 1e-5)
    # grey, and records already at data_shape (no resize): exact for PNG
    rec2 = _pack(mx, str(tmp_path / "q"), 4, fmt, sizes=(24, 24))
    for c in (1, 3):
        kw = dict(path_imgrec=rec2, data_shape=(c, 24, 24), batch_size=2,
                  **NORM)
        got = _batches(tio.ImageRecordIter(ctx=CPU, **kw))
        want = _batches(jio.ImageRecordIter(**kw))
        _same_batches(got, want, rtol=1e-6,
                      atol=1e-5 if fmt == ".png" else 1.0 / 57.0 + 1e-5)


def test_image_record_iter_synthetic_stream_matches_jax():
    kw = dict(data_shape=(3, 8, 8), batch_size=4, num_samples=10,
              num_classes=3, seed=2)
    _same_batches(_batches(tio.ImageRecordIter(ctx=CPU, **kw)),
                  _batches(jio.ImageRecordIter(**kw)))


def test_image_record_iter_skips_counts_and_bounds_bad_records(tmp_path):
    rec = _pack(mx, str(tmp_path / "p"), 9, bad=(2, 6))
    reg = mx.observability.registry()
    before = reg.counter("data_records_skipped").value
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=3, **NORM)
    t = tio.ImageRecordIter(ctx=CPU, **kw)
    j = jio.ImageRecordIter(**kw)
    got, want = _batches(t), _batches(j)
    _same_batches(got, want, rtol=0, atol=RESIZE_LEVELS / 57.0 + 1e-5)
    assert len(got) == 2
    assert t.records_skipped == j.records_skipped == 2
    assert reg.counter("data_records_skipped").value == before + 2
    t.reset()
    assert len(_batches(t)) == 2 and t.records_skipped == 4   # per epoch
    for mod, extra in ((tio, {"ctx": CPU}), (jio, {})):
        over = mod.ImageRecordIter(max_bad_records=1, **kw, **extra)
        with pytest.raises(Exception, match="max_bad_records=1"):
            _batches(over)
    # the budget's default comes from MXTPU_MAX_BAD_RECORDS
    os.environ["MXTPU_MAX_BAD_RECORDS"] = "0"
    try:
        assert tio.ImageRecordIter(ctx=CPU, **kw).max_bad_records == 0
    finally:
        del os.environ["MXTPU_MAX_BAD_RECORDS"]


def test_image_record_iter_retries_a_read_fault(tmp_path):
    """An injected `io.read` fault on an indexed read is retried (the
    MXTPU_IO policy), an `io.decode` one skips the record."""
    rec = _pack(mx, str(tmp_path / "p"), 6)
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=3, **NORM)
    want = _batches(tio.ImageRecordIter(ctx=CPU, **kw))
    mx.fault.inject("io.read", at=[2])
    try:
        got = _batches(tio.ImageRecordIter(ctx=CPU, **kw))
    finally:
        mx.fault.clear()
    _same_batches(got, want)
    mx.fault.inject("io.decode", at=[1])
    try:
        it = tio.ImageRecordIter(ctx=CPU, **kw)
        assert len(_batches(it)) == 1 and it.records_skipped == 1
    finally:
        mx.fault.clear()


# ------------------------------------------------------------- datasets
def _image_tree(root):
    rng = np.random.RandomState(7)
    for cls in ("cat", "dog", "emu"):
        d = root / cls
        d.mkdir(parents=True)
        for k in range(2):
            img = rng.randint(0, 256, (9 + k, 11, 3)).astype(np.uint8)
            buf = io.BytesIO()
            fmt = "PNG" if k else "JPEG"
            Image.fromarray(img).save(buf, format=fmt)
            (d / f"{k}.{fmt.lower()}").write_bytes(buf.getvalue())
    (root / "notes.txt").write_text("not a class")


@pytest.mark.parametrize("flag", [0, 1])
def test_image_folder_and_list_datasets_match_jax(flag, tmp_path):
    _image_tree(tmp_path / "tree")
    root = str(tmp_path / "tree")
    t = mx.gluon.data.vision.ImageFolderDataset(root, flag=flag)
    j = mxj.gluon.data.vision.ImageFolderDataset(root, flag=flag)
    assert t.synsets == j.synsets == ["cat", "dog", "emu"]
    assert t.items == j.items and len(t) == 6
    for i in range(len(t)):
        (gi, gl), (wi, wl) = t[i], j[i]
        assert gl == wl and gi.context == CPU and gi.shape == wi.shape
        d = np.abs(_np(gi).astype(int) - _np(wi).astype(int)).max()
        assert d <= 1
    lst = tmp_path / "list.lst"
    lst.write_text("0\t2\tcat/0.jpeg\n1\t1\t0.5\tdog/1.png\n")
    for imglist in (str(lst), [[2, "cat/0.jpeg"], [1, 0.5, "dog/1.png"]]):
        t = mx.gluon.data.vision.ImageListDataset(root, imglist, flag=flag)
        j = mxj.gluon.data.vision.ImageListDataset(root, imglist, flag=flag)
        assert t.items == j.items
        for i in range(len(t)):
            assert t[i][1] == j[i][1]
            d = np.abs(_np(t[i][0]).astype(int)
                       - _np(j[i][0]).astype(int)).max()
            assert d <= 1
    # a transform sees the host image
    t = mx.gluon.data.vision.ImageFolderDataset(
        root, transform=lambda x, y: (x.astype("float32"), y + 10))
    assert t[0][1] == 10 and t[0][0].dtype == np.float32


# ------------------------------------------------ the slice as a whole
CHANNELS = [8, 16, 32, 64, 128]


def _seeded(net, seed):
    rng = np.random.RandomState(seed)
    out = {}
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
        out[name] = a.astype(np.float32)
    return out


def _net(res):
    return res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                        classes=7, thumbnail=True)


def _train(pkg, net, it, steps):
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        batch = it.next()
        with pkg.autograd.record():
            loss = ce(net(batch.data[0]), batch.label[0]).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return losses


def test_resnet_trains_from_an_image_pack_like_jax(tmp_path):
    """ImageIter over an 8-image JPEG pack (shuffled, random crops and
    flips, normalised) feeds two SGD steps of the same net in each
    package, from the same weights (the JAX model's save_parameters file
    into the port through `convert.load_jax_parameters`)."""
    rec = _pack(mx, str(tmp_path / "p"), 8)
    idx = str(tmp_path / "p.idx")
    tnet = _net(tres)
    tnet.initialize(ctx=CPU)
    tnet(mx.nd.zeros((1, 3, 20, 20), ctx=CPU))
    seeded = tmp_path / "seeded.npz"
    with open(seeded, "wb") as f:
        np.savez(f, **_seeded(tnet, 3))
    jnet = _net(jres)
    jnet.load_parameters(str(seeded))
    jnet.hybridize()
    path = str(tmp_path / "net.params")
    jnet.save_parameters(path)
    mx.convert.load_jax_parameters(tnet, dict(np.load(path)), ctx=CPU)

    def image_iter(pkg, **extra):
        aug = pkg.image.CreateAugmenter((3, 20, 20), resize=22,
                                        rand_crop=True, rand_mirror=True,
                                        mean=True, std=True)
        return pkg.image.ImageIter(4, (3, 20, 20), path_imgrec=rec,
                                   path_imgidx=idx, shuffle=True, seed=1,
                                   aug_list=aug, **extra)
    np.random.seed(11)
    want = _train(mxj, jnet, image_iter(mxj), 2)
    np.random.seed(11)
    got = _train(mx, tnet, tio.PrefetchingIter(image_iter(mx, ctx=CPU)), 2)
    print(f"losses: port {got}, JAX {want}")
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
