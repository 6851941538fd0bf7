"""The port's `mx.image` on the CPU against the JAX package's
(`mxnet_tpu/image.py`, which decodes with PIL): `imdecode` / `imread`,
`imresize`, the crops, every augmenter, `CreateAugmenter` and `ImageIter`
(rec mode with and without an .idx, shuffled, and list mode) under the
same numpy seed, and image records across the two packages both ways.

Tolerances: integer outputs (decodes of PNG, crops, flips) exactly; a
JPEG decode within JPEG_LEVELS of PIL's (tests/test_torch_imcodec.py);
float outputs of the resizes within RESIZE (the antialiased filter's
sums, tests/test_torch_data.py) and of the colour augmenters within
ONE_ROUNDING (an fp32 product or sum reordered); batches that carry a
JPEG level through ImageIter's normalisation within JPEG_LEVELS / the
smallest std on top of RESIZE.
"""
import io

import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import recordio as jrio
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio as rio
from mxnet_tpu_torch.base import MXNetError

Image = pytest.importorskip("PIL.Image")

CPU = mx.cpu()
EXACT = dict(rtol=0, atol=0)
RESIZE = dict(rtol=1e-4, atol=2e-3)
ONE_ROUNDING = dict(rtol=1e-5, atol=1e-3)
JPEG_LEVELS = 1
STD = np.array([58.395, 57.12, 57.375], np.float32)   # CreateAugmenter's


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def smooth_image(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((h, w, 3), 128.0, np.float32)
    for ch in range(3):
        for _ in range(6):
            fx, fy = rng.uniform(0.01, 0.1, 2)
            out[..., ch] += rng.uniform(10, 40) * np.sin(
                fx * x + fy * y + rng.uniform(0, 6.3))
    out += rng.normal(0, 6, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------- decoding
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_matches_jax(flag, to_rgb):
    img = smooth_image(37, 53, 0)
    for fmt, kw, tol in (("PNG", {}, 0), ("JPEG", {"quality": 90},
                                          JPEG_LEVELS)):
        data = pil_bytes(img, fmt, **kw)
        got = mx.image.imdecode(data, flag, to_rgb)
        want = mxj.image.imdecode(data, flag, to_rgb)
        assert got.context == CPU and got.dtype == np.uint8
        assert got.shape == want.shape
        d = np.abs(_np(got).astype(int) - _np(want).astype(int))
        assert d.max() <= tol, (fmt, d.max())
    # an NDArray buffer, and the raw-square fallback for no known header
    data = pil_bytes(img, "PNG")
    np.testing.assert_array_equal(
        _np(mx.image.imdecode(mx.nd.array(np.frombuffer(data, np.uint8),
                                          ctx=CPU), flag, to_rgb)),
        _np(mxj.image.imdecode(data, flag, to_rgb)))
    raw = bytes(range(200)) * 3
    np.testing.assert_array_equal(_np(mx.image.imdecode(raw, flag)),
                                  _np(mxj.image.imdecode(raw, flag)))


def test_imdecode_raises_where_jax_raises():
    good = pil_bytes(smooth_image(40, 40, 1), "JPEG")
    for bad in (good[:len(good) // 2], good[:30]):
        with pytest.raises(MXNetError, match="corrupt image data"):
            mx.image.imdecode(bad)
        with pytest.raises(Exception):
            mxj.image.imdecode(bad)
    with pytest.raises(MXNetError, match="cannot decode"):
        mx.image.imdecode(b"")
    # a format the port recognises but does not decode is not taken for
    # raw pixels
    with pytest.raises(MXNetError, match="GIF"):
        mx.image.imdecode(b"GIF89a" + bytes(30))


@pytest.mark.parametrize("flag", [0, 1])
def test_imread_matches_jax(flag, tmp_path):
    img = smooth_image(21, 30, 2)
    for name, data in (("a.png", pil_bytes(img, "PNG")),
                       ("b.jpg", pil_bytes(img, "JPEG", quality=95))):
        path = tmp_path / name
        path.write_bytes(data)
        got, want = mx.image.imread(str(path), flag), \
            mxj.image.imread(str(path), flag)
        assert got.shape == want.shape and got.context == CPU
        d = np.abs(_np(got).astype(int) - _np(want).astype(int))
        assert d.max() <= (0 if name.endswith("png") else JPEG_LEVELS)
    np.save(tmp_path / "c.npy", img)
    np.testing.assert_array_equal(
        _np(mx.image.imread(str(tmp_path / "c.npy"), flag)),
        _np(mxj.image.imread(str(tmp_path / "c.npy"), flag)))


# -------------------------------------------------------------- geometry
def _pair(arr):
    return mx.nd.array(arr, ctx=CPU), mxj.nd.array(arr)


@pytest.mark.parametrize("w,h", [(20, 14), (48, 64), (37, 29), (10, 40)])
def test_imresize_and_resize_short_match_jax(w, h):
    t, j = _pair(smooth_image(29, 37, 3))
    got, want = mx.image.imresize(t, w, h), mxj.image.imresize(j, w, h)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **RESIZE)
    for size in (16, 29, 40):
        np.testing.assert_allclose(_np(mx.image.resize_short(t, size)),
                                   _np(mxj.image.resize_short(j, size)),
                                   **RESIZE)


def test_crops_match_jax_under_one_seed():
    t, j = _pair(smooth_image(30, 41, 4))
    np.testing.assert_array_equal(_np(mx.image.fixed_crop(t, 3, 5, 10, 12)),
                                  _np(mxj.image.fixed_crop(j, 3, 5, 10, 12)))
    np.testing.assert_allclose(
        _np(mx.image.fixed_crop(t, 3, 5, 10, 12, size=(7, 9))),
        _np(mxj.image.fixed_crop(j, 3, 5, 10, 12, size=(7, 9))), **RESIZE)
    for size in ((16, 16), (41, 30), (50, 10)):
        got, gbox = mx.image.center_crop(t, size)
        want, wbox = mxj.image.center_crop(j, size)
        assert gbox == wbox
        np.testing.assert_allclose(_np(got), _np(want), **RESIZE)
        for seed in range(3):
            np.random.seed(seed)
            got, gbox = mx.image.random_crop(t, size)
            np.random.seed(seed)
            want, wbox = mxj.image.random_crop(j, size)
            assert gbox == wbox
            np.testing.assert_allclose(_np(got), _np(want), **RESIZE)
    for seed in range(4):
        got, gbox = mx.image.random_size_crop(
            t, (12, 12), (0.3, 1.0), (0.75, 1.33),
            rng=np.random.RandomState(seed))
        want, wbox = mxj.image.random_size_crop(
            j, (12, 12), (0.3, 1.0), (0.75, 1.33),
            rng=np.random.RandomState(seed))
        assert gbox == wbox
        np.testing.assert_allclose(_np(got), _np(want), **RESIZE)


# ------------------------------------------------------------ augmenters
EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
AUGMENTERS = {
    "ResizeAug": (lambda m, r: m.image.ResizeAug(20), RESIZE),
    "CenterCropAug": (lambda m, r: m.image.CenterCropAug((16, 12)), EXACT),
    "RandomCropAug": (lambda m, r: m.image.RandomCropAug((16, 12)), EXACT),
    "HorizontalFlipAug": (lambda m, r: m.image.HorizontalFlipAug(0.5),
                          EXACT),
    "ColorNormalizeAug": (lambda m, r: m.image.ColorNormalizeAug(
        [123.68, 116.28, 103.53], [58.395, 57.12, 57.375]), ONE_ROUNDING),
    "ForceResizeAug": (lambda m, r: m.image.ForceResizeAug((18, 11)),
                       RESIZE),
    "CastAug": (lambda m, r: m.image.CastAug(), EXACT),
    "BrightnessJitterAug": (lambda m, r: m.image.BrightnessJitterAug(
        0.3, r), ONE_ROUNDING),
    "ContrastJitterAug": (lambda m, r: m.image.ContrastJitterAug(0.3, r),
                          ONE_ROUNDING),
    "SaturationJitterAug": (lambda m, r: m.image.SaturationJitterAug(
        0.3, r), ONE_ROUNDING),
    "LightingAug": (lambda m, r: m.image.LightingAug(0.1, EIGVAL, EIGVEC,
                                                     r), ONE_ROUNDING),
    "RandomOrderAug": (lambda m, r: m.image.RandomOrderAug(
        [m.image.BrightnessJitterAug(0.2, r), m.image.CastAug(),
         m.image.SaturationJitterAug(0.2, r)], r), ONE_ROUNDING),
    "ColorJitterAug": (lambda m, r: m.image.ColorJitterAug(0.2, 0.2, 0.2,
                                                           r), ONE_ROUNDING),
}


@pytest.mark.parametrize("name", list(AUGMENTERS))
def test_each_augmenter_matches_jax(name):
    """Each augmenter on the same image in both packages, five times,
    numpy's global generator and the augmenter's own RandomState seeded
    alike."""
    make, tol = AUGMENTERS[name]
    t, j = _pair(smooth_image(24, 30, 5))
    ta, ja = make(mx, np.random.RandomState(7)), \
        make(mxj, np.random.RandomState(7))
    assert ta._kwargs.keys() == ja._kwargs.keys()
    for i in range(5):
        np.random.seed(i)
        got = ta(t)
        np.random.seed(i)
        want = ja(j)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.context == CPU
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_color_normalize_and_create_augmenter_match_jax():
    t, j = _pair(smooth_image(40, 52, 6))
    np.testing.assert_allclose(
        _np(mx.image.color_normalize(t, [120, 110, 100], [50, 60, 70])),
        _np(mxj.image.color_normalize(j, [120, 110, 100], [50, 60, 70])),
        **ONE_ROUNDING)
    kw = dict(resize=36, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.1, pca_noise=0.1)
    got = mx.image.CreateAugmenter((3, 32, 32), **kw)
    want = mxj.image.CreateAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in got] == [type(a).__name__
                                               for a in want]
    # the pipeline without its unseeded jitters: the same output
    kw.update(brightness=0, pca_noise=0)
    got = mx.image.CreateAugmenter((3, 32, 32), **kw)
    want = mxj.image.CreateAugmenter((3, 32, 32), **kw)
    for seed in range(3):
        x, y = t, j
        np.random.seed(seed)
        for a in got:
            x = a(x)
        np.random.seed(seed)
        for a in want:
            y = a(y)
        np.testing.assert_allclose(_np(x), _np(y), **RESIZE)


def test_detection_half_raises_naming_its_item():
    for ctor in (lambda: mx.image.DetAugmenter(),
                 lambda: mx.image.DetBorrowAug(mx.image.CastAug()),
                 lambda: mx.image.DetHorizontalFlipAug(0.5),
                 lambda: mx.image.CreateDetAugmenter((3, 8, 8)),
                 lambda: mx.image.ImageDetIter(2, (3, 8, 8)),
                 lambda: mx.image.scale_down((8, 8), (4, 4)),
                 lambda: mx.image.copyMakeBorder(None, 1, 1, 1, 1)):
        with pytest.raises(MXNetError, match=r"\[8\]"):
            ctor()


# ------------------------------------------------------------- ImageIter
def write_pack(pkg, prefix, images, img_fmt=".png", quality=95):
    """An .rec / .idx pair of `images` (labels i % 5) written through
    `pkg`'s recordio."""
    rec, idx = f"{prefix}.rec", f"{prefix}.idx"
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(images):
        w.write_idx(i, pkg.recordio.pack_img(
            pkg.recordio.IRHeader(0, float(i % 5), i, 0), img,
            quality=quality, img_fmt=img_fmt))
    w.close()
    return rec, idx


def pack_images(n, seed=0):
    """n HWC uint8 images, short side 24, long side 24-36, portrait or
    landscape (an `im2rec --resize` pack in miniature)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        long_side = int(rng.randint(24, 37))
        h, w = (24, long_side) if rng.rand() < 0.5 else (long_side, 24)
        out.append(smooth_image(h, w, seed * 1000 + i))
    return out


def _epoch(it):
    out = []
    for batch in it:
        out.append((_np(batch.data[0]), _np(batch.label[0])))
    return out


def _aug(pkg):
    return pkg.image.CreateAugmenter((3, 20, 20), resize=22, rand_crop=True,
                                     rand_mirror=True, mean=True, std=True)


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
@pytest.mark.parametrize("mode", ["indexed-shuffled", "indexed", "stream"])
def test_image_iter_rec_matches_jax(fmt, mode, tmp_path):
    """rec mode over the same pack: the batches, labels and their order
    for two epochs (reset() reshuffles with the iterator's own
    RandomState), and the partial last batch dropped."""
    rec, idx = write_pack(mx, str(tmp_path / "p"), pack_images(11),
                          img_fmt=fmt)
    kw = dict(path_imgrec=rec, shuffle=mode == "indexed-shuffled", seed=3)
    if mode != "stream":
        kw["path_imgidx"] = idx
    ti = mx.image.ImageIter(4, (3, 20, 20), aug_list=_aug(mx), ctx=CPU, **kw)
    ji = mxj.image.ImageIter(4, (3, 20, 20), aug_list=_aug(mxj), **kw)
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label
    tol = dict(RESIZE)
    if fmt == ".jpg":
        tol["atol"] += JPEG_LEVELS / STD.min()
    for epoch in range(2):
        np.random.seed(epoch)
        got = _epoch(ti)
        np.random.seed(epoch)
        want = _epoch(ji)
        assert len(got) == len(want) == 2
        for (gd, gl), (wd, wl) in zip(got, want):
            assert gd.shape == (4, 3, 20, 20) and gd.dtype == np.float32
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gd, wd, **tol)
        ti.reset()
        ji.reset()


def test_image_iter_list_mode_and_label_width(tmp_path):
    images = pack_images(6, seed=2)
    lines = []
    for i, img in enumerate(images):
        name = f"img{i}.png"
        (tmp_path / name).write_bytes(pil_bytes(img, "PNG"))
        lines.append(f"{i}\t{i % 3}\t{i * 0.5}\t{name}")
    lst = tmp_path / "imgs.lst"
    lst.write_text("\n".join(lines) + "\n")
    kw = dict(path_imglist=str(lst), path_root=str(tmp_path), shuffle=True,
              label_width=2, seed=5)
    ti = mx.image.ImageIter(3, (3, 20, 20), aug_list=_aug(mx), ctx=CPU, **kw)
    ji = mxj.image.ImageIter(3, (3, 20, 20), aug_list=_aug(mxj), **kw)
    np.random.seed(0)
    got = _epoch(ti)
    np.random.seed(0)
    want = _epoch(ji)
    assert len(got) == len(want) == 2
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gl.shape == (3, 2)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, **RESIZE)


def test_image_iter_delivers_on_ctx_and_refuses_without_a_card(
        monkeypatch, tmp_path):
    rec, idx = write_pack(mx, str(tmp_path / "p"), pack_images(4))
    it = mx.image.ImageIter(2, (3, 20, 20), path_imgrec=rec, ctx=CPU)
    batch = next(it)
    assert batch.data[0].context == CPU and batch.label[0].context == CPU
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.image.ImageIter(2, (3, 20, 20), path_imgrec=rec)
    with pytest.raises(MXNetError, match="path_imgidx"):
        mx.image.ImageIter(2, (3, 20, 20), path_imgrec=rec, shuffle=True,
                           ctx=CPU)


# ------------------------------------------------- records, both ways
@pytest.mark.parametrize("fmt", [".jpg", ".png"])
@pytest.mark.parametrize("iscolor", [-1, 0, 1])
def test_image_records_cross_the_packages_both_ways(fmt, iscolor):
    """The JAX package's pack_img records decode in the port, and the
    port's in the JAX package's unpack_img: headers equal, PNG pixels
    bit for bit, JPEG within JPEG_LEVELS; a grey image too."""
    for img in (smooth_image(19, 26, 8), smooth_image(19, 26, 9)[..., 0]):
        head = (0, 3.0, 17, 0)
        from_jax = jrio.pack_img(jrio.IRHeader(*head), img, quality=90,
                                 img_fmt=fmt)
        from_port = rio.pack_img(rio.IRHeader(*head), img, quality=90,
                                 img_fmt=fmt)
        for s in (from_jax, from_port):
            gh, got = rio.unpack_img(s, iscolor)
            wh, want = jrio.unpack_img(s, iscolor)
            assert tuple(gh) == tuple(wh)
            assert got.shape == want.shape and got.dtype == want.dtype
            d = np.abs(got.astype(int) - want.astype(int)).max()
            assert d <= (0 if fmt == ".png" else JPEG_LEVELS), d
        if fmt == ".png":
            np.testing.assert_array_equal(rio.unpack_img(from_port)[1], img)


def test_ndarray_transpose_matches_jax():
    """The user's NCHW -> NHWC of an ImageIter batch."""
    x = np.random.RandomState(0).rand(2, 3, 4, 5).astype(np.float32)
    t, j = _pair(x)
    for axes in ((0, 2, 3, 1), ((0, 2, 3, 1),), ()):
        got, want = t.transpose(*axes), j.transpose(*axes)
        assert got.shape == want.shape and got._data.is_contiguous()
        np.testing.assert_array_equal(_np(got), _np(want))
