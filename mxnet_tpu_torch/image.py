"""mx.image (counterpart of `mxnet_tpu/image.py`; reference:
python/mxnet/image/image.py).

Image ops over HWC NDArrays in host memory. Decoding is the port's own
codec (`_imcodec`: JPEG and PNG; the JAX package decodes with PIL, the
reference with OpenCV); resizes are `F.interpolate` with antialiasing,
crops and flips tensor slices. Every image op and augmenter runs on the
CPU tensors the decoder makes, so that an engine task can run them (no
CUDA call on an engine thread); `ImageIter` moves each finished batch to
its `ctx` on the thread that asks for it.

Random draws follow the JAX package's order on numpy's generators, so
one seed gives both packages the same crops and flips: `random_crop`
draws x0 then y0 from numpy's global generator, `HorizontalFlipAug` one
`rand`, `ImageIter` shuffles with its own `RandomState(seed)`.

The detection half (`DetAugmenter`, `DetBorrowAug`,
`DetHorizontalFlipAug`, `CreateDetAugmenter`, `ImageDetIter`,
`scale_down`, `copyMakeBorder`) raises: ROADMAP.md Queue 1 [8].
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from . import _imcodec
from .base import MXNetError
from .context import cpu, resolve_device
from .ndarray.ndarray import NDArray, array, _apply

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "HorizontalFlipAug", "ResizeAug",
           "CenterCropAug", "RandomCropAug", "ColorNormalizeAug",
           "CreateAugmenter", "Augmenter", "ForceResizeAug", "ImageIter",
           "ImageDetIter", "CastAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "LightingAug",
           "RandomOrderAug", "color_normalize", "random_size_crop",
           "ColorJitterAug", "DetAugmenter", "DetBorrowAug",
           "DetHorizontalFlipAug", "CreateDetAugmenter", "scale_down",
           "copyMakeBorder"]


def _host(arr):
    """A numpy array as an NDArray in host memory."""
    return array(np.ascontiguousarray(arr), ctx=cpu())


def _finish_decode(arr, flag, to_rgb):
    """Common post-decode: channel-count per `flag`, order per `to_rgb`
    (reference cv2 semantics: to_rgb=False keeps BGR order)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if flag == 0 and arr.shape[-1] == 3:         # luminance (ITU-R 601)
        arr = (arr.astype(np.float32)
               @ np.array([0.299, 0.587, 0.114], np.float32))
        arr = arr.astype(np.uint8)[:, :, None]
    if flag != 0 and not to_rgb and arr.shape[-1] == 3:
        arr = arr[:, :, ::-1]                    # RGB -> BGR
    return _host(arr)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file (JPEG, PNG, or a `.npy` array) to an HWC uint8
    NDArray on the CPU (reference: cv2.imread). flag=0 yields grayscale
    (H, W, 1); to_rgb=False returns BGR channel order (cv2 parity)."""
    if str(filename).endswith(".npy"):
        return _finish_decode(np.load(filename), flag, to_rgb)
    with open(filename, "rb") as f:
        img = _imcodec.decode(f.read())
    return _finish_decode(_imcodec.convert(img, "L" if flag == 0 else "RGB"),
                          flag, to_rgb)


def imdecode(buf, flag=1, to_rgb=True):
    """Decode encoded image bytes (JPEG or PNG). A buffer with NO
    recognised image header falls back to raw-square interpretation (the
    synthetic pipeline's format); a RECOGNISED but corrupt image raises
    ("corrupt image data"), and so does a format the codec does not
    decode, like the reference's imdecode: silent garbage is worse than
    an error."""
    if isinstance(buf, NDArray):
        buf = bytes(buf.asnumpy().astype(np.uint8))
    if _imcodec.image_format(buf) is None:
        arr = np.frombuffer(buf, dtype=np.uint8)
        ch = 1 if flag == 0 else 3
        side = int(np.sqrt(arr.size // ch))
        if side == 0:
            raise MXNetError("imdecode: cannot decode buffer")
        return _host(arr[:side * side * ch].reshape(side, side, ch))
    try:
        img = _imcodec.decode(buf)
    except MXNetError as e:
        raise MXNetError(f"imdecode: {e}") from e
    return _finish_decode(_imcodec.convert(img, "L" if flag == 0 else "RGB"),
                          flag, to_rgb)


def _resize(a, w, h):
    """(H, W, C) -> float32 (h, w, C): bilinear, antialiased when it
    shrinks (as `jax.image.resize`'s "bilinear"); the identity at the
    same size."""
    if tuple(a.shape[:2]) == (h, w):
        return a.to(torch.float32)
    chw = a.to(torch.float32).permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).contiguous()


def imresize(src, w, h, interp=1):
    return _apply(lambda a: _resize(a, w, h), [src])


def resize_short(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = _apply(lambda a: a[y0:y0 + h, x0:x0 + w, :], [src])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = np.random.randint(0, w - new_w + 1)
    y0 = np.random.randint(0, h - new_h + 1)
    return fixed_crop(src, x0, y0, new_w, new_h, size), (x0, y0, new_w, new_h)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return _apply(lambda a: a.flip(1), [src])
        return src


def _vector(v):
    """mean / std as a float32 NDArray on the CPU (an NDArray stays as
    it is)."""
    return v if isinstance(v, NDArray) else _host(np.asarray(v, np.float32))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = _vector(mean)
        self.std = _vector(std)

    def __call__(self, src):
        return (src.astype("float32") - self.mean) / self.std


class ForceResizeAug(Augmenter):
    """Resize to exactly (w, h), ignoring aspect ratio (reference:
    image/detection.py ForceResizeAug)."""

    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1])


class CastAug(Augmenter):
    """Cast to float32 (reference: CastAug)."""

    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-brightness, brightness) (reference)."""

    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self.brightness = brightness
        self._rng = rng or np.random.RandomState()

    def __call__(self, src):
        alpha = 1.0 + self._rng.uniform(-self.brightness, self.brightness)
        return src.astype("float32") * alpha


_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class ContrastJitterAug(Augmenter):
    """Blend with the grayscale mean (reference coefficients)."""

    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self._coef = _host(_GRAY)
        self._rng = rng or np.random.RandomState()

    def __call__(self, src):
        alpha = 1.0 + self._rng.uniform(-self.contrast, self.contrast)
        x = src.astype("float32")
        gray = (x * self._coef).sum() * (3.0 / x.size)
        return x * alpha + gray * (1 - alpha)


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel grayscale (reference coefficients)."""

    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self._coef = _host(_GRAY)
        self._rng = rng or np.random.RandomState()

    def __call__(self, src):
        alpha = 1.0 + self._rng.uniform(-self.saturation, self.saturation)
        x = src.astype("float32")
        gray_nd = (x * self._coef).sum(axis=2, keepdims=True)
        return x * alpha + gray_nd * (1 - alpha)


class LightingAug(Augmenter):
    """AlexNet-style PCA noise (reference: LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec, rng=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)
        self._rng = rng or np.random.RandomState()

    def __call__(self, src):
        alpha = self._rng.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval).astype(np.float32)
        return src.astype("float32") + _host(rgb)


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference)."""

    def __init__(self, ts, rng=None):
        super().__init__()
        self.ts = list(ts)
        self._rng = rng or np.random.RandomState()

    def __call__(self, src):
        order = self._rng.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Brightness+contrast+saturation jitter in random order
    (reference: image.ColorJitterAug)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 rng=None):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness, rng))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast, rng))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation, rng))
        super().__init__(ts, rng)
        self._kwargs = {"brightness": brightness, "contrast": contrast,
                        "saturation": saturation}


def color_normalize(src, mean, std=None):
    """(src - mean) / std (reference: mx.image.color_normalize)."""
    out = src.astype("float32") - _vector(mean)
    if std is not None:
        out = out / _vector(std)
    return out


def random_size_crop(src, size, area, ratio, rng=None, **kwargs):
    """Random area/aspect crop then resize (reference: the inception-style
    random_size_crop); falls back to center crop when no box fits."""
    rng = rng or np.random.RandomState()
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = rng.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w + 1)
            y0 = rng.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size)


def _color_augmenters(brightness=0, contrast=0, saturation=0,
                      pca_noise=0, mean=None, std=None):
    """The colour-jitter + PCA-noise + normalize tail of
    CreateAugmenter (constants live here only)."""
    out = []
    jitters = []
    if brightness:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast:
        jitters.append(ContrastJitterAug(contrast))
    if saturation:
        jitters.append(SaturationJitterAug(saturation))
    if jitters:
        out.append(RandomOrderAug(jitters))
    if pca_noise:
        eigval = np.array([55.46, 4.794, 1.148], np.float32)
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]], np.float32)
        out.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None and mean is not False:
        out.append(ColorNormalizeAug(mean, std if std is not None
                                     and std is not False else [1, 1, 1]))
    return out


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_mirror=False,
                    mean=None, std=None, **kwargs):
    """Build the reference's standard augmentation pipeline."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())   # reference emits float32 unconditionally
    auglist.extend(_color_augmenters(
        brightness=kwargs.get("brightness", 0),
        contrast=kwargs.get("contrast", 0),
        saturation=kwargs.get("saturation", 0),
        pca_noise=kwargs.get("pca_noise", 0), mean=mean, std=std))
    return auglist


class ImageIter:
    """Image iterator over a RecordIO file or an image list (reference:
    python/mxnet/image.py ImageIter): decodes, runs the augmenter pipeline,
    and yields NCHW float32 batches on `ctx` (None = `mx.gpu(0)`, which
    raises without a card; `ctx=mx.cpu()` for the CPU).

    rec mode: path_imgrec (+ optional path_imgidx for shuffled access);
    list mode: path_imglist (.lst: "index\\tlabel...\\tpath") + path_root.
    A partial final batch raises StopIteration, like the reference.
    Decode and augmentation run on the CPU (`_next_host`, which a
    `PrefetchingIter` calls on an engine thread); `next()` then moves the
    batch to `ctx` on the calling thread.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imgidx=None, path_imglist=None,
                 path_root=None, shuffle=False, aug_list=None,
                 data_name="data", label_name="softmax_label", seed=0,
                 ctx=None, **kwargs):
        from .io import DataDesc
        self._device = resolve_device(ctx)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(self.data_shape)
        self._record = None
        self._list = None
        if path_imgrec:
            from . import recordio
            if path_imgidx:
                self._record = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self._keys = list(self._record.keys)
            else:
                self._record = recordio.MXRecordIO(path_imgrec, "r")
                self._keys = None
                if shuffle:
                    raise MXNetError("shuffle needs path_imgidx "
                                     "(indexed record access)")
        elif path_imglist:
            self._list = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = np.array([float(v) for v in parts[1:-1]],
                                      np.float32)
                    self._list.append((labels, parts[-1]))
            self._root = path_root or "."
        else:
            raise MXNetError("ImageIter needs path_imgrec or path_imglist")
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self.reset()

    def reset(self):
        self._cursor = 0
        if self._record is not None and self._keys is None:
            self._record.reset()
        if self._shuffle:
            if self._list is not None:
                self._rng.shuffle(self._list)
            else:
                self._rng.shuffle(self._keys)

    def _read_sample(self):
        from . import recordio
        if self._list is not None:
            if self._cursor >= len(self._list):
                return None
            label, path = self._list[self._cursor]
            self._cursor += 1
            img = imread(os.path.join(self._root, path))
            return label, img
        if self._keys is not None:
            if self._cursor >= len(self._keys):
                return None
            s = self._record.read_idx(self._keys[self._cursor])
            self._cursor += 1
        else:
            s = self._record.read()
            if s is None:
                return None
        header, img = recordio.unpack_img(s)
        label = np.atleast_1d(np.asarray(header.label, np.float32))
        return label, _host(img)

    def _postprocess(self, label, img):
        for aug in self.auglist:
            img = aug(img)
        data = img._data if isinstance(img, NDArray) \
            else torch.as_tensor(np.asarray(img))
        return label, data.to(torch.float32).permute(2, 0, 1)  # HWC->CHW

    def _convert_label(self, label):
        out = np.zeros(self.label_width, np.float32)
        vals = label[:self.label_width]
        out[:len(vals)] = vals
        return out

    def _stack_labels(self, labels):
        stacked = np.stack(labels)
        return stacked[:, 0] if self.label_width == 1 else stacked

    def __iter__(self):
        return self

    def _next_host(self):
        """The next batch, decoded and augmented, in host memory."""
        from .io import DataBatch
        data = torch.empty((self.batch_size,) + self.data_shape,
                           dtype=torch.float32)
        labels = []
        for i in range(self.batch_size):
            sample = self._read_sample()
            if sample is None:
                raise StopIteration  # partial batch dropped (reference)
            label, img = self._postprocess(*sample)
            data[i] = img
            labels.append(self._convert_label(label))
        return DataBatch(data=[NDArray(data)],
                         label=[_host(self._stack_labels(labels))])

    def __next__(self):
        from .io import _batch_to
        return _batch_to(self._next_host(), self._device)

    next = __next__


def _detection(name):
    raise MXNetError(f"image.{name} belongs to the detection pipeline, "
                     f"which is not ported yet (ROADMAP.md, Queue 1 [8])")


class DetAugmenter:
    """Label-aware augmenter base (reference: image/detection.py): the
    detection pipeline is ROADMAP.md Queue 1 [8]."""

    def __init__(self, *args, **kwargs):
        _detection(type(self).__name__)


class DetBorrowAug(DetAugmenter):
    """Reference: DetBorrowAug (ROADMAP.md Queue 1 [8])."""


class DetHorizontalFlipAug(DetAugmenter):
    """Reference: DetHorizontalFlipAug (ROADMAP.md Queue 1 [8])."""


def CreateDetAugmenter(data_shape, **kwargs):
    """Reference: CreateDetAugmenter (ROADMAP.md Queue 1 [8])."""
    _detection("CreateDetAugmenter")


def scale_down(src_size, size):
    """Reference: image.scale_down (ROADMAP.md Queue 1 [8])."""
    _detection("scale_down")


def copyMakeBorder(src, top, bot, left, right, type=0, values=0.0):
    """Reference: image.copyMakeBorder (ROADMAP.md Queue 1 [8])."""
    _detection("copyMakeBorder")


class ImageDetIter(ImageIter):
    """Reference: image/detection.py ImageDetIter (ROADMAP.md Queue 1
    [8])."""

    def __init__(self, *args, **kwargs):
        _detection("ImageDetIter")
