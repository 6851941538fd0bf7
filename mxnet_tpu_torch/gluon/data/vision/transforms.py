"""Vision transforms (counterpart of
`mxnet_tpu/gluon/data/vision/transforms.py`; reference:
gluon/data/vision/transforms.py).

Transforms operate on HWC uint8 / float NDArrays (the reference
convention) on whatever device the image lies (the vision datasets give
host images, so a DataLoader's transforms run on the CPU in its batchify
tasks) and compose via `Compose`. ToTensor converts HWC -> CHW
float32 / 255. The random transforms draw from numpy's global generator,
as the JAX package does, so a numpy seed gives both packages the same
crops, flips and jitters.
"""
from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as F

from ....ndarray.ndarray import _apply, array
from ...block import Block, HybridBlock

__all__ = ["Rotate",
           "Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomCrop", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomLighting",
           "RandomColorJitter"]


def _on(x, values):
    """An NDArray of `values` (numpy, float32) on x's device."""
    return array(np.asarray(values, np.float32), ctx=x.context)


class Compose(Block):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = transforms

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (NHWC -> NCHW for a
    batch)."""

    def hybrid_forward(self, F, x):
        def fn(a):
            a = a.to(torch.float32) / 255.0
            if a.dim() == 3:
                return a.permute(2, 0, 1).contiguous()
            return a.permute(0, 3, 1, 2).contiguous()
        return _apply(fn, [x])


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def hybrid_forward(self, F, x):
        mean, std = self._mean, self._std

        def fn(a):
            m = torch.as_tensor(mean, device=a.device)
            s = torch.as_tensor(std, device=a.device)
            if mean.ndim:
                m = m.reshape(-1, 1, 1)
            if std.ndim:
                s = s.reshape(-1, 1, 1)
            return (a - m) / s
        return _apply(fn, [x])


def _resize_hwc(a, size):
    """Bilinear resize of an (H, W, C) tensor to `size` (an int, or (w,
    h)), in float32, antialiased when it shrinks (as `jax.image.resize`'s
    "bilinear": a triangle filter widened by the scale)."""
    h, w = (size, size) if isinstance(size, int) else (size[1], size[0])
    chw = a.to(torch.float32).permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).contiguous()


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        return _apply(lambda a: _resize_hwc(a, self._size), [x])


def _crop(x, y0, x0, h, w):
    return _apply(lambda a: a[y0:y0 + h, x0:x0 + w, :], [x])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0, x0 = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return _crop(x, y0, x0, h, w)


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        a = x.asnumpy()
        if self._pad:
            p = self._pad
            a = np.pad(a, ((p, p), (p, p), (0, 0)), mode="constant")
        H, W = a.shape[:2]
        y0 = np.random.randint(0, max(H - h, 0) + 1)
        x0 = np.random.randint(0, max(W - w, 0) + 1)
        return array(np.ascontiguousarray(a[y0:y0 + h, x0:x0 + w]),
                     ctx=x.context)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self._scale)
            ar = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = _crop(x, y0, x0, h, w)
                return _apply(lambda a: _resize_hwc(a, self._size), [crop])
        return _apply(lambda a: _resize_hwc(a, self._size), [x])


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _apply(lambda a: torch.flip(a, (1,)), [x])
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _apply(lambda a: torch.flip(a, (0,)), [x])
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return x.astype("float32") * float(alpha)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = float(1.0 + np.random.uniform(-self._c, self._c))
        xf = x.astype("float32")
        mean = xf.mean()
        return xf * alpha + mean * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = float(1.0 + np.random.uniform(-self._s, self._s))
        xf = x.astype("float32")
        gray = xf.mean(axis=2, keepdims=True)
        return xf * alpha + gray * (1 - alpha)


class RandomHue(Block):
    """Hue jitter by YIQ rotation (reference: image.HueJitterAug): rotate
    the chroma plane by a random angle in [-hue, hue]*pi."""
    _t_yiq = np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], np.float32)
    _t_rgb = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        alpha = np.random.uniform(-self._h, self._h)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
        m = self._t_rgb @ rot @ self._t_yiq
        mt = _on(x, m.T)
        return _apply(torch.matmul, [x.astype("float32"), mt])


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise."""
    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x.astype("float32") + _on(x, rgb.reshape(1, 1, 3))


def _bilinear_sample(data, grid):
    """Sample NCHW `data` at `grid` (N, 2, Ho, Wo) of [-1, 1] coords
    (reference: BilinearSampler; the JAX package's
    `ops.extra_ops.bilinear_sampler_k`): out-of-range taps weigh 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[:, 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(n, c, h * w)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(n, c, *gx.shape[1:])
        return vals * valid[:, None].to(data.dtype)

    out = (gather(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
           + gather(y0, x0 + 1) * (wx * (1 - wy))[:, None]
           + gather(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
           + gather(y0 + 1, x0 + 1) * (wx * wy)[:, None])
    return out.to(data.dtype)


class Rotate(Block):
    """Rotate an (H, W, C) image by a fixed angle in degrees
    (reference: transforms.Rotate). zoom_in crops to the largest
    axis-aligned rectangle with no border; zoom_out keeps every source
    pixel (pads with zeros). Bilinear sampling, as the JAX package's
    SpatialTransformer sampler."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        if zoom_in and zoom_out:
            raise ValueError("Rotate: zoom_in and zoom_out are exclusive")
        self._deg = float(rotation_degrees)
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out
        self._grids = {}    # (h, w) -> sampling grid (angle is fixed)

    def _grid(self, h, w):
        """Pixel-space rotation grid in the sampler's per-axis [-1, 1]
        coords — correct for non-square images (normalized-space
        rotation would shear them)."""
        if (h, w) in self._grids:
            return self._grids[(h, w)]
        rad = math.radians(self._deg)
        c, s = math.cos(rad), math.sin(rad)
        ca, sa = builtins.abs(c), builtins.abs(s)
        zx = zy = 1.0
        if self._zoom_out:
            # scale so every source pixel fits in the frame
            zx = zy = builtins.max((w * ca + h * sa) / w,
                                   (h * ca + w * sa) / h)
        elif self._zoom_in:
            # largest same-aspect rectangle inscribed in the rotation
            # (the classic inscribed-rect formula)
            long_s, short_s = builtins.max(w, h), builtins.min(w, h)
            if short_s <= 2.0 * sa * ca * long_s or \
                    builtins.abs(sa - ca) < 1e-10:
                half = 0.5 * short_s
                wr, hr = (half / sa, half / ca) if w >= h \
                    else (half / ca, half / sa)
            else:
                cos2 = ca * ca - sa * sa
                wr = (w * ca - h * sa) / cos2
                hr = (h * ca - w * sa) / cos2
            zx, zy = wr / w, hr / h
        # output pixel centres -> rotate in PIXEL units around the centre
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        px = (gx - cx) * zx
        py = (gy - cy) * zy
        sx_pix = c * px - s * py + cx
        sy_pix = s * px + c * py + cy
        # per-axis normalization for the [-1, 1] bilinear sampler
        sx = (2.0 * sx_pix / (w - 1) - 1.0).astype(np.float32)
        sy = (2.0 * sy_pix / (h - 1) - 1.0).astype(np.float32)
        grid = np.stack([sx, sy])[None]        # (1, 2, H, W)
        self._grids[(h, w)] = grid
        return grid

    def forward(self, x):
        grid = self._grid(x.shape[0], x.shape[1])

        def fn(img):
            chw = img.to(torch.float32).permute(2, 0, 1)[None]
            out = _bilinear_sample(chw, torch.as_tensor(grid,
                                                        device=img.device))
            return out[0].permute(1, 2, 0).to(img.dtype).contiguous()
        return _apply(fn, [x])


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._ts))
        for i in order:
            x = self._ts[i](x)
        return x
