"""Vision datasets (counterpart of
`mxnet_tpu/gluon/data/vision/datasets.py`; reference:
gluon/data/vision/datasets.py).

MNIST / FashionMNIST / CIFAR10 / CIFAR100 are *procedurally generated*
class-conditional datasets with the reference's shapes, dtypes and APIs,
bit for bit the JAX package's samples (the same numpy draws):
deterministic per (name, train, index), with learnable class structure
(each class a distinct template plus noise), so nothing is downloaded.
`ImageRecordDataset` is the same package's synthetic stand-in for
RecordIO image data.

A sample's image is an NDArray in host memory (on the CPU): the
DataLoader batchifies on the engine's threads and moves each batch to
its device on the consuming thread. `ImageFolderDataset` and
`ImageListDataset` read JPEG and PNG files through `image.imread` (the
port's own codec).
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ..dataset import Dataset
from ....context import cpu
from ....ndarray.ndarray import array

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset",
           "ImageRecordDataset", "ImageListDataset"]


_RNG = threading.local()


class _SyntheticImageDataset(Dataset):
    _shape = (28, 28, 1)
    _num_classes = 10
    _train_size = 60000
    _test_size = 10000

    def __init__(self, root=None, train=True, transform=None, seed=42):
        self._train = train
        self._transform = transform
        self._length = self._train_size if train else self._test_size
        rng = np.random.RandomState(seed)
        h, w, c = self._shape
        # class templates: smooth random blobs, distinct per class
        self._templates = rng.rand(self._num_classes, h, w, c).astype(np.float32)
        for t in range(self._num_classes):
            for ch in range(c):
                img = self._templates[t, :, :, ch]
                img[:] = (img + np.roll(img, 3, 0) + np.roll(img, 3, 1)) / 3
        self._templates = (self._templates * 180).astype(np.float32)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        # reseeding a kept generator draws the bits of a new
        # RandomState(seed) at about 1/50 of its cost (one per thread:
        # the DataLoader's batchify tasks run on several)
        rng = getattr(_RNG, "rng", None)
        if rng is None:
            rng = _RNG.rng = np.random.RandomState(0)
        rng.seed((idx * 2654435761 + (0 if self._train else 1)) % (2 ** 31))
        label = idx % self._num_classes
        img = self._templates[label] + rng.randn(*self._shape) * 25.0
        img = np.clip(img, 0, 255).astype(np.uint8)
        data = array(img, ctx=cpu())
        if self._transform is not None:
            return self._transform(data, label)
        return data, np.float32(label)


class MNIST(_SyntheticImageDataset):
    """28x28x1, 10 classes (reference: gluon.data.vision.MNIST)."""
    _shape = (28, 28, 1)


class FashionMNIST(_SyntheticImageDataset):
    _shape = (28, 28, 1)


class CIFAR10(_SyntheticImageDataset):
    """32x32x3, 10 classes."""
    _shape = (32, 32, 3)
    _train_size = 50000


class CIFAR100(_SyntheticImageDataset):
    _shape = (32, 32, 3)
    _num_classes = 100
    _train_size = 50000


class ImageFolderDataset(Dataset):
    """Images arranged in per-class folders (reference API): `root/<class
    name>/<file>`, the classes sorted by name (`synsets`), a class's
    files by name; an item is (HWC uint8 NDArray on the CPU, class
    index). `flag` 0 reads grey (H, W, 1), 1 RGB."""

    def __init__(self, root, flag=1, transform=None):
        self._transform = transform
        self._flag = flag
        self.items = []
        self.synsets = []
        for i, cls in enumerate(sorted(os.listdir(root))):
            path = os.path.join(root, cls)
            if not os.path.isdir(path):
                continue
            self.synsets.append(cls)
            for fname in sorted(os.listdir(path)):
                self.items.append((os.path.join(path, fname), i))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """Images named by a .lst-style list (reference: ImageListDataset):
    `imglist` is a path to a tab-separated `index\tlabel\tpath` file (the
    im2rec .lst format) or an in-memory list of [label, path] entries;
    paths resolve relative to `root`."""

    def __init__(self, root=".", imglist=None, flag=1, transform=None):
        self._transform = transform
        self._flag = flag
        self.items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 3:
                        continue
                    label = float(parts[1]) if len(parts) == 3 \
                        else [float(v) for v in parts[1:-1]]
                    self.items.append(
                        (os.path.join(root, parts[-1]), label))
        else:
            for entry in (imglist or []):
                label, path = entry[:-1], entry[-1]
                label = label[0] if len(label) == 1 else list(label)
                self.items.append((os.path.join(root, path), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageRecordDataset(Dataset):
    """Synthetic stand-in for RecordIO image datasets: procedurally
    generated images with the ImageRecord API shape (data, label)."""

    def __init__(self, filename=None, length=1024, shape=(224, 224, 3),
                 num_classes=1000, transform=None, seed=0):
        self._length = length
        self._shape = shape
        self._num_classes = num_classes
        self._transform = transform
        self._seed = seed

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        rng = np.random.RandomState((self._seed + idx) % (2 ** 31))
        img = rng.randint(0, 256, self._shape, dtype=np.uint8)
        label = np.float32(idx % self._num_classes)
        data = array(img, ctx=cpu())
        if self._transform is not None:
            return self._transform(data, label)
        return data, label
