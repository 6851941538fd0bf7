"""Datasets (counterpart of `mxnet_tpu/gluon/data/dataset.py`; reference:
python/mxnet/gluon/data/dataset.py). `RecordFileDataset` reads RecordIO
files, which the port does not read yet: it raises naming ROADMAP.md
Queue 1 [6b]."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first(x, *rest):
            return (fn(x),) + rest if rest else fn(x)
        return self.transform(first, lazy)

    def filter(self, fn):
        kept = [i for i in range(len(self)) if fn(self[i])]
        return _IndexedDataset(self, kept)

    def take(self, count):
        return _IndexedDataset(self, list(range(min(count, len(self)))))

    def shard(self, num_shards, index):
        idx = list(range(index, len(self), num_shards))
        return _IndexedDataset(self, idx)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _IndexedDataset(Dataset):
    def __init__(self, data, indices):
        self._data = data
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/lists (reference: ArrayDataset)."""

    def __init__(self, *args):
        assert args, "needs at least 1 array"
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must be same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO .rec file (reference:
    gluon.data.RecordFileDataset): still to port with `recordio`."""

    def __init__(self, filename):
        raise MXNetError("gluon.data.RecordFileDataset reads RecordIO files,"
                         " which are not ported yet (ROADMAP.md, Queue 1 "
                         "[6b])")
