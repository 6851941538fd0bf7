"""Datasets (counterpart of `mxnet_tpu/gluon/data/dataset.py`; reference:
python/mxnet/gluon/data/dataset.py). `RecordFileDataset` reads a
RecordIO file through `recordio.open_record_file`."""
from __future__ import annotations

import os
import threading

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
    gluon.data.RecordFileDataset); each item is one record's bytes.

    The records are read through `recordio.open_record_file`: the
    native mmap reader (`csrc/recordio.cc`) where it builds, whose reads
    are safe from the DataLoader's engine workers, else a Python scan.
    Where the .idx sidecar lists every record, as `MXIndexedRecordIO`
    writes it, item i is the record at its i-th key's offset, the order
    the JAX package's dataset reads; an index of only some records is
    read through `MXIndexedRecordIO`, one read at a time."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO, open_record_file
        self._records = open_record_file(filename)
        self._order = None
        self._rec = None
        self._lock = threading.Lock()
        idx_path = os.path.splitext(filename)[0] + ".idx"
        if os.path.exists(idx_path):
            rec = MXIndexedRecordIO(idx_path, filename, "r")
            offsets = [rec.idx[k] for k in rec.keys]
            if len(set(offsets)) == len(offsets) == len(self._records):
                # every record is indexed: its offset's rank in the file
                # is its position among the reader's records
                rank = {off: i for i, off in enumerate(sorted(offsets))}
                self._order = [rank[off] for off in offsets]
                rec.close()
            else:
                self._rec = rec
                self._keys = rec.keys

    def __len__(self):
        return len(self._keys) if self._rec is not None else \
            len(self._records)

    def __getitem__(self, idx):
        if self._rec is not None:
            with self._lock:    # one file position, shared by the workers
                return self._rec.read_idx(self._keys[idx])
        if self._order is not None:
            idx = self._order[idx]
        return self._records[idx]
