"""mx.contrib.io (counterpart of `mxnet_tpu/contrib/io.py`; reference:
python/mxnet/contrib/io.py): DataLoaderIter adapts a gluon DataLoader to
the DataIter protocol so that DataIter-based training loops consume
DataLoader pipelines. Its batches are the loader's, on the loader's
`ctx`."""
from __future__ import annotations

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    def __init__(self, loader, data_name="data",
                 label_name="softmax_label"):
        self._loader = loader
        self._data_name = data_name
        self._label_name = label_name
        self._iter = iter(loader)
        first = next(self._iter)
        self._first = first
        data, label = first[0], first[1]
        super().__init__(batch_size=data.shape[0])
        self._provide_data = [DataDesc(data_name, tuple(data.shape))]
        self._provide_label = [DataDesc(label_name, tuple(label.shape))]

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        self._iter = iter(self._loader)
        self._first = None

    def next(self):
        if self._first is not None:
            batch, self._first = self._first, None
        else:
            batch = next(self._iter)
        return DataBatch(data=[batch[0]], label=[batch[1]])
