"""mx.gluon.data (counterpart of `mxnet_tpu/gluon/data/`; reference:
python/mxnet/gluon/data/)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset, RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      IntervalSampler, FilterSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import vision
