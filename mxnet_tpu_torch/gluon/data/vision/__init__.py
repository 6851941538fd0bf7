"""mx.gluon.data.vision (counterpart of `mxnet_tpu/gluon/data/vision/`)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset,
                       ImageListDataset)
from . import transforms
