"""Vision datasets and transforms (counterpart of
``incubator_mxnet_tpu/gluon/data/vision``)."""
from . import transforms
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "transforms"]
