"""Gluon data API (counterpart of ``incubator_mxnet_tpu/gluon/data``)."""
from .dataloader import DataLoader, DevicePrefetchRing, default_batchify_fn
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset)
from .sampler import (BatchSampler, FilterSampler, RandomSampler, Sampler,
                      SequentialSampler)
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "DataLoader", "DevicePrefetchRing",
           "default_batchify_fn", "vision"]
