"""Samplers (counterpart of ``incubator_mxnet_tpu/gluon/data/sampler.py``)."""
from __future__ import annotations

import torch

from ... import random as random_mod

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start``, ``start + 1``, ... for ``length`` indices."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of ``range(length)`` on every pass, drawn from
    ``generator`` (a CPU ``torch.Generator``), or from
    ``random.generator()`` — which ``random.seed`` seeds — without
    one."""

    def __init__(self, length, generator=None):
        self._length = length
        self._generator = generator

    def __iter__(self):
        gen = self._generator or random_mod.generator()
        return iter(torch.randperm(self._length, generator=gen).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Groups a sampler's indices into lists of ``batch_size``.  A last
    batch that comes up short is yielded (``"keep"``), dropped
    (``"discard"``), or carried to the front of the next pass
    (``"rollover"``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise ValueError(f"unknown last_batch {last_batch!r} (keep, "
                             "discard or rollover)")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class FilterSampler(Sampler):
    """The indices of the samples of ``dataset`` for which ``fn`` is
    true."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
