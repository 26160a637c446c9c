"""DataLoader (counterpart of
``incubator_mxnet_tpu/gluon/data/dataloader.py``).

Batches are assembled in the calling process and yielded as CPU
tensors; the training loop moves them to the card with
``.to(device, non_blocking=True)`` (with ``pin_memory=True`` the copy
is asynchronous).  Worker processes and threads (``num_workers > 0``)
and the device prefetch ring of the JAX package's whole-loop training
are not ported yet (ROADMAP §A item 3) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "DevicePrefetchRing", "default_batchify_fn"]

_LATER = "(ROADMAP §A item 3: DataLoader workers and the device prefetch ring)"


def default_batchify_fn(data):
    """Stack samples into a batch on the host: tuples field by field,
    tensors with ``torch.stack``, numpy arrays and numbers through one
    numpy array (float64 narrowed to float32, as in the JAX package)."""
    first = data[0]
    if isinstance(first, tuple):
        return tuple(default_batchify_fn(list(s)) for s in zip(*data))
    if isinstance(first, torch.Tensor):
        return torch.stack(data, dim=0)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def _pin(batch):
    if isinstance(batch, tuple):
        return tuple(_pin(b) for b in batch)
    return batch.pin_memory()


class DataLoader:
    """Iterates over ``dataset`` in batches.

    ``batch_size`` with ``shuffle`` (a :class:`RandomSampler`) or
    ``sampler`` (any sampler of indices) and ``last_batch`` (``"keep"``,
    ``"discard"``, ``"rollover"``) build the :class:`BatchSampler`; or
    ``batch_sampler`` gives the index lists itself.  ``batchify_fn``
    stacks a list of samples (default :func:`default_batchify_fn`);
    ``pin_memory`` pins each batch's tensors for asynchronous copies to
    the card."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False):
        if num_workers:
            raise NotImplementedError(
                f"num_workers={num_workers}: DataLoader workers are not "
                f"ported yet {_LATER}")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must be False with a sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must be unset with a batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = pin_memory

    def __iter__(self):
        for indices in self._batch_sampler:
            batch = self._batchify_fn([self._dataset[i] for i in indices])
            yield _pin(batch) if self._pin_memory else batch

    def __len__(self):
        return len(self._batch_sampler)


class DevicePrefetchRing:
    """Not ported yet (ROADMAP §A item 3); it feeds the whole-loop
    training (``fuse_loop.ChunkedTrainLoop``) of item 6."""

    def __init__(self, batches, chunk_steps, depth=2):
        raise NotImplementedError(f"DevicePrefetchRing is not ported yet "
                                  f"{_LATER}")
