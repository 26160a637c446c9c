"""Datasets (counterpart of ``incubator_mxnet_tpu/gluon/data/dataset.py``).

A dataset is anything with ``__getitem__`` and ``__len__``; its samples
are numpy arrays, tensors, numbers or tuples of them, which
``DataLoader`` stacks on the host.
"""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """``fn`` over every sample (its fields as arguments when the
        sample is a tuple), applied at each read unless ``lazy`` is
        False, which applies it once now."""
        trans = _LazyTransformDataset(self, fn)
        if not lazy:
            return SimpleDataset([trans[i] for i in range(len(trans))])
        return trans

    def transform_first(self, fn, lazy=True):
        """``fn`` over the first field of every sample only."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)

        return self.transform(base_fn, lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        return SimpleDataset([self[i] for i in range(len(self))
                              if i % num_shards == index])


class SimpleDataset(Dataset):
    """A dataset over a list (or anything indexable)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


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


class ArrayDataset(Dataset):
    """The zip of equal-length arrays: sample ``i`` is ``(a[i], b[i],
    ...)``, or ``a[i]`` of a single array."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for i, a in enumerate(args):
            if len(a) != self._length:
                raise ValueError(f"array {i} has length {len(a)}, the first "
                                 f"{self._length}")
        self._data = list(args)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO file: sample ``i`` is the payload bytes
    of the ``i``-th key of the ``.idx`` file beside ``filename`` (the
    same name with ``.idx`` for its extension).  Decode them with
    :meth:`transform` (``recordio.unpack_raw`` for decoded images)."""

    def __init__(self, filename):
        from ... import recordio
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
