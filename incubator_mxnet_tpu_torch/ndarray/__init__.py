"""Saving and loading arrays (counterpart of the serialization part of
``incubator_mxnet_tpu/ndarray/__init__.py``).

The port has no NDArray class: an array is a ``torch.Tensor``.
:func:`save` writes a list or dict of tensors in the ``.params`` format
(``params_io.py``), byte for byte as the JAX package writes the same
arrays, so files cross between the two packages (and reference MXNet)
both ways.  :func:`load` also reads the JAX package's first private
container, ``MXTPU001``.  Loaded tensors are on the CPU.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from . import params_io

__all__ = ["save", "load", "params_io"]

_MAGIC = b"MXTPU001"


def _tensor(arr):
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save(fname, data):
    """Save a tensor, a list of tensors or a ``{name: tensor}`` dict to
    ``fname`` in the ``.params`` format.  numpy arrays are taken too."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    named = isinstance(data, dict)
    items = list(data.items()) if named else [("", v) for v in data]
    wire = [(key, _tensor(arr)) for key, arr in items]
    with open(fname, "wb") as f:
        f.write(params_io.save_bytes(wire, named=named))


def load(fname):
    """Arrays saved by :func:`save`, by the JAX package or by reference
    MXNet: a ``{name: tensor}`` dict when the file names them, else a
    list.  An empty ("none") record loads as ``None``."""
    with open(fname, "rb") as f:
        raw = f.read()
    if raw[:8] != _MAGIC:
        arrays, names = params_io.load_bytes(raw)
        if names:
            return dict(zip(names, arrays))
        return arrays
    return _load_mxtpu001(raw)


def _load_mxtpu001(raw):
    """The JAX package's first container: int64 count, then per array
    its key, dtype name, shape and raw bytes (bfloat16 stored as
    float32)."""
    pos = 8

    def take(n):
        nonlocal pos
        out = raw[pos:pos + n]
        if len(out) != n:
            raise ValueError("truncated MXTPU001 file")
        pos += n
        return out

    def i64():
        return struct.unpack("<q", take(8))[0]

    arrays = []
    for _ in range(i64()):
        key = take(i64()).decode()
        dtype_name = take(i64()).decode()
        shape = tuple(i64() for _ in range(i64()))
        buf = take(i64())
        if dtype_name == "bfloat16":
            arr = torch.from_numpy(np.frombuffer(buf, "float32").reshape(
                shape).copy()).to(torch.bfloat16)
        else:
            arr = torch.from_numpy(np.frombuffer(buf, dtype_name).reshape(
                shape).copy())
        arrays.append((key, arr))
    if arrays and all(k for k, _ in arrays):
        return dict(arrays)
    return [v for _, v in arrays]
