"""Indexing ops (subset of ``incubator_mxnet_tpu/ops/index_ops.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.amp import cast_args

__all__ = ["embedding", "pick"]


def embedding(data, weight):
    """Row lookup ``weight[data]`` in ``clip`` mode: an id below 0 reads
    row 0 and one past the table reads the last row, as ``jnp.take``
    does in the JAX package.  ``F.embedding`` itself would raise on the
    CPU and fault on the card for such an id."""
    data, weight = cast_args("Embedding", data, weight)
    ids = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (index has data's shape without
    that axis), as the JAX package's ``take_along_axis(mode="clip")``
    takes it: a negative index counts from the end, and an index still
    outside the axis is clamped into it.  (``softmax_xent`` clamps a
    negative label to 0 instead.)  ``"clip"`` is the only mode ported."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported; have 'clip'")
    data, index = cast_args("pick", data, index)
    n = data.shape[axis]
    idx = index.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
