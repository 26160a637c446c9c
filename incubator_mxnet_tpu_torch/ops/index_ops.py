"""Indexing ops (subset of ``incubator_mxnet_tpu/ops/index_ops.py``)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["embedding"]


def embedding(data, weight):
    """Row lookup ``weight[data]`` in ``clip`` mode: an id below 0 reads
    row 0 and one past the table reads the last row, as ``jnp.take``
    does in the JAX package.  ``F.embedding`` itself would raise on the
    CPU and fault on the card for such an id."""
    ids = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)
