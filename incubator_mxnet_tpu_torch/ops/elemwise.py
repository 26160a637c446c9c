"""Elementwise ops (subset of ``incubator_mxnet_tpu/ops/elemwise.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..amp.amp import cast_args

__all__ = ["gelu"]


def gelu(x):
    """Exact (erf) GELU, as the JAX package's ``gelu`` op
    (``approximate=False``); the tanh form is a different function."""
    (x,) = cast_args("gelu", x)
    return F.gelu(x)
