"""Shape ops (subset of ``incubator_mxnet_tpu/ops/shape_ops.py``):
``concat``, which DenseNet, Inception and SqueezeNet join their
branches with, and ``space_to_depth``, which the ResNet ``"s2d"`` stem
runs."""
from __future__ import annotations

import torch

from ..amp.amp import cast_args

__all__ = ["concat", "space_to_depth"]


def concat(*xs, dim=1, axis=None):
    """The tensors joined along ``dim`` (or ``axis``, which wins), in the
    widest floating dtype among them under AMP, as the JAX package's
    ``concat`` runs in its widest-type list."""
    xs = cast_args("concat", *xs)
    return torch.cat(xs, dim=dim if axis is None else axis)


def space_to_depth(x, block_size=1):
    """NCHW ``(N, C, H, W)`` → ``(N, C·b², H/b, W/b)``: each b x b block
    of pixels moved into the channels, its (row, column) offset major and
    the channel minor, as the JAX op orders them."""
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)
