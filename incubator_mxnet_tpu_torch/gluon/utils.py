"""Gluon utilities (subset of ``incubator_mxnet_tpu/gluon/utils.py``;
reference ``python/mxnet/gluon/utils.py``).  ``split_and_load`` over
several devices waits for the port's multi-device slice."""
from __future__ import annotations

import torch

__all__ = ["split_data", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut along ``batch_axis`` into ``num_slice`` views; the
    last takes the remainder when ``even_split`` is False, and an
    uneven split raises otherwise."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"batch size {size} not divisible by {num_slice} slices")
    step = size // num_slice
    return [data.narrow(batch_axis, i * step,
                        step if i < num_slice - 1 else size - i * step)
            for i in range(num_slice)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (gradients, in place) so that their joint L2
    norm is at most ``max_norm``: the norm is taken in float32, and
    every array is multiplied by ``min(max_norm / (norm + 1e-12), 1)``
    in its own dtype.  Returns the norm before scaling, as a float when
    ``check_isfinite`` (which waits for the device) and as a 0-d
    float32 tensor otherwise."""
    total = torch.zeros((), dtype=torch.float32, device=arrays[0].device)
    for a in arrays:
        total = total + a.float().square().sum()
    norm = total.sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    with torch.no_grad():
        for a in arrays:
            a.mul_(scale.to(a.dtype))
    return float(norm) if check_isfinite else norm
