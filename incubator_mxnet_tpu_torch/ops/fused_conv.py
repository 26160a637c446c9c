"""The 3x3 convolution + BatchNorm statistics of the fused bottleneck.

Counterpart of ``incubator_mxnet_tpu/ops/fused_conv.py``, of its
composition ``xla_conv3_bn`` only.  The JAX package runs the 3x3 of a
fused bottleneck either through its Pallas conv kernels (kernels 13-16)
or, with ``MXNET_FUSED_CONV3=0``, through this composition, while the
1x1 kernels keep running.  The port's bottleneck calls
:func:`conv3_bn_composed` directly: that configuration, with no
environment switch and no kernel gate.  The conv kernels are a later
slice of the port; there this call moves to them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3_bn_composed"]


def conv3_bn_composed(x, w, scale=None, bias=None):
    """3x3 / stride 1 / pad 1 NHWC convolution with the BatchNorm
    statistics of its output → ``(y, s1, s2)``.

    x (N, H, W, C); w (3, 3, C, C_out) HWIO, as in the JAX package.
    With ``scale`` and ``bias`` (per-C float32 constants), the input is
    relu(x*scale + bias) in float32, rounded to x's dtype.  y comes out
    in x's dtype; ``s1 = sum(y)`` and ``s2 = sum(y²)`` are float32 per
    output channel over N*H*W, taken from the rounded y.  The product is
    PyTorch's convolution (cuDNN on the card), as XLA computes it in the
    JAX package."""
    if scale is not None:
        xn = torch.relu(x.float() * scale.float() + bias.float()).to(x.dtype)
    else:
        xn = x
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))
