"""Conv + BatchNorm folding for inference (counterpart of
``incubator_mxnet_tpu/gluon/contrib/fuse_bn.py``).

With frozen moving statistics ``BN(conv(x, W)) == conv(x, W * s) + b``
where, per output channel,

    s = gamma / sqrt(moving_var + eps)
    b = beta - moving_mean * s

Folding rewrites the convolution's weight and bias in place, in float32,
and puts an ``Identity`` where the BatchNorm was: one pass over each
activation less, and one layer for a quantization calibrator where
there were two.  Inference only: a folded net has no batch statistics
to train with.  Pairs are found by declaration order: a ``Conv2D``
without an activation directly followed by a ``BatchNorm`` among the
same block's children, as in every model-zoo family.  The square root is
taken in float64 and rounded once, the correctly rounded float32 square
root (the JAX package's XLA ``sqrt`` on the CPU is one too).
"""
from __future__ import annotations

import warnings

import torch
from torch import nn as tnn
from torch.nn.parameter import UninitializedParameter

from ...autograd import track
from ..nn import BatchNorm, Conv2D, Identity

__all__ = ["fuse_conv_bn"]


@torch.no_grad()
def _fold_pair(conv, bn):
    gamma = bn.gamma.float() if bn._scale else torch.ones_like(
        bn.gamma, dtype=torch.float32)
    beta = bn.beta.float() if bn._center else torch.zeros_like(
        bn.beta, dtype=torch.float32)
    mean, var = bn.running_mean.float(), bn.running_var.float()
    root = torch.sqrt((var + bn._epsilon).double()).float()
    s = gamma / root
    b = beta - mean * s
    w = conv.weight
    # the output channel is axis 0 in both weight layouts
    w.copy_((w.float() * s.reshape((-1,) + (1,) * (w.dim() - 1)))
            .to(w.dtype))
    if conv.bias is None:
        # a convolution built with use_bias=False gains a bias
        conv.bias = tnn.Parameter(b.to(w.dtype))
        conv._use_bias = True
        track(conv.bias)
    else:
        conv.bias.copy_((conv.bias.float() * s + b).to(conv.bias.dtype))


def fuse_conv_bn(net):
    """Fold every adjacent ``Conv2D`` → ``BatchNorm`` pair under ``net`` in
    place (an inference-only transform); returns the number of pairs
    folded."""
    folded = 0
    pairs = []

    def walk(block):
        nonlocal folded
        children = list(block.named_children())
        for i, (name, child) in enumerate(children):
            if (isinstance(child, Conv2D)
                    and child._activation is None  # it runs after the conv
                    and i + 1 < len(children)):
                nxt_name, nxt = children[i + 1]
                if (type(nxt) is BatchNorm
                        and not isinstance(nxt.running_mean,
                                           UninitializedParameter)
                        and not isinstance(child.weight,
                                           UninitializedParameter)):
                    pairs.append(f"{name}->{nxt_name}")
                    _fold_pair(child, nxt)
                    setattr(block, nxt_name, Identity())
                    folded += 1
        for _, child in block.named_children():
            walk(child)

    walk(net)
    if pairs:
        warnings.warn(
            f"fuse_conv_bn folded {folded} conv->BN pair(s) by "
            f"declaration-order adjacency: {', '.join(pairs[:8])}"
            + (", ..." if len(pairs) > 8 else "")
            + " — verify dataflow adjacency on custom (non-zoo) blocks",
            stacklevel=2)
    return folded
