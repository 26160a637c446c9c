"""Neural-network ops (subset of ``incubator_mxnet_tpu/ops/nn_ops.py``).

Plain functions on tensors.  Where the JAX package left an op to XLA,
the port leaves it to PyTorch; :func:`layer_norm` goes through the
hand-written kernel (``layer_norm.layer_norm_fwd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layer_norm import layer_norm_fwd

__all__ = ["fully_connected", "layer_norm", "dot_product_attention",
           "activation", "dropout"]


def fully_connected(x, weight, bias=None, no_bias=False, flatten=True):
    """y = x @ W^T + b, with W laid out ``(num_hidden, in_units)``.
    ``flatten`` folds every axis after the first into the input axis."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` with 1-D gamma and beta.  The axis is
    moved last for the kernel and back afterwards."""
    last = axis in (-1, x.dim() - 1)
    xm = x if last else x.movedim(axis, -1)
    y = layer_norm_fwd(xm.contiguous(), gamma, beta, float(eps))[0]
    return y if last else y.movedim(-1, axis)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False):
    """(B, H, T, D) scaled dot-product attention.  The logits and the
    softmax are float32, the probabilities are cast to q's dtype; keys
    where ``mask`` is false get -inf, so a row with no valid key is NaN,
    as in the JAX package."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t, s = logits.shape[-2:]
        keep = torch.ones(t, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh}


def activation(x, act_type="relu"):
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"activation {act_type!r} is not ported; have "
                         f"{sorted(_ACTIVATIONS)}") from None
    return fn(x)


def dropout(x, p=0.5, mode="training", axes=(), generator=None):
    """Inverted dropout.  Identity when ``mode`` is not ``"training"``
    or ``p`` is 0; otherwise keeps each element (or each slice along
    ``axes``, which share one draw) with probability ``1 - p``."""
    if p <= 0.0 or mode != "training":
        return x
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
