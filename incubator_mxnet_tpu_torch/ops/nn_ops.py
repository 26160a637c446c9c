"""Neural-network ops (subset of ``incubator_mxnet_tpu/ops/nn_ops.py``).

Plain functions on tensors.  Where the JAX package left an op to XLA,
the port leaves it to PyTorch: :func:`convolution`, :func:`pooling` and
:func:`batch_norm` keep the JAX package's layouts and numerics (NHWC
weights ``(O, *K, I)``; float32 accumulation of low-precision average
pooling; one-pass float32 BatchNorm statistics) around PyTorch's calls.  :func:`layer_norm` and
:func:`softmax_xent` go through the hand-written kernels, forward and
backward, by way of their autograd Functions
(``layer_norm.LayerNormFunction``, ``softmax_xent.SoftmaxXentFunction``),
and so do :func:`softmax` and the trailing-axis :func:`rms_norm`
(``softmax.SoftmaxFunction``, ``rms_norm.RMSNormFunction``), on every
device, so the CPU tests run the same Functions as the card.
Each op casts its floating inputs through ``amp.cast_args`` under its
registry name in the JAX package, so a block converted by
``amp.convert_block`` runs each op in the dtype the AMP lists give it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _remat
from ..amp.amp import cast_args
from .layer_norm import LayerNormFunction
from .rms_norm import RMSNormFunction
from .softmax import SoftmaxFunction
from .softmax_xent import SoftmaxXentFunction

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "layer_norm", "rms_norm", "dot_product_attention", "activation",
           "dropout", "softmax", "log_softmax", "softmax_xent"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def fully_connected(x, weight, bias=None, no_bias=False, flatten=True):
    """y = x @ W^T + b, with W laid out ``(num_hidden, in_units)``.
    ``flatten`` folds every axis after the first into the input axis."""
    x, weight, bias = cast_args("FullyConnected", x, weight, bias)
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


def _channel_minor(layout):
    return layout is not None and layout.endswith("C")


def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None):
    """N-D convolution (N = 1, 2, 3).  The weight is ``(O, I/group, *K)``
    in the default channel-major layout, or ``(O, *K, I/group)`` for a
    channel-minor ``layout`` such as ``"NHWC"``, as in the JAX package.
    Channel-minor operands are handed to PyTorch as permuted views (its
    channels-last path); y comes out in x's layout and dtype, and the
    bias is added after the convolution."""
    x, weight, bias = cast_args("Convolution", x, weight, bias)
    nd = x.dim() - 2
    stride = _tuple(stride or 1, nd)
    dilate = _tuple(dilate or 1, nd)
    pad = _tuple(pad or 0, nd)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
    last = _channel_minor(layout)
    if last:
        x_, w_ = x.movedim(-1, 1), weight.movedim(-1, 1)
    else:
        x_, w_ = x, weight
    y = conv(x_, w_, None, stride, pad, dilate, num_group).to(x.dtype)
    if last:
        y = y.movedim(1, -1)
    if bias is not None and not no_bias:
        bshape = (1,) * (nd + 1) + (-1,) if last else (1, -1) + (1,) * nd
        y = y + bias.reshape(bshape)
    return y


def pooling(x, kernel=None, pool_type="max", global_pool=False, stride=None,
            pad=None, count_include_pad=True, pooling_convention="valid",
            layout=None):
    """Max or average pooling, windowed or global, channel-major or
    channel-minor (``layout="NHWC"``).  Padding counts as -inf for max
    and as 0 for average; ``count_include_pad=False`` divides by the
    window's in-image size instead of its full size.  Average pooling of
    a low-precision input accumulates in float32 and returns x's dtype,
    as the JAX package does.  A window larger than the padded map
    raises (the JAX pooling returns an empty map there, which a later
    layer trips over).  ``pooling_convention`` other than ``"valid"``
    and ``pool_type`` other than max and avg are not ported."""
    if pool_type not in ("max", "avg"):
        raise ValueError(f"pool_type {pool_type!r} is not ported (max, avg)")
    if pooling_convention != "valid":
        raise ValueError("pooling_convention must be 'valid'")
    (x,) = cast_args("Pooling", x)
    nd = x.dim() - 2
    last = _channel_minor(layout)
    low = x.dtype in (torch.float16, torch.bfloat16)
    if global_pool:
        axes = tuple(range(1, x.dim() - 1)) if last else tuple(range(2, x.dim()))
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        xs = x.float() if low else x
        return xs.mean(dim=axes, keepdim=True).to(x.dtype)
    kernel = _tuple(kernel, nd)
    stride = _tuple(stride or kernel, nd)
    pad = _tuple(pad or 0, nd)
    x_ = x.movedim(-1, 1) if last else x
    sides = tuple(x_.shape[2:])
    if any(s + 2 * p < k for s, p, k in zip(sides, pad, kernel)):
        raise ValueError(f"pooling: the window {kernel} is larger than the "
                         f"padded map {sides} (padding {pad}): no output")
    if pool_type == "max":
        y = getattr(F, f"max_pool{nd}d")(x_, kernel, stride, pad)
    else:
        xs = x_.float() if low else x_
        y = getattr(F, f"avg_pool{nd}d")(
            xs, kernel, stride, pad,
            count_include_pad=count_include_pad).to(x.dtype)
    return y.movedim(1, -1) if last else y


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, training=False):
    """BatchNorm over every axis but ``axis``.  In training (and without
    ``use_global_stats``) → ``(out, new_moving_mean, new_moving_var)``:
    one-pass float32 statistics, var = E[x²] - mean² clipped at 0 (the
    square taken in x's dtype), blended into the moving ones with
    ``momentum``; otherwise → out from the moving statistics.  The
    normalize is folded into a per-channel scale and bias computed in
    float32 and cast to x's dtype, as in the JAX package.  The layer
    writes the moving statistics back."""
    x, gamma, beta, moving_mean, moving_var = cast_args(
        "BatchNorm", x, gamma, beta, moving_mean, moving_var)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    ax = axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != ax)
    bshape = [1] * x.dim()
    bshape[ax] = x.shape[ax]
    g32 = gamma.float()
    if training and not use_global_stats:
        mean = x.float().mean(dim=axes)
        meansq = (x * x).float().mean(dim=axes)
        var = torch.clamp(meansq - mean * mean, min=0.0)
        new_mean = (momentum * moving_mean
                    + (1 - momentum) * mean.to(moving_mean.dtype))
        new_var = (momentum * moving_var
                   + (1 - momentum) * var.to(moving_var.dtype))
        rstd = torch.rsqrt(var + eps)
        scale = (g32 * rstd).to(x.dtype)
        bias = (beta.float() - mean * g32 * rstd).to(x.dtype)
        out = x * scale.reshape(bshape) + bias.reshape(bshape)
        return out, new_mean, new_var
    rstd = torch.rsqrt(moving_var.float() + eps)
    scale = (g32 * rstd).to(x.dtype)
    bias = (beta.float() - moving_mean.float() * g32 * rstd).to(x.dtype)
    return x * scale.reshape(bshape) + bias.reshape(bshape)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` with 1-D gamma and beta, differentiable in
    all three.  The axis is moved last for the kernels and back
    afterwards."""
    x, gamma, beta = cast_args("LayerNorm", x, gamma, beta)
    last = axis in (-1, x.dim() - 1)
    xm = x if last else x.movedim(axis, -1)
    y = LayerNormFunction.apply(xm.contiguous(), gamma, beta, float(eps))
    return y if last else y.movedim(-1, axis)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm over ``axis`` with a 1-D gamma.  Over the trailing axis it
    goes through the kernels, forward and backward, and y comes out in
    x's dtype.  Over another axis it is the JAX package's plain formula:
    y = x·rsqrt(mean(x²) + eps) in float32, rounded to x's dtype, then
    ``y * gamma`` with broadcasting and type promotion."""
    x, gamma = cast_args("RMSNorm", x, gamma)
    if axis in (-1, x.dim() - 1):
        return RMSNormFunction.apply(x.contiguous(), gamma, float(eps))
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False):
    """(B, H, T, D) scaled dot-product attention.  The logits and the
    softmax are float32, the probabilities are cast to q's dtype; keys
    where ``mask`` is false get -inf, so a row with no valid key is NaN,
    as in the JAX package."""
    q, k, v = cast_args("dot_product_attention", q, k, v)
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
    (x,) = cast_args("Activation", x)
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
    (x,) = cast_args("Dropout", x)
    if p <= 0.0 or mode != "training":
        return x
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    # a rematerialized region's recompute takes its first run's mask
    keep = _remat.keep("random", lambda: torch.rand(
        shape, generator=generator, device=x.device) >= p)
    # 1 - p rounded to x's dtype first, as JAX rounds the weak-typed
    # scalar; filled on the device, so a CUDA graph can capture it
    kept = x / torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax along ``axis`` through the kernels, forward and backward.
    ``temperature`` divides x first, rounded to x's dtype as JAX rounds a
    Python scalar; ``length`` (x's shape without ``axis``, integers)
    keeps the first ``length`` entries along the axis and sets the rest
    to -inf, so a row of length 0 is NaN, as ``jax.nn.softmax`` gives
    it."""
    (x,) = cast_args("softmax", x)
    if temperature is not None and temperature != 1.0:
        x = x / torch.full((), temperature, dtype=x.dtype, device=x.device)
    if length is not None:
        ax = axis % x.dim()
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        idx = torch.arange(x.shape[ax], device=x.device).reshape(shape)
        keep = idx < length.to(x.device).unsqueeze(ax)
        x = x.masked_fill(~keep, float("-inf"))
    return SoftmaxFunction.apply(x, axis)


def log_softmax(x, axis=-1, temperature=None):
    """Log-softmax along ``axis``; ``temperature`` divides x first,
    rounded to x's dtype as in :func:`softmax`."""
    (x,) = cast_args("log_softmax", x)
    if temperature is not None and temperature != 1.0:
        x = x / torch.full((), temperature, dtype=x.dtype, device=x.device)
    return torch.log_softmax(x, dim=axis)


def softmax_xent(logits, labels):
    """Softmax cross-entropy per row of ``logits`` (N, C): logsumexp(x) -
    x[clip(label, 0, C - 1)], through the hand-written kernels (forward
    and backward).  Labels go to int32; the loss, float32 inside, comes
    out in the logits' dtype, as in the JAX package."""
    logits, labels = cast_args("softmax_xent", logits, labels)
    lbl = labels.to(torch.int32)
    return SoftmaxXentFunction.apply(logits.contiguous(), lbl).to(
        logits.dtype)
