"""Quantization operators, int8 (counterpart of
``incubator_mxnet_tpu/ops/quantization_ops.py``).

The same 15 names with the same signatures, ranges and return triples.
Codes are signed int8 in the symmetric range [-127, 127] and a range is
carried as (min, max) floats, as in the JAX package:

* ``quantize``, ``dequantize``, ``quantized_dense`` and
  ``quantized_conv2d`` go through the hand-written kernels of
  ``ops/int8_conv.py`` (on a CPU tensor, their plain versions);
* the other ops are plain PyTorch compositions of the XLA ops the JAX
  ones use, int8 in and int8 or int32 out, with the same float32
  operations in the same order;
* ``calibrate_entropy`` is host numpy, as in the JAX package.

A range end may be a number, a CPU tensor of one value or a one-value
float32 tensor on the card.  Where every end of an op lies on the host
(the calibrated ranges of a quantized net), its scale arithmetic runs in
numpy float32, the same IEEE float32 operations as XLA's, and the op
returns its ranges as one-value CPU tensors; the kernels take them as
arguments, so nothing is copied from the host and a call can be captured
in a CUDA graph.  A range on the card (one ``quantize`` computed from
the data) keeps the arithmetic there.  Divisions are divisions: on the
card PyTorch multiplies by the reciprocal of a CPU scalar divisor, so
the ops divide by tensors on the data's device.

The JAX package's eager ops divide too; under ``jax.jit`` XLA's CPU
code multiplies by the reciprocal of a constant divisor and moves a code
now and then (ROADMAP §C).  The ops are bound in ``nd`` under the JAX
names and aliases (``_contrib_quantize_v2``/``quantize``, ...).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import int8_conv as _k

__all__ = ["quantize", "dequantize", "requantize", "quantized_dense",
           "quantized_conv2d", "quantized_pooling", "quantized_concat",
           "quantized_elemwise_add", "quantized_act", "quantized_flatten",
           "quantized_elemwise_mul", "quantized_embedding",
           "quantized_batch_norm", "calibrate_entropy", "OPS"]

_INT8_RANGE = np.float32(127.0)
_INT32_RANGE = np.float32(2 ** 31 - 1)      # 2^31 in float32
# the largest float32 below 2^31: a bias code clipped to it converts to
# int32 without overflow
_BIAS_LIMIT = 2147483520.0


def _on_host(*vals):
    return not any(_k._on_card(v) for v in vals)


def _dev(t, device):
    """A range end as a one-value float32 tensor on ``device`` (a fill
    for a host value: capturable)."""
    if isinstance(t, torch.Tensor) and t.device == torch.device(device):
        return t.reshape(()).float()
    return torch.full((), float(_k._host(t)), dtype=torch.float32,
                      device=device)


def _out(v):
    """A range end as the op returns it: a one-value float32 tensor (on
    the host for a host value)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).float()
    return torch.tensor(np.float32(v))


def _scale_from_range(min_range, max_range):
    return _k.range_scale(min_range, max_range, _INT8_RANGE)


def _amax(lo, hi, device):
    return torch.maximum(_dev(lo, device).abs(), _dev(hi, device).abs())


def _div(a, b):
    """``a / b`` in float32 as a true division, ``b`` a number or a
    one-value tensor, on ``a``'s device."""
    return a / _k._scale_tensor(b, a.device)


# -- the kernels' ops -----------------------------------------------------


def quantize(data, min_range=None, max_range=None, out_type="int8",
             channels_last=False):
    """float32 → int8 codes and the (min, max) range (reference
    quantize_v2-inl.h).  Without a range, the data's min and max.
    ``channels_last`` (the port's own) lays a 4-D tensor's codes out in
    ``torch.channels_last`` format, as the int8 convolution reads them;
    the values are the same."""
    if out_type != "int8":
        raise ValueError(f"quantize: out_type {out_type!r} is not ported; "
                         "the JAX op returns int8 codes whatever out_type "
                         "says (ROADMAP §C)")
    q, lo, hi = _k.quantize_int8(data, min_range, max_range, channels_last)
    return q, _out(lo), _out(hi)


def dequantize(data, min_range, max_range, out_type="float32"):
    """Codes → float32: int8 (and uint8) over 127, int32 sums over
    2^31 - 1 (reference DequantizeCompute's per-dtype ranges)."""
    if out_type != "float32":
        raise ValueError(f"dequantize: out_type {out_type!r} is not ported")
    return _k.dequantize(data, min_range, max_range)


def _bias_codes(bias, out_scale):
    """The float bias at the int32 sums' scale, clipped so that it
    converts without overflow."""
    q = torch.round(_div(bias.float(), out_scale))
    return q.clamp(-_BIAS_LIMIT, _BIAS_LIMIT).to(torch.int32)


def _product_scale(data_min, data_max, w_min, w_max):
    if _on_host(data_min, data_max, w_min, w_max):
        return _scale_from_range(data_min, data_max) * \
            _scale_from_range(w_min, w_max)
    dev = next(v.device for v in (data_min, data_max, w_min, w_max)
               if _k._on_card(v))
    return (_dev(_scale_from_range(data_min, data_max), dev)
            * _dev(_scale_from_range(w_min, w_max), dev))


def _as_int8(t):
    return t if t.dtype == torch.int8 else t.to(torch.int8)


def quantized_dense(data, weight, bias, data_min, data_max, w_min, w_max,
                    num_hidden=0):
    """int8 x int8 → int32 dense (quantized_fully_connected.cc): ``data``
    (..., K) against ``weight`` (units, K), run as a 1x1 convolution of a
    1x1 image.  Returns (int32 sums, out_min, out_max) with the implied
    float32 range."""
    data, weight = _as_int8(data), _as_int8(weight)
    out_scale = _product_scale(data_min, data_max, w_min, w_max)
    codes = None if bias is None else _bias_codes(bias, out_scale)
    lead = data.shape[:-1]
    k = data.shape[-1]
    acc = _k.int8_conv(data.reshape(-1, k, 1, 1),
                       weight.reshape(weight.shape[0], k, 1, 1), codes)
    acc = acc.reshape(*lead, weight.shape[0])
    out_max = out_scale * _INT32_RANGE
    return acc, _out(-out_max), _out(out_max)


def quantized_conv2d(data, weight, bias, data_min, data_max, w_min, w_max,
                     stride=(1, 1), pad=(0, 0), dilate=(1, 1)):
    """int8 NCHW convolution with int32 sums (quantized_conv.cc)."""
    data, weight = _as_int8(data), _as_int8(weight)
    out_scale = _product_scale(data_min, data_max, w_min, w_max)
    codes = None if bias is None else _bias_codes(bias, out_scale)
    acc = _k.int8_conv(data, weight, codes, stride, pad, dilate)
    out_max = out_scale * _INT32_RANGE
    return acc, _out(-out_max), _out(out_max)


# -- plain compositions ---------------------------------------------------


def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 sums → int8 codes in a new range (requantize-inl.h): the
    sums' implied scale is range / (2^31 - 1); the new range is the
    calibrated one or the data's."""
    dev = data.device
    in_scale = _div(_amax(min_range, max_range, dev).clamp_min(1e-12),
                    _INT32_RANGE)
    real = data.to(torch.float32) * in_scale
    min_c = real.min() if min_calib_range is None \
        else _dev(min_calib_range, dev)
    max_c = real.max() if max_calib_range is None \
        else _dev(max_calib_range, dev)
    out_scale = _div(_amax(min_c, max_c, dev).clamp_min(1e-12), _INT8_RANGE)
    q = torch.round(real / out_scale).clamp(-127.0, 127.0)
    return q.to(torch.int8), min_c, max_c


def _sum_pool(x, kernel, stride, pad):
    """Window sums of integer codes with zero padding, in float64 (exact),
    as int32."""
    n, c, h, w = x.shape
    cols = F.unfold(x.double(), kernel, padding=pad, stride=stride)
    oh = (h + 2 * pad[0] - kernel[0]) // stride[0] + 1
    ow = (w + 2 * pad[1] - kernel[1]) // stride[1] + 1
    return cols.reshape(n, c, kernel[0] * kernel[1], oh * ow).sum(2) \
        .reshape(n, c, oh, ow).to(torch.int32)


def quantized_pooling(data, min_data, max_data, kernel=None, pool_type="max",
                      stride=None, pad=None, global_pool=False):
    """int8 pooling; the range passes through (quantized_pooling.cc:
    pooling is monotone, the scale is kept).  Average pooling sums in
    int32, divides in float32 and rounds back."""
    if data.dtype not in (torch.int8, torch.uint8):
        raise ValueError("quantized_pooling expects int8/uint8 input")
    if pool_type not in ("max", "avg"):
        raise ValueError(f"quantized_pooling: pool_type {pool_type!r} is "
                         "not ported; the JAX op max-pools for anything but "
                         "'avg' (ROADMAP §C)")
    if not global_pool:
        kernel = _k._pair(kernel)
        stride = _k._pair(stride or kernel)
        pad = _k._pair(pad or 0)
    if pool_type == "avg":
        if global_pool:
            acc = data.to(torch.int32).sum((2, 3), keepdim=True)
            denom = data.shape[2] * data.shape[3]
        else:
            acc = _sum_pool(data, kernel, stride, pad)
            denom = kernel[0] * kernel[1]
        out = torch.round(_div(acc.to(torch.float32), np.float32(denom)))
        out = out.clamp(-128.0, 127.0).to(data.dtype)
    elif global_pool:
        out = data.amax((2, 3), keepdim=True)
    else:
        low = float(torch.iinfo(data.dtype).min)
        padded = F.pad(data.to(torch.float32),
                       (pad[1], pad[1], pad[0], pad[0]), value=low)
        out = F.max_pool2d(padded, kernel, stride).to(data.dtype)
    return out, min_data, max_data


def quantized_concat(*args, dim=1):
    """Concatenate int8 tensors of differing scales: each is requantized
    to the widest range first (quantized_concat.cc).  ``args`` are the n
    tensors, then their n mins, then their n maxs."""
    n = len(args) // 3
    datas, mins, maxs = args[:n], args[n:2 * n], args[2 * n:]
    dev = datas[0].device
    out_min, out_max = _dev(mins[0], dev), _dev(maxs[0], dev)
    for mn in mins[1:]:
        out_min = torch.minimum(out_min, _dev(mn, dev))
    for mx in maxs[1:]:
        out_max = torch.maximum(out_max, _dev(mx, dev))
    out_scale = _div(torch.maximum(out_min.abs(), out_max.abs()),
                     _INT8_RANGE)
    parts = []
    for d, mn, mx in zip(datas, mins, maxs):
        scale = _div(_amax(mn, mx, dev), _INT8_RANGE)
        parts.append(torch.round(d.to(torch.float32) * (scale / out_scale))
                     .clamp(-128.0, 127.0).to(d.dtype))
    return (torch.cat(parts, dim=dim), -out_scale * _INT8_RANGE,
            out_scale * _INT8_RANGE)


def quantized_elemwise_add(a, b, a_min, a_max, b_min, b_max):
    """int8 + int8 with the scales reconciled in int32
    (quantized_elemwise_add.cc)."""
    dev = a.device
    a_scale = _div(_amax(a_min, a_max, dev), _INT8_RANGE)
    b_scale = _div(_amax(b_min, b_max, dev), _INT8_RANGE)
    out_scale = torch.maximum(a_scale, b_scale)
    a_mult = torch.round(a_scale / out_scale * 64).to(torch.int32)
    b_mult = torch.round(b_scale / out_scale * 64).to(torch.int32)
    acc = a.to(torch.int32) * a_mult + b.to(torch.int32) * b_mult
    out_max = out_scale * 127.0 * 64 * 2
    return acc, -out_max, out_max


def quantized_act(data, min_data, max_data, act_type="relu"):
    """int8 ReLU (quantized_activation.cc): the negative codes go to 0 and
    the range passes through (the codes' scale is symmetric in it)."""
    if act_type != "relu":
        raise ValueError("quantized_act supports act_type='relu' only "
                         "(reference quantized_activation.cc)")
    return data.clamp_min(0).to(data.dtype), min_data, max_data


def quantized_flatten(data, min_data, max_data):
    """Shape only: the codes pass through (quantized_flatten.cc)."""
    return data.reshape(data.shape[0], -1), min_data, max_data


def quantized_elemwise_mul(a, b, a_min, a_max, b_min, b_max):
    """int8 * int8 → int32 with the product of the ranges' ends
    (quantized_elemwise_mul.cc)."""
    dev = a.device
    acc = a.to(torch.int32) * b.to(torch.int32)
    out_max = _amax(a_min, a_max, dev) * _amax(b_min, b_max, dev)
    return acc, -out_max, out_max


def quantized_embedding(data, weight, min_weight, max_weight,
                        input_dim=None, output_dim=None):
    """int8 row lookup (quantized_indexing_op.cc): the codes and the
    weight's range; an id outside the table is clipped into it."""
    idx = data.to(torch.int32).long().clamp(0, weight.shape[0] - 1)
    return weight[idx], min_weight, max_weight


def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data, max_data, eps=1e-3):
    """int8 BatchNorm with the moving statistics (quantized_batch_norm.cc):
    dequantize, normalize, requantize to the output's own range.  The
    reciprocal square root is PyTorch's (``torch.rsqrt``); XLA's CPU
    ``rsqrt`` rounds differently in the last bit, so the codes agree with
    the JAX op's where no value lies within an ulp of a tie."""
    dev = data.device
    scale_in = _div(_amax(min_data, max_data, dev), _INT8_RANGE)
    rstd = torch.rsqrt(moving_var.to(torch.float32) + eps)
    w = gamma.to(torch.float32) * rstd
    b = beta.to(torch.float32) - moving_mean.to(torch.float32) * w
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    y = (data.to(torch.float32) * scale_in) * w.reshape(bshape) \
        + b.reshape(bshape)
    out_amax = y.abs().max()
    q = torch.round(y / out_amax.clamp_min(1e-12) * 127.0).clamp(-127.0,
                                                                 127.0)
    return q.to(torch.int8), -out_amax, out_amax


def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-optimal threshold from a symmetric activation histogram
    (reference calibrate.cc ``_contrib_calibrate_entropy``): host numpy,
    as in the JAX package.  Returns (threshold, divergence) as numpy
    float32."""
    hist = np.asarray(hist, np.float64).ravel()
    edges = np.asarray(hist_edges, np.float64).ravel()
    num_bins = hist.size
    if edges.size != num_bins + 1:
        raise ValueError("hist_edges must have len(hist)+1 entries")
    if num_bins % 2 == 0:
        raise ValueError("calibrate_entropy needs an odd, zero-centered "
                         "bin count (reference calibrate.cc layout)")
    zero = num_bins // 2
    half_q = num_quantized_bins // 2
    best_div, best_t = np.inf, float(edges[-1])
    for i in range(half_q, zero + 1):
        start, stop = zero - i, zero + i + 1
        t = float(edges[stop])
        raw = hist[start:stop]          # the unfolded slice: q's source
        p = raw.copy()                  # p folds the clipped tails in
        p[0] += hist[:start + 1].sum() - hist[start]
        p[-1] += hist[stop - 1:].sum() - hist[stop - 1]
        if p.sum() == 0:
            continue
        n = p.size
        factor = n / num_quantized_bins
        idx = np.minimum((np.arange(n) / factor).astype(np.int64),
                         num_quantized_bins - 1)
        # bincount sums each bin in input order, as np.add.at does
        q_small = np.bincount(idx, weights=raw, minlength=num_quantized_bins)
        counts = np.bincount(idx, weights=(raw > 0).astype(np.float64),
                             minlength=num_quantized_bins)
        nzmask = counts[idx] > 0
        q = np.zeros(n)
        q[nzmask] = (q_small[idx] / np.maximum(counts[idx], 1.0))[nzmask]
        ps, qs = _smooth(p), _smooth(q)
        if ps is None or qs is None:
            continue
        ps, qs = ps / ps.sum(), qs / qs.sum()
        div = float(np.sum(ps * np.log(ps / qs)))
        if div < best_div:
            best_div, best_t = div, t
    return (np.float32(best_t),
            np.float32(best_div if np.isfinite(best_div) else 0.0))


def _smooth(d, eps=1e-4):
    """calibrate.cc's SmoothDistribution: eps into the empty bins, taken
    evenly from the others; None where that cannot be done."""
    zeros = d == 0
    nz = (~zeros).sum()
    if nz == 0:
        return None
    eps1 = eps * zeros.sum() / nz
    if eps1 >= 1.0:
        return None
    return d + eps * zeros - eps1 * (~zeros)


#: The ops under the JAX registry's names and aliases, as ``nd`` binds
#: them.
OPS = {
    "_contrib_quantize_v2": quantize, "quantize": quantize,
    "_contrib_dequantize": dequantize, "dequantize": dequantize,
    "_contrib_requantize": requantize, "requantize": requantize,
    "_contrib_quantized_fully_connected": quantized_dense,
    "quantized_dense": quantized_dense,
    "_contrib_quantized_conv": quantized_conv2d,
    "quantized_conv2d": quantized_conv2d,
    "_contrib_quantized_pooling": quantized_pooling,
    "quantized_pooling": quantized_pooling,
    "_contrib_quantized_concat": quantized_concat,
    "quantized_concat": quantized_concat,
    "_contrib_quantized_elemwise_add": quantized_elemwise_add,
    "quantized_elemwise_add": quantized_elemwise_add,
    "_contrib_quantized_act": quantized_act, "quantized_act": quantized_act,
    "_contrib_quantized_flatten": quantized_flatten,
    "quantized_flatten": quantized_flatten,
    "_contrib_quantized_elemwise_mul": quantized_elemwise_mul,
    "quantized_elemwise_mul": quantized_elemwise_mul,
    "_contrib_quantized_embedding": quantized_embedding,
    "quantized_embedding": quantized_embedding,
    "_contrib_quantized_batch_norm": quantized_batch_norm,
    "quantized_batch_norm": quantized_batch_norm,
    "_contrib_calibrate_entropy": calibrate_entropy,
    "calibrate_entropy": calibrate_entropy,
}
