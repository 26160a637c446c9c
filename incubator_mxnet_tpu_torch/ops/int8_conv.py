"""The int8 path's kernels: the int8 convolution with int32 sums
(``csrc/int8_conv.cu``), quantize and dequantize (``csrc/quantize.cu``),
and their plain PyTorch versions.

None of them replaces a Pallas kernel: the JAX package computes all
three with XLA ops (``ops/quantization_ops.py``: ``quantize`` :34-48,
``dequantize`` :51-61, the int8 product of ``quantized_dense`` :91-93
and ``quantized_conv2d`` :116-122).  PyTorch has no int8 convolution on
CUDA, so the product is a hand-written kernel on the card's int8 tensor
cores.

* :func:`int8_conv` — int8 NCHW codes x int8 OIHW weight → int32 NCHW,
  with stride, pad and dilation and an optional int32 bias (one value an
  output channel) added at the end.  The int32 sums wrap, as XLA's do.
  The kernel reads the codes and the weight channels-last: the wrapper
  makes each so with a copy unless it already is (a weight stored in
  ``torch.channels_last`` format needs none, a 1x1 image never does).
* :func:`quantize_int8` — float32 → int8 codes ``clip(rint(x / scale),
  -127, 127)`` with ``scale = max(max(|lo|, |hi|), 1e-12) / 127`` in
  float32; without a range, the tensor's min and max first (one
  reduction pass).  With ``channels_last`` a 4-D tensor's codes are
  written in ``torch.channels_last`` format (the same values, laid out
  as the convolution reads them: no copy there).
* :func:`dequantize` — int8 or int32 codes → float32 ``q * scale``,
  ``scale = max(max(|lo|, |hi|), 1e-12) / qrange``: 127 for int8,
  float32(2^31 - 1) = 2^31 for int32.

A range end is a number (a Python or numpy float, or a CPU tensor of
one value: it is rounded to float32, as the JAX op's ``jnp.asarray(v,
float32)`` does) or a one-value float32 tensor on the card (a range the
reduction computed), which the kernels read there, so no call copies
from the host and a call can be captured in a CUDA graph.

Each wrapper dispatches on where its tensor lies: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel on the current stream
or raises.  The plain versions compute the same function exactly: the
same float32 operations (division, not a reciprocal: on the card PyTorch
multiplies by the reciprocal of a CPU scalar divisor, so the plain
versions divide by a tensor on the data's device), and the convolution
in float64, exact while C·kh·kw·127² stays below 2^53, wrapped to int32.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["int8_conv", "int8_conv_reference", "quantize_int8",
           "quantize_int8_reference", "dequantize", "dequantize_reference",
           "range_scale", "conv_out_size", "conv_launches",
           "quantize_launches", "dequantize_launches"]

#: Launches of each kernel so far; each wrapper adds one per call that
#: launches its kernel on the card, and nothing else touches them (a
#: caller may reset them to 0).  ``quantize_launches`` counts a call
#: without a range once, reduction included.
conv_launches = 0
quantize_launches = 0
dequantize_launches = 0

_count_lock = threading.Lock()
_I, _I64, _P, _F = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, \
    ctypes.c_float
_CONV_ARGS = [_I, _P, _P, _P, _P] + [_I] * 16 + [_P]
_QUANT_ARGS = [_I, _P, _P, _I64, _I, _P, _P, _F, _F, _P]
_QUANT_NHWC_ARGS = [_I, _P, _P, _I, _I, _I64, _P, _P, _F, _F, _P]
_MINMAX_ARGS = [_I, _P, _I64, _I, _P, _P, _P]
_DEQUANT_ARGS = [_I, _P, _I, _P, _I64, _I, _P, _P, _F, _F, _P]

_INT8_RANGE = np.float32(127.0)
_INT32_RANGE = np.float32(2 ** 31 - 1)      # 2^31 in float32
_TINY = np.float32(1e-12)


def _count(name):
    with _count_lock:
        globals()[name] += 1


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(e)
                                                             for e in v)


def conv_out_size(size, k, stride, pad, dilate):
    return (size + 2 * pad - dilate * (k - 1) - 1) // stride + 1


def _on_card(v):
    return isinstance(v, torch.Tensor) and v.device.type == "cuda"


def _host(v):
    """A range end held on the host, as the float32 the JAX op makes of
    it."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return np.float32(v)


def _qrange(dtype):
    return _INT8_RANGE if dtype in (torch.int8, torch.uint8) else \
        _INT32_RANGE


def range_scale(lo, hi, qrange):
    """``max(max(|lo|, |hi|), 1e-12) / qrange`` in float32: a numpy
    float32 where both ends are on the host, else a one-value tensor on
    the ends' device."""
    if not (_on_card(lo) or _on_card(hi)):
        lo, hi = _host(lo), _host(hi)
        return np.maximum(np.maximum(np.abs(lo), np.abs(hi)), _TINY) / \
            np.float32(qrange)
    dev = lo.device if _on_card(lo) else hi.device
    lo = lo if _on_card(lo) else torch.full((), float(_host(lo)),
                                            device=dev)
    hi = hi if _on_card(hi) else torch.full((), float(_host(hi)),
                                            device=dev)
    amax = torch.maximum(lo.float().abs(), hi.float().abs()).clamp_min(
        float(_TINY))
    return amax / torch.full((), float(qrange), device=dev)


def _scale_tensor(scale, device):
    """A float32 scale as a one-value tensor on ``device``, the divisor
    or factor of an exact elementwise operation there."""
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32)
    # a fill, not a copy from the host: capturable in a CUDA graph
    return torch.full((), float(scale), dtype=torch.float32, device=device)


def _range_arg(v, device):
    """``(pointer, value, keep)`` of a range end for a kernel: a one-value
    float32 tensor on the card by pointer, a number by value."""
    if _on_card(v):
        if v.device != device or v.numel() != 1:
            raise ValueError(f"a range end on {v.device} of {v.numel()} "
                             f"values for data on {device}")
        t = v.reshape(()).float().contiguous()
        return t.data_ptr(), 0.0, t
    return None, float(_host(v)), None


# -- quantize -----------------------------------------------------------


def _layout(channels_last, x):
    return torch.channels_last if channels_last and x.dim() == 4 else \
        torch.contiguous_format


def quantize_int8_reference(x, min_range=None, max_range=None,
                            channels_last=False):
    """Plain version of :func:`quantize_int8`: the JAX op's float32
    operations in PyTorch, on x's device."""
    if min_range is None:
        min_range = x.min()
    if max_range is None:
        max_range = x.max()
    scale = _scale_tensor(range_scale(min_range, max_range, _INT8_RANGE),
                          x.device)
    q = torch.round(x.float() / scale).clamp(-127.0, 127.0).to(torch.int8)
    return (q.contiguous(memory_format=_layout(channels_last, x)), min_range,
            max_range)


def quantize_int8(x, min_range=None, max_range=None, channels_last=False):
    """float32 ``x`` → ``(int8 codes, min_range, max_range)``.  A range
    end not given is the tensor's min or max (a one-value tensor on x's
    device); given ones are returned as given.  ``channels_last``: a 4-D
    tensor's codes in ``torch.channels_last`` format.  On a CUDA tensor:
    the kernel (with the reduction first where an end is missing), on
    the current stream.  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return quantize_int8_reference(x, min_range, max_range,
                                       channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"quantize_int8: float data expected, got {x.dtype}")
    x = x.float().contiguous()      # a narrower float widens exactly
    n = x.numel()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        vec = int(x.data_ptr() % 16 == 0)
        if min_range is None or max_range is None:
            if n == 0:
                raise ValueError("quantize_int8: no range given and no "
                                 "values to take it from")
            parts = torch.empty(2048, dtype=torch.float32, device=dev)
            found = torch.empty(2, dtype=torch.float32, device=dev)
            _build.launcher("quantize", "mx_minmax", _MINMAX_ARGS)(
                dev.index, x.data_ptr(), n, vec, parts.data_ptr(),
                found.data_ptr(), stream)
            if min_range is None:
                min_range = found[0]
            if max_range is None:
                max_range = found[1]
        lo_p, lo, keep_lo = _range_arg(min_range, dev)
        hi_p, hi, keep_hi = _range_arg(max_range, dev)
        layout = _layout(channels_last, x)
        q = torch.empty(x.shape, dtype=torch.int8, device=dev,
                        memory_format=layout)
        if layout == torch.channels_last:
            b, c, h, w = x.shape
            _build.launcher("quantize", "mx_quantize_int8_nhwc",
                            _QUANT_NHWC_ARGS)(
                dev.index, x.data_ptr(), q.data_ptr(), b, c, h * w, lo_p,
                hi_p, lo, hi, stream)
        else:
            _build.launcher("quantize", "mx_quantize_int8", _QUANT_ARGS)(
                dev.index, x.data_ptr(), q.data_ptr(), n, vec, lo_p, hi_p,
                lo, hi, stream)
        del keep_lo, keep_hi
    _count("quantize_launches")
    return q, min_range, max_range


# -- dequantize ---------------------------------------------------------


def dequantize_reference(q, min_range, max_range):
    """Plain version of :func:`dequantize`."""
    scale = _scale_tensor(range_scale(min_range, max_range,
                                      _qrange(q.dtype)), q.device)
    return q.to(torch.float32) * scale


def dequantize(q, min_range, max_range):
    """int8 or int32 codes → float32 ``q * scale`` (see the module
    docstring).  On a CUDA tensor: the kernel, on the current stream.
    On a CPU tensor: the plain version."""
    if q.device.type == "cpu":
        return dequantize_reference(q, min_range, max_range)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q.device}")
    if q.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"dequantize: int8 or int32 codes expected, got "
                        f"{q.dtype}")
    q = q.contiguous()
    dev = q.device
    bits = 8 if q.dtype == torch.int8 else 32
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    vec = int(q.data_ptr() % (4 if bits == 8 else 16) == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lo_p, lo, keep_lo = _range_arg(min_range, dev)
        hi_p, hi, keep_hi = _range_arg(max_range, dev)
        _build.launcher("quantize", "mx_dequantize", _DEQUANT_ARGS)(
            dev.index, q.data_ptr(), bits, out.data_ptr(), q.numel(), vec,
            lo_p, hi_p, lo, hi, stream)
        del keep_lo, keep_hi
    _count("dequantize_launches")
    return out


# -- the int8 convolution -----------------------------------------------


def _wrap_int32(v):
    """int64 values wrapped to int32, as int32 sums wrap."""
    return (torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def int8_conv_reference(x, w, bias=None, stride=(1, 1), pad=(0, 0),
                        dilate=(1, 1)):
    """Plain version of :func:`int8_conv`: the convolution of the codes in
    float64 (exact), the bias added in int64, wrapped to int32."""
    y = F.conv2d(x.double(), w.double(), None, _pair(stride), _pair(pad),
                 _pair(dilate)).to(torch.int64)
    if bias is not None:
        y = y + bias.to(torch.int64).reshape(1, -1, 1, 1)
    return _wrap_int32(y)


def _channels_last(t):
    """``t`` (N, C, H, W) as a contiguous (N, H, W, C) view, copied only
    where it is not one already or does not start on 16 bytes."""
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous() or v.data_ptr() % 16:
        v = v.contiguous()
    return v


def int8_conv(x, w, bias=None, stride=(1, 1), pad=(0, 0), dilate=(1, 1)):
    """int8 ``x`` (N, C, H, W) * int8 ``w`` (C_out, C, kh, kw) → int32
    (N, C_out, OH, OW), plus ``bias`` (int32, (C_out,)) where given; the
    sums wrap.  On a CUDA tensor: the kernel, on the current stream.  On
    a CPU tensor: the plain version."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    if x.device.type == "cpu":
        return int8_conv_reference(x, w, bias, stride, pad, dilate)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv: int8 codes expected, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"int8_conv: x {tuple(x.shape)} and weight "
                         f"{tuple(w.shape)} do not make an NCHW/OIHW "
                         "convolution")
    if w.device != x.device:
        raise ValueError(f"int8_conv: weight on {w.device}, x on {x.device}")
    n, c, h, wd = x.shape
    co, _, kh, kw = w.shape
    oh = conv_out_size(h, kh, stride[0], pad[0], dilate[0])
    ow = conv_out_size(wd, kw, stride[1], pad[1], dilate[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"int8_conv: a {kh}x{kw} window does not fit the "
                         f"padded {h}x{wd} image")
    if bias is not None:
        if bias.dtype != torch.int32 or bias.shape != (co,):
            raise ValueError(f"int8_conv: bias must be int32 ({co},), got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        bias = bias.to(x.device).contiguous()
    xl, wl = _channels_last(x), _channels_last(w)
    out = torch.empty((n, co, oh, ow), dtype=torch.int32, device=x.device)
    vec = int(c % 16 == 0)
    fn = _build.launcher("int8_conv", "mx_int8_conv", _CONV_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(x.device.index, xl.data_ptr(), wl.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(), n, c,
           h, wd, co, kh, kw, oh, ow, *stride, *pad, *dilate, vec, stream)
    _count("conv_launches")
    return out
