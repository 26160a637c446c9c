"""Batch assembly of decoded images — resize, crop, mirror, normalize —
the CUDA kernel ``csrc/image_batch.cu``, its plain PyTorch version and
the per-sample geometry both take.

The kernel replaces no Pallas kernel: it is the card's counterpart of
the native image-record iterator's per-sample C++ work
(``src/image_iter.cc:334-435``), which the JAX package runs on the host.
Both versions compute the native values bit for bit: the bilinear
sample of ``ResizeBilinear`` (align-corners scales, integer floors, the
four-term sum in its order, + 0.5 and truncation to uint8) taken at the
crop's pixel of the resized image, mirrored if asked, then
``(px - mean[c]) * scale / std[c]`` in float32 (the grey sum first for
one channel).  Only the cropped pixels are computed.

Inputs, shared by both versions:

* ``src`` — one packed 1-D uint8 buffer of decoded HWC RGB images;
* ``table`` — int64 ``(B, 8)``: offset, h, w, rh, rw, y0, x0, mirror of
  each sample (:func:`sample_row`); h = 0 marks an empty slot, written
  as zeros;
* ``(B, C, H, W)`` — the output's shape, C = 3 or 1;
* ``mean``, ``std`` (three values each; only the first for C = 1) and
  ``scale``.

:func:`image_batch` dispatches on where ``src`` lies: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel on the
current stream or raises.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import _build

__all__ = ["image_batch", "image_batch_reference", "resized_size",
           "sample_row", "launches"]

#: Launches of the kernel so far; :func:`image_batch` adds one per
#: launch and nothing else touches it (a caller may reset it to 0).
launches = 0

_count_lock = threading.Lock()
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# the C entry's arguments (csrc/image_batch.cu)
_ARGS = [_I, _P, _P, _P, _I, _I, _I, _I] + [_F] * 7 + [_P]


def resized_size(h, w, height, width, resize):
    """``(rh, rw)``: the size the native iterator resizes an h x w image
    to (``src/image_iter.cc:377-392``): the short side to ``resize``
    and the other by ``lround`` of the aspect, or straight to
    (height, width) when ``resize`` is 0; then at least the output
    size."""
    def lround(v):
        whole = math.floor(v)
        return int(whole) + (1 if v - whole >= 0.5 else 0)

    if resize > 0:
        if h < w:
            rh, rw = resize, lround(float(w) * resize / h)
        else:
            rw, rh = resize, lround(float(h) * resize / w)
    else:
        rh, rw = height, width
    return max(rh, height), max(rw, width)


def sample_row(offset, h, w, rh, rw, y0, x0, mirror):
    """One sample's row of the table, as ints."""
    return [int(offset), int(h), int(w), int(rh), int(rw), int(y0), int(x0),
            int(bool(mirror))]


def _normalization(mean, std, scale):
    """The native iterator's constants as float32: a std or scale that
    is not positive counts as 1."""
    mean = [np.float32(m) for m in mean]
    std = [np.float32(s if s > 0 else 1.0) for s in std]
    scale = np.float32(scale if scale > 0 else 1.0)
    return mean, std, scale


def _scalar(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def image_batch_reference(src, table, shape, mean=(0.0, 0.0, 0.0),
                          std=(1.0, 1.0, 1.0), scale=1.0):
    """Plain PyTorch version: the same float32 operations as the kernel
    and the native code, in the same order, one sample at a time."""
    batch, channels, height, width = shape
    mean, std, scale = _normalization(mean, std, scale)
    out = torch.zeros(shape, dtype=torch.float32, device=src.device)
    rows = table.tolist()
    ys_out = torch.arange(height, device=src.device)
    xs_out = torch.arange(width, device=src.device)
    for b, (offset, h, w, rh, rw, y0, x0, mirror) in enumerate(rows):
        if h == 0:
            continue
        img = src[offset:offset + h * w * 3].view(h, w, 3)
        ys = np.float32(h - 1) / np.float32(rh - 1) if rh > 1 \
            else np.float32(0)
        xs = np.float32(w - 1) / np.float32(rw - 1) if rw > 1 \
            else np.float32(0)
        ry = (ys_out + y0).float()
        rx = ((width - 1 - xs_out) if mirror else xs_out) + x0
        fy = ry * _scalar(ys, src.device)
        fx = rx.float() * _scalar(xs, src.device)
        iy0 = fy.to(torch.int64)        # truncation, fy >= 0
        ix0 = fx.to(torch.int64)
        iy1 = (iy0 + 1).clamp(max=h - 1)
        ix1 = (ix0 + 1).clamp(max=w - 1)
        wy = (fy - iy0.float())[:, None, None]
        wx = (fx - ix0.float())[None, :, None]
        wy1, wx1 = 1 - wy, 1 - wx
        top, bot = img[iy0].float(), img[iy1].float()
        v = (top[:, ix0] * wy1 * wx1 + top[:, ix1] * wy1 * wx
             + bot[:, ix0] * wy * wx1 + bot[:, ix1] * wy * wx)
        px = (v + 0.5).to(torch.int32).float()      # truncation to uint8
        sc = _scalar(scale, src.device)
        if channels == 3:
            for c in range(3):
                out[b, c] = (px[..., c] - _scalar(mean[c], src.device)) \
                    * sc / _scalar(std[c], src.device)
        else:
            grey = (_scalar(0.299, src.device) * px[..., 0]
                    + _scalar(0.587, src.device) * px[..., 1]
                    + _scalar(0.114, src.device) * px[..., 2])
            out[b, 0] = (grey - _scalar(mean[0], src.device)) * sc \
                / _scalar(std[0], src.device)
    return out


def _check(src, table, shape):
    batch, channels, height, width = shape
    if src.device.type != "cuda":
        raise ValueError(f"image_batch: unsupported device {src.device}")
    if src.dtype != torch.uint8 or src.dim() != 1 or not src.is_contiguous():
        raise TypeError("image_batch: src must be a contiguous 1-D uint8 "
                        f"tensor, got {src.dtype} {tuple(src.shape)}")
    if table.dtype != torch.int64 or tuple(table.shape) != (batch, 8):
        raise ValueError(f"image_batch: table must be int64 ({batch}, 8), "
                         f"got {table.dtype} {tuple(table.shape)}")
    if table.device != src.device or not table.is_contiguous():
        raise ValueError("image_batch: table must be contiguous on "
                         f"{src.device}, got {table.device}")
    if channels not in (1, 3) or min(height, width) < 1 or batch < 0:
        raise ValueError(f"image_batch: bad output shape {tuple(shape)}")


def image_batch(src, table, shape, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                scale=1.0):
    """Resize, crop, mirror and normalize a batch of decoded images →
    float32 ``shape`` = (B, C, H, W) on ``src``'s device.  On a CUDA
    tensor: the hand-written kernel, on the current stream (``table``
    on the same device).  On a CPU tensor: the plain version."""
    shape = tuple(int(v) for v in shape)
    if src.device.type == "cpu":
        return image_batch_reference(src, table, shape, mean, std, scale)
    _check(src, table, shape)
    batch, channels, height, width = shape
    mean, std, scale = _normalization(mean, std, scale)
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    if batch == 0:
        return out
    fn = _build.launcher("image_batch", "mx_image_batch", _ARGS)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        fn(src.device.index, src.data_ptr(), table.data_ptr(),
           out.data_ptr(), batch, channels, height, width,
           *(float(m) for m in mean), *(float(s) for s in std),
           float(scale), stream)
    global launches
    with _count_lock:
        launches += 1
    return out
