"""Numerics and launch helpers shared by the fused convolution + BatchNorm
ops: the 1x1 (``fused_block.py``, kernels 10-12) and the 3x3
(``fused_conv.py``, kernels 13-16).

The plain versions of both compute what their kernels compute: the
prologue relu(x*scale + bias) and the stats-adjusted cotangent dyt = dy
+ ds1 + 2*y*ds2 in float32, rounded to the operand dtype before the
product, the product in float32.
"""
from __future__ import annotations

import functools
import threading

import torch

__all__ = ["DTYPE_CODES", "BLOCK_ROWS", "acc", "prologue", "dyt", "f32",
           "ptr", "count_lock", "vec16", "sms"]

#: the C entries' dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: guards the wrappers' launch counters
count_lock = threading.Lock()

#: rows of M a kernel block owns (BI in the sources): the float32
#: forward and dx kernels write one partial row per block, and refuse any
#: other count
BLOCK_ROWS = 128


def acc(t):
    """The plain versions compute in float32 (float64 stays float64, for
    ``gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def prologue(x, scale, bias):
    """relu(x*scale + bias) computed wide, rounded to x's dtype, widened
    again; or x itself, widened, when there is no prologue."""
    if scale is None:
        return acc(x)
    z = acc(x) * acc(scale) + acc(bias)
    return acc(torch.relu(z).to(x.dtype))


def dyt(y, dy, ds1, ds2):
    """dy + ds1 + 2*y*ds2 computed wide, rounded to dy's dtype, widened
    again."""
    t = acc(dy) + acc(ds1) + 2.0 * acc(y) * acc(ds2)
    return acc(t.to(dy.dtype))


def f32(t):
    """A float32 contiguous copy of a per-channel vector, or None."""
    return None if t is None else t.float().contiguous()


def ptr(t):
    return None if t is None else t.data_ptr()


def vec16(*tensors):
    """True when a tensor-core tile may load rows of every tensor 16
    bytes at a time: each starts on 16 bytes and its rows are a multiple
    of 16 bytes (8 bfloat16 or 4 float32 elements).  Else it loads
    element by element."""
    return all(t.data_ptr() % 16 == 0
               and t.shape[-1] * t.element_size() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def sms(index):
    """The SMs of CUDA device ``index``, queried once (the wrappers of
    the fused ops and of the LayerNorm backward size their grids by
    it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
