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
           "ptr", "count_lock", "dw_split", "vec16", "sms"]

#: the C entries' dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: guards the wrappers' launch counters
count_lock = threading.Lock()

#: rows of M a kernel block owns (BI in the sources): the forward and dx
#: kernels write one partial row per block, and refuse any other count
BLOCK_ROWS = 128
# dw splits M so that about this many blocks cover the card, each split
# at least _MIN_SPLIT_ROWS rows (a multiple of the kernels' depth of 8)
_DW_BLOCKS_PER_SM = 4
_MIN_SPLIT_ROWS = 256


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


def dw_split(m, rows_of_dw, cols_of_dw, device):
    """``(split_rows, splits)``: the runs of M over which a dw kernel
    writes its float32 partials of the (rows_of_dw, cols_of_dw) gradient.
    Enough runs that about ``_DW_BLOCKS_PER_SM`` blocks of 128x128 output
    cover every SM, none shorter than ``_MIN_SPLIT_ROWS`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-rows_of_dw // 128) * -(-cols_of_dw // 128)
    want = max(1, -(-_DW_BLOCKS_PER_SM * sms // tiles))
    rows = max(_MIN_SPLIT_ROWS, -(-m // want))
    rows = -(-rows // 8) * 8
    return rows, -(-m // rows)


def vec16(*tensors):
    """True when a bfloat16 tensor-core dw tile may load rows of every
    tensor 16 bytes at a time: each starts on 16 bytes and its rows are a
    multiple of 8 elements.  Else it loads element by element."""
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
               for t in tensors)


@functools.lru_cache(maxsize=None)
def sms(index):
    """The SMs of CUDA device ``index``, queried once (the wrappers of
    the fused ops and of the LayerNorm backward size their grids by
    it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
