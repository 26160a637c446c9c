"""Fused 3x3 convolution + BatchNorm for the bottleneck's stage convs: the
CUDA kernels, their plain PyTorch versions and the autograd Function
that joins them.

Counterpart of ``incubator_mxnet_tpu/ops/fused_conv.py``.  A 3x3 /
stride 1 / pad 1 NHWC convolution is nine shifted products over the
flattened N*H*W rows; :func:`fused_conv3_bn` computes

    y = conv3x3([relu(x*scale + bias)], w),  s1 = sum y,  s2 = sum y^2

so the previous BatchNorm's normalize + ReLU runs in the convolution's
prologue (the normalized activation is never stored) and the next
BatchNorm's batch statistics come out of its epilogue.  An out-of-image
neighbour contributes 0: the zero padding is of the normalized input.
The backward keeps the property: dx is the nine-tap transposed
convolution of the stats-adjusted cotangent with the ReLU / normalize
backward and the dscale, dbias sums as its epilogue; dw recomputes the
prologue.

Three kernels (``csrc/fused_conv3_bn.cu``), one wrapper each:
:func:`fused_conv3_bn_fwd` (TPU kernel 13), :func:`fused_conv3_bn_dx`
(kernels 14 and 15: the TPU's split of C_out into blocks, a VMEM limit,
has no counterpart) and :func:`fused_conv3_bn_dw` (16), each with a
launch counter.  Each has one instance for each dtype, every one a tile
on the tensor cores.  bfloat16 runs ``fused_conv3_bn_fwd_mma``, over
runs of pixels that :func:`fwd_mma_split` chooses;
``fused_conv3_bn_dx_mma``, over those of :func:`dx_mma_split`; and
``fused_conv3_bn_dw_mma``, over those of :func:`dw_mma_split`.  float32
runs tiles that keep float32 numbers in three tf32 products, on the
bfloat16 tiles' walk: ``fused_conv3_bn_fwd_tf32`` and
``fused_conv3_bn_dx_tf32``, over the runs of the same split rules, and
``fused_conv3_bn_dw_tf32``, over those of :func:`dw_tf32_split`.
Each wrapper dispatches on where x lies: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
Nothing falls back, and there is no switch: on the card every 3x3 of the
fused bottleneck runs on the kernels, whatever its geometry.

Numerics, as the TPU kernels' and ``fused_block.py``'s: operands in the
input dtype (float32 or bfloat16), float32 accumulation, the prologue
and dyt = dy + ds1 + 2*y*ds2 in float32 rounded to the input dtype
before the product, statistics from the *rounded* y.  The sums across M
come from float32 partials that the wrappers sum in a fixed order.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _remat
from . import _build, _higher_order
from . import _fused_common as _fc

__all__ = ["conv3_bn_reference", "conv3_bn_dx_reference",
           "conv3_bn_dw_reference", "conv3_bn_bwd_reference",
           "fused_conv3_bn_fwd", "fused_conv3_bn_dx", "fused_conv3_bn_dw",
           "FusedConv3BNFunction", "fused_conv3_bn", "dw_mma_geometry",
           "dw_mma_split", "dw_tf32_split", "fwd_mma_tile", "fwd_mma_split",
           "dx_mma_tile", "dx_mma_split", "fwd_launches",
           "dx_launches", "dw_launches"]

#: Launches of the forward, dx and dw kernels so far; each wrapper adds
#: one per launch and nothing else touches them (a caller may reset them
#: to 0).
fwd_launches = 0
dx_launches = 0
dw_launches = 0

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# the C entries' arguments (csrc/fused_conv3_bn.cu)
_SHAPE = [_L, _I, _I, _I, _I]   # N, H, W, C, C_out
_DW_MMA_ARGS = [_P] * 3 + [_I] + [_P] * 5 + _SHAPE + [_L, _L, _I, _P]
_FWD_MMA_ARGS = [_P] * 4 + [_I] + [_P] * 3 + _SHAPE + [_L, _L, _I, _P]
_DX_MMA_ARGS = [_P] * 4 + [_I] + [_P] * 7 + _SHAPE + [_L, _L, _I, _P]

# kernel 16's tiles (fused_conv3_bn_dw_mma, and fused_conv3_bn_dw_tf32 on
# the same walk): 64 x 64 of (c, o) for each of the three kernel rows,
# over stages of at most 64 positions.  Enough runs of stages that about
# _MMA_BLOCKS_PER_SM blocks cover each SM (one wave at the tile's
# occupancy), none shorter than _MMA_MIN_RUN_PIXELS: a block's float32
# partial (3 x 64 x 64, 48 KiB), written and read back, then costs at
# most an eighth of what the block reads (64 + 2 * 64 bf16 values a
# pixel: 384 bytes).
_MMA_TILE, _MMA_POS = 64, 64
_MMA_BLOCKS_PER_SM = 2
_MMA_MIN_RUN_PIXELS = 8 * 2 * (3 * _MMA_TILE * _MMA_TILE * 4) // (
    3 * _MMA_TILE * 2)
# the 3xTF32 tile (two blocks an SM too) reads float32 pixels: the same
# eighth is half as many pixels
_TF32_BLOCKS_PER_SM = 2
_TF32_MIN_RUN_PIXELS = _MMA_MIN_RUN_PIXELS // 2
# kernels 13's and 14's tiles (fused_conv3_bn_fwd_mma and _dx_mma in
# bfloat16, fused_conv3_bn_fwd_tf32 and _dx_tf32 in float32) walk the
# pixels as kernel 16's does; their runs of stages are enough that about
# _FWD_BLOCKS_PER_SM blocks cover each SM (one wave at their occupancy,
# two blocks an SM for every one of them)
_FWD_BLOCKS_PER_SM = 2


_TAPS = [(dh, dw) for dh in (-1, 0, 1) for dw in (-1, 0, 1)]


def _taps(a, sgn=1):
    """The nine tap views of ``a`` (N, H, W, C) as (N*H*W, C) matrices:
    tap (dh, dw) holds a at (h + sgn*dh, w + sgn*dw), zero where that
    lies outside the image (the zero padding of ``a`` itself)."""
    n, h, w, c = a.shape
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    for t, (dh, dw) in enumerate(_TAPS):
        dh, dw = sgn * dh, sgn * dw
        yield t, ap[:, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w].reshape(-1, c)


def conv3_bn_reference(x, w, scale=None, bias=None):
    """Plain PyTorch forward, counterpart of the JAX package's
    ``xla_conv3_bn`` → ``(y, s1, s2)``.

    x (N, H, W, C); w (3, 3, C, C_out) HWIO; with ``scale`` and ``bias``
    (per-C) the input is relu(x*scale + bias) in float32, rounded to x's
    dtype.  The convolution is the kernel's nine shifted products, taken
    in float32 on the operands rounded to x's dtype; y comes out in x's
    dtype and s1, s2 are float32 ``(C_out,)`` sums of the rounded y."""
    n, h, wd, _ = x.shape
    wt = _fc.acc(w).reshape(9, w.shape[2], w.shape[3])
    y = sum(tap @ wt[t] for t, tap in _taps(_fc.prologue(x, scale, bias)))
    y = y.to(x.dtype)
    yf = _fc.acc(y)
    return (y.reshape(n, h, wd, -1), yf.sum(dim=0), (yf * yf).sum(dim=0))


def conv3_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """Plain dx with the kernel's formulas → ``(dx, dscale, dbias)``:
    the nine-tap transposed convolution of the rounded dyt, then, with a
    prologue, the ReLU / normalize backward.  dscale and dbias are
    float32 ``(C,)``, zeros without a prologue."""
    wt = _fc.acc(w).reshape(9, w.shape[2], w.shape[3])
    dxn = sum(tap @ wt[t].t()
              for t, tap in _taps(_fc.dyt(y, dy, ds1, ds2), sgn=-1))
    dxn = dxn.reshape(x.shape)
    if scale is None:
        zeros = torch.zeros(x.shape[-1], dtype=torch.float32,
                            device=x.device)
        return dxn.to(x.dtype), zeros, zeros.clone()
    xf, sc = _fc.acc(x), _fc.acc(scale)
    dz = torch.where(xf * sc + _fc.acc(bias) > 0, dxn, torch.zeros_like(dxn))
    return ((dz * sc).to(x.dtype), (dz * xf).sum(dim=(0, 1, 2)),
            dz.sum(dim=(0, 1, 2)))


def conv3_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """Plain dw with the kernel's formulas: per tap, the shifted
    prologue (recomputed) against dyt, summed over N*H*W in float32;
    (3, 3, C, C_out) in w's dtype."""
    d = _fc.dyt(y, dy, ds1, ds2).reshape(-1, dy.shape[-1])
    dw = torch.stack([tap.t() @ d for _, tap in
                      _taps(_fc.prologue(x, scale, bias))])
    return dw.reshape(w.shape).to(w.dtype)


def conv3_bn_bwd_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """The plain VJP of :func:`conv3_bn_reference` for the cotangents
    ``(dy, ds1, ds2)`` → ``(dx, dw, dscale, dbias)``."""
    dx, dsc, dbi = conv3_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2)
    dw = conv3_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    return dx, dw, dsc, dbi


def dw_mma_geometry(w):
    """``(seg_w, stage_segs, row_segs)`` of kernel 16's bfloat16 tile
    for an image width ``w`` (``tc_geometry`` in the source): the pixels
    are walked in segments of image rows, at most 62 pixels each, and a
    stage holds as many segments as fit in 64 positions, a segment taking
    its pixels and one halo position on either side."""
    seg_w = min(w, _MMA_POS - 2)
    return seg_w, _MMA_POS // (seg_w + 2), -(-w // seg_w)


def _dw_runs(n, h, w, c, co, sms, blocks_per_sm, min_pixels):
    """``(run_stages, runs)``: runs of whole stages of
    :func:`dw_mma_geometry`'s walk that tile the stages exactly (the last
    run may be shorter), enough that about ``blocks_per_sm`` blocks cover
    every SM, none of fewer than ``min_pixels`` pixels where the image
    holds that many."""
    seg_w, stage_segs, row_segs = dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    tiles = 3 * -(-c // _MMA_TILE) * -(-co // _MMA_TILE)
    want = max(1, -(-blocks_per_sm * sms // tiles))
    least = -(-min_pixels // (stage_segs * seg_w))
    run_stages = min(max(-(-stages // want), least), stages)
    return run_stages, -(-stages // run_stages)


def dw_mma_split(n, h, w, c, co, sms):
    """``(run_stages, runs)`` of kernel 16's bfloat16 tile for x (n, h,
    w, c) and dw (3, 3, c, co) on a card of ``sms`` SMs: runs of whole
    stages that tile the stages exactly (the last run may be shorter).
    Enough runs that about ``_MMA_BLOCKS_PER_SM`` blocks cover every SM,
    none of fewer than ``_MMA_MIN_RUN_PIXELS`` pixels where the image
    holds that many."""
    return _dw_runs(n, h, w, c, co, sms, _MMA_BLOCKS_PER_SM,
                    _MMA_MIN_RUN_PIXELS)


@functools.lru_cache(maxsize=None)
def dw_tf32_split(n, h, w, c, co, sms):
    """``(run_stages, runs)`` of kernel 16's float32 3xTF32 tile, on the
    bfloat16 tile's walk: runs of whole stages that tile the stages
    exactly (the last run may be shorter), at most 65535 of them, none
    of fewer than ``_TF32_MIN_RUN_PIXELS`` pixels where the image holds
    that many.  The run length r minimises waves x r, the time of the
    slowest SM when each of the runs x (channel tiles) blocks takes a
    slot of ``_TF32_BLOCKS_PER_SM`` an SM, the longer run where two tie
    (of the rules ``scripts/torch_f32_dw_splits.py`` compares, the one
    under which phase 7's 16 launches took least time on an H100)."""
    seg_w, stage_segs, row_segs = dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    tiles = 3 * -(-c // _MMA_TILE) * -(-co // _MMA_TILE)
    slots = _TF32_BLOCKS_PER_SM * sms
    least = max(min(stages,
                    -(-_TF32_MIN_RUN_PIXELS // (stage_segs * seg_w))),
                -(-stages // 65535))
    best = None
    for runs in range(1, stages + 1):   # the longest run for each count
        r = -(-stages // runs)
        if r < least:
            break
        cost = -(-tiles * -(-stages // r) // slots) * r
        if best is None or cost < best[0]:
            best = (cost, r)
    return best[1], -(-stages // best[1])


def fwd_mma_tile(c, co, dtype):
    """``(bn, kc)`` of kernel 13's tile for ``dtype``, as
    ``mx_fused_conv3_bn_fwd_mma`` and ``mx_fused_conv3_bn_fwd_tf32``
    pick it: ``bn`` output channels a block and ``kc`` input channels a
    step.  bfloat16: ``bn`` 64, or 128 where ``co`` > 64; ``kc`` 64
    where ``c`` <= 64 (the block's whole W slice then staying in shared
    memory for its run), else 32 (W streaming with x).  float32 (the
    3xTF32 tile): 64 and 32 at every C and C_out, W always streaming."""
    if dtype == torch.float32:
        return 64, 32
    return (64 if co <= 64 else 128), (64 if c <= 64 else 32)


def _stage_runs(n, h, w, tiles, sms):
    """``(run_stages, runs)``: runs of whole stages of
    :func:`dw_mma_geometry`'s walk that tile the stages exactly (the last
    run may be shorter), enough that about ``_FWD_BLOCKS_PER_SM`` blocks
    of ``tiles`` channel tiles cover every SM."""
    _, stage_segs, row_segs = dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    want = max(1, -(-_FWD_BLOCKS_PER_SM * sms // tiles))
    run_stages = -(-stages // want)
    return run_stages, -(-stages // run_stages)


def fwd_mma_split(n, h, w, c, co, sms, dtype):
    """``(run_stages, runs)`` of kernel 13's tile for ``dtype``, x (n, h,
    w, c) and C_out = co on a card of ``sms`` SMs (:func:`_stage_runs`
    over the tiles of ``fwd_mma_tile``'s output channels)."""
    return _stage_runs(n, h, w, -(-co // fwd_mma_tile(c, co, dtype)[0]),
                       sms)


def dx_mma_tile(c, co, dtype):
    """``(bn, kc)`` of kernel 14's tile for ``dtype``, as
    ``mx_fused_conv3_bn_dx_mma`` and ``mx_fused_conv3_bn_dx_tf32`` pick
    it: ``bn`` input channels of dx a block and ``kc`` output channels a
    step.  bfloat16: ``bn`` 64, or 128 where ``c`` > 64; ``kc`` 64 where
    ``c`` and ``co`` <= 64 (the block's whole W slice then staying in
    shared memory for its run), else 32 (W streaming with dy).  float32
    (the 3xTF32 tile): 64 and 32 at every C, W always streaming."""
    if dtype == torch.float32:
        return 64, 32
    return (64 if c <= 64 else 128), (64 if max(c, co) <= 64 else 32)


def dx_mma_split(n, h, w, c, co, sms, dtype):
    """``(run_stages, runs)`` of kernel 14's tile for ``dtype``, x (n, h,
    w, c) and C_out = co on a card of ``sms`` SMs (:func:`_stage_runs`
    over the tiles of ``dx_mma_tile``'s input channels)."""
    return _stage_runs(n, h, w, -(-c // dx_mma_tile(c, co, dtype)[0]), sms)


def _check(name, x, w, scale, bias, **more):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _fc.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if (x.dim() != 4 or w.dim() != 4
            or tuple(w.shape[:3]) != (3, 3, x.shape[3])):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (N, H, W, C) and (3, 3, C, C_out)")
    n, h, wd, c = x.shape
    co = w.shape[3]
    if min(h, wd, c, co) == 0:
        raise ValueError(f"{name}: H, W, C and C_out must be positive, got "
                         f"{h}, {wd}, {c}, {co}")
    if (scale is None) != (bias is None):
        raise ValueError(f"{name}: give both scale and bias, or neither")
    want = {"w": ((3, 3, c, co), x.dtype)}
    if scale is not None:
        want.update(scale=((c,), None), bias=((c,), None))
    for vname in more:
        want[vname] = (((n, h, wd, co), x.dtype) if vname in ("y", "dy")
                       else ((co,), None))
    tensors = dict(w=w, scale=scale, bias=bias, **more)
    for vname, (shape, dtype) in want.items():
        t = tensors[vname]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {vname} shape {tuple(t.shape)} != "
                             f"{shape}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {vname} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {vname} on {t.device}, x on "
                             f"{x.device}")
    return n, h, wd, c, co


def _count(which):
    global fwd_launches, dx_launches, dw_launches
    with _fc.count_lock:
        if which == "fwd":
            fwd_launches += 1
        elif which == "dx":
            dx_launches += 1
        else:
            dw_launches += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fused_conv3_bn_fwd(x, w, scale=None, bias=None):
    """``y = conv3x3([relu(x*scale + bias)], w)`` with its per-channel
    sums → ``(y, s1, s2)``.

    x (N, H, W, C) and w (3, 3, C, C_out) in one dtype, float32 or
    bfloat16; scale and bias ``(C,)`` (cast to float32), both or neither.
    On a CUDA tensor: kernel 13 on the current stream over the runs of
    :func:`fwd_mma_split`, then the sum of its float32 partial rows of
    the sums (one a run) in a fixed order: bfloat16 runs the bf16
    tensor-core tile, float32 the 3xTF32 tile.  On a CPU tensor: the
    plain version."""
    if x.device.type == "cpu":
        return conv3_bn_reference(x, w, scale, bias)
    n, h, wd, c, co = _check("fused_conv3_bn_fwd", x, w, scale, bias)
    x, w = x.contiguous(), w.contiguous()
    scale, bias = _fc.f32(scale), _fc.f32(bias)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    if n * h * wd == 0:
        zeros = torch.zeros(co, dtype=torch.float32, device=x.device)
        return y, zeros, zeros.clone()
    run_stages, runs = fwd_mma_split(n, h, wd, c, co, _fc.sms(x.device.index),
                                     x.dtype)
    parts = torch.empty((2, runs, co), dtype=torch.float32, device=x.device)
    vec = (int(_fc.vec16(x)) | 2 * int(_fc.vec16(w))
           | 4 * int(_fc.vec16(y)))
    entry = ("mx_fused_conv3_bn_fwd_mma" if x.dtype == torch.bfloat16
             else "mx_fused_conv3_bn_fwd_tf32")
    with torch.cuda.device(x.device):
        fn = _build.launcher("fused_conv3_bn", entry, _FWD_MMA_ARGS)
        fn(x.data_ptr(), w.data_ptr(), _fc.ptr(scale), _fc.ptr(bias),
           int(scale is not None), y.data_ptr(), parts[0].data_ptr(),
           parts[1].data_ptr(), n, h, wd, c, co, run_stages, runs, vec,
           _stream(x.device))
    _count("fwd")
    sums = parts.sum(dim=1)
    return y, sums[0], sums[1]


def _bwd_operands(name, x, w, scale, bias, y, dy, ds1, ds2):
    shape = _check(name, x, w, scale, bias, y=y, dy=dy, ds1=ds1, ds2=ds2)
    return shape + (x.contiguous(), w.contiguous(), _fc.f32(scale),
                    _fc.f32(bias), y.contiguous(), dy.contiguous(),
                    _fc.f32(ds1), _fc.f32(ds2))


def fused_conv3_bn_dx(x, w, scale, bias, y, dy, ds1, ds2):
    """dx of :func:`fused_conv3_bn_fwd` for the cotangents ``(dy, ds1,
    ds2)`` of ``(y, s1, s2)`` → ``(dx, dscale, dbias)``.

    dx comes out in x's dtype; dscale and dbias are float32 ``(C,)``,
    zeros without a prologue (scale None), as the JAX package returns
    them.  On a CUDA tensor: the dx kernel, then the sum of its float32
    partial rows (a row for each run of stages) in a fixed order, over
    the runs of :func:`dx_mma_split`: bfloat16 runs the bf16
    tensor-core tile, float32 the 3xTF32 tile.  On a CPU tensor: the
    plain version."""
    if x.device.type == "cpu":
        return conv3_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2)
    n, h, wd, c, co, x, w, scale, bias, y, dy, ds1, ds2 = _bwd_operands(
        "fused_conv3_bn_dx", x, w, scale, bias, y, dy, ds1, ds2)
    prologue = scale is not None
    dx = torch.empty_like(x)
    m = n * h * wd
    if m == 0 or not prologue:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        if m == 0:
            return dx, zeros, zeros.clone()
    bf16 = x.dtype == torch.bfloat16
    run_stages, runs = dx_mma_split(n, h, wd, c, co, _fc.sms(x.device.index),
                                    x.dtype)
    parts = (torch.empty((2, runs, c), dtype=torch.float32, device=x.device)
             if prologue else None)
    vec = (int(_fc.vec16(x)) | 2 * int(_fc.vec16(y, dy))
           | 4 * int(_fc.vec16(w)))
    entry = "mx_fused_conv3_bn_dx_mma" if bf16 else "mx_fused_conv3_bn_dx_tf32"
    with torch.cuda.device(x.device):
        fn = _build.launcher("fused_conv3_bn", entry, _DX_MMA_ARGS)
        fn(x.data_ptr(), w.data_ptr(), _fc.ptr(scale), _fc.ptr(bias),
           int(prologue), y.data_ptr(), dy.data_ptr(), ds1.data_ptr(),
           ds2.data_ptr(), dx.data_ptr(),
           parts[0].data_ptr() if prologue else None,
           parts[1].data_ptr() if prologue else None, n, h, wd, c, co,
           run_stages, runs, vec, _stream(x.device))
    _count("dx")
    if not prologue:
        return dx, zeros, zeros.clone()
    sums = parts.sum(dim=1)
    return dx, sums[0], sums[1]


def fused_conv3_bn_dw(x, w, scale, bias, y, dy, ds1, ds2):
    """dw of :func:`fused_conv3_bn_fwd` for the cotangents ``(dy, ds1,
    ds2)`` → dw ``(3, 3, C, C_out)`` in w's dtype, summed over N*H*W in
    float32.

    On a CUDA tensor: kernel 16 over runs of stages, each writing a
    float32 partial of the whole gradient, then their sum in a fixed
    order; bfloat16 runs the bf16 tensor-core tile over the runs of
    :func:`dw_mma_split`, float32 the 3xTF32 tile over those of
    :func:`dw_tf32_split`.  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return conv3_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    n, h, wd, c, co, x, w, scale, bias, y, dy, ds1, ds2 = _bwd_operands(
        "fused_conv3_bn_dw", x, w, scale, bias, y, dy, ds1, ds2)
    if n * h * wd == 0:
        return torch.zeros((3, 3, c, co), dtype=w.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    split = dw_mma_split if bf16 else dw_tf32_split
    run_stages, runs = split(n, h, wd, c, co, _fc.sms(x.device.index))
    parts = torch.empty((runs, 3, 3, c, co), dtype=torch.float32,
                        device=x.device)
    vec = int(_fc.vec16(x)) | 2 * int(_fc.vec16(y, dy))
    entry = "mx_fused_conv3_bn_dw_mma" if bf16 else "mx_fused_conv3_bn_dw_tf32"
    with torch.cuda.device(x.device):
        fn = _build.launcher("fused_conv3_bn", entry, _DW_MMA_ARGS)
        fn(x.data_ptr(), _fc.ptr(scale), _fc.ptr(bias),
           int(scale is not None), y.data_ptr(), dy.data_ptr(),
           ds1.data_ptr(), ds2.data_ptr(), parts.data_ptr(), n, h, wd, c, co,
           run_stages, runs, vec, _stream(x.device))
    _count("dw")
    return parts.sum(dim=0).to(w.dtype)


class FusedConv3BNFunction(torch.autograd.Function):
    """``apply(x, w, scale, bias)`` → ``(y, s1, s2)``, with its own
    backward: the counterpart of the JAX package's ``_fc3`` custom VJP.
    scale and bias are both None (no prologue) or both ``(C,)``.  The
    forward saves x, w, scale, bias and y, as ``_fc3_fwd`` does; the
    backward takes ``(dy, ds1, ds2)``, reads a None as zeros, runs
    :func:`fused_conv3_bn_dx` and :func:`fused_conv3_bn_dw`, and returns
    gradients for scale and bias only with a prologue.  Under
    ``create_graph`` the backward is differentiable on the CPU (y
    recomputed from the inputs, so that it carries the graph) and
    refuses a second derivative on the card (``_higher_order.py``)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        # under remat="dots" the recompute takes the first run's product
        y, s1, s2 = (t.detach() for t in _remat.keep(
            "product", lambda: fused_conv3_bn_fwd(x, w, scale, bias)))
        ctx.save_for_backward(x, w, scale, bias, y)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, scale, bias, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        zeros = functools.partial(torch.zeros, w.shape[-1],
                                  dtype=_fc.acc(y).dtype, device=y.device)
        ds1 = zeros() if ds1 is None else ds1
        ds2 = zeros() if ds2 is None else ds2
        dy = dy.to(y.dtype)
        if torch.is_grad_enabled() and x.device.type == "cpu":
            y = conv3_bn_reference(x, w, scale, bias)[0]
        dx, dsc, dbi = fused_conv3_bn_dx(x, w, scale, bias, y, dy, ds1, ds2)
        dw = fused_conv3_bn_dw(x, w, scale, bias, y, dy, ds1, ds2)
        grads = (dx, dw, None, None) if scale is None else (dx, dw, dsc, dbi)
        if torch.is_grad_enabled() and x.device.type != "cpu":
            grads = _higher_order.guard("fused_conv3_bn_bwd", grads,
                                        (x, w, scale, bias, dy, ds1, ds2))
        return grads


def fused_conv3_bn(x, w, scale=None, bias=None):
    """3x3 / stride 1 / pad 1 NHWC convolution with the BatchNorm
    statistics of its output and an optional normalize + ReLU prologue →
    ``(y, s1, s2)``, differentiable in every input.

    x (N, H, W, C) activations; w (3, 3, C, C_out) HWIO; scale and bias
    optional per-C normalize constants (cast to float32), applied as
    relu(x*scale + bias) and never stored.  y is (N, H, W, C_out) in x's
    dtype; ``s1 = sum(y)`` and ``s2 = sum(y²)`` are float32 per output
    channel over N*H*W (one-pass BN: mean = s1 / M, var = s2 / M -
    mean²)."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"fused_conv3_bn needs a 3x3 HWIO kernel, got "
                         f"{tuple(w.shape)}")
    if scale is not None:
        scale, bias = _fc.acc(scale), _fc.acc(bias)
    return FusedConv3BNFunction.apply(x, w, scale, bias)
