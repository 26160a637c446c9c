"""Fused 1x1-conv (matrix product) + BatchNorm for bottleneck ResNets: the
CUDA kernels, their plain PyTorch versions, the autograd Function that
joins them, and the fused bottleneck built on it.

Counterpart of ``incubator_mxnet_tpu/ops/fused_block.py``.  A 1x1
convolution over NHWC is a matrix product over the flattened N*H*W
rows, x (M, K) @ w (K, N).  :func:`fused_matmul_bn` computes

    y = [relu(x*scale + bias)] @ w,  s1 = sum_M y,  s2 = sum_M y^2

so a BatchNorm's batch statistics come out of the product's epilogue
and the previous BatchNorm's normalize + ReLU runs in its prologue; the
normalized activation is never stored.  Its backward keeps the same
property: the dx product recomputes the prologue and carries the ReLU /
normalize backward and the dscale, dbias sums as its epilogue; the dw
product recomputes the prologue too.

Three kernels (``csrc/fused_matmul_bn.cu``), one wrapper each:
:func:`fused_matmul_bn_fwd` (kernel 10), :func:`fused_matmul_bn_dx`
(11) and :func:`fused_matmul_bn_dw` (12), each with a launch counter.
Each has one instance for each dtype.  bfloat16 runs tiles on the
tensor cores (``fused_matmul_bn_fwd_mma``, over runs of M that
:func:`fwd_mma_split` chooses; ``fused_matmul_bn_dx_mma``;
``fused_matmul_bn_dw_mma``, over runs of M that :func:`dw_mma_split`
chooses).  float32's forward and dx run the FMA tile that the two
share, its dw a tile on the tensor cores that keeps float32 numbers in
three tf32 products (``fused_matmul_bn_dw_tf32``, over the runs of
:func:`dw_tf32_split`).
Each wrapper dispatches on where x lies: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Nothing falls
back from the card to the plain version.

Numerics, as the TPU kernels': operands in the input dtype (float32 or
bfloat16), float32 accumulation, the prologue and the stats-adjusted
cotangent dyt = dy + ds1 + 2*y*ds2 in float32 rounded to the input dtype
before the product, statistics from the *rounded* y.  The column sums
cross M: the kernels write float32 partial rows (dw: float32 partial
tiles over runs of M) and the wrappers sum them in a fixed order.

The bottleneck (:func:`fused_bottleneck_v1` and ``_proj``) runs its
3x3 convolution through ``fused_conv.fused_conv3_bn``, the fused 3x3
kernels with bn1's normalize + ReLU as their prologue: the JAX
package's default configuration (``MXNET_FUSED_CONV3`` unset), with no
switch and no geometry gate.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import _fused_common as _fc
from ._fused_common import vec16 as _vec16
from .fused_conv import fused_conv3_bn

__all__ = ["matmul_bn_reference", "matmul_bn_dx_reference",
           "matmul_bn_dw_reference", "matmul_bn_bwd_reference",
           "fused_matmul_bn_fwd", "fused_matmul_bn_dx", "fused_matmul_bn_dw",
           "FusedMatmulBNFunction", "fused_matmul_bn", "bn_consts",
           "fused_bottleneck_v1", "fused_bottleneck_v1_proj",
           "dw_mma_split", "dw_tf32_split", "fwd_mma_split", "fwd_launches",
           "dx_launches", "dw_launches"]

#: Launches of kernels 10, 11 and 12 so far; each wrapper adds one per
#: launch and nothing else touches them (a caller may reset them to 0).
fwd_launches = 0
dx_launches = 0
dw_launches = 0

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# the C entries' arguments (csrc/fused_matmul_bn.cu)
_FWD_ARGS = [_I] + [_P] * 4 + [_I] + [_P] * 3 + [_L, _L, _I, _I, _L, _I,
                                                 _P]
_DX_ARGS = [_I] + [_P] * 4 + [_I] + [_P] * 7 + [_L, _L, _I, _I, _I, _P]
_DW_ARGS = [_I] + [_P] * 4 + [_I] + [_P] * 5 + [_L, _I, _I, _L, _L, _I, _P]

# kernel 12's tensor-core tiles (fused_matmul_bn_dw_mma, bfloat16;
# fused_matmul_bn_dw_tf32, float32): 64 rows of dw, over stages of 32 (16)
# rows of M, and runs of M that are a multiple of _MMA_BM rows
_MMA_BK, _MMA_BM = 64, 32
# enough runs of M that about this many blocks cover each SM: one wave at
# the bfloat16 tile's occupancy; two at the 3xTF32 tile's (three blocks
# an SM)
_MMA_BLOCKS_PER_SM, _TF32_BLOCKS_PER_SM = 4, 6


def _dw_runs(m, k, n, sms, blocks_per_sm, min_rows):
    """``(split_rows, splits)``: runs of M, each a multiple of _MMA_BM
    rows, that tile M exactly (the last may be shorter), enough that
    about ``blocks_per_sm`` blocks of the (64, 128) tile (64 wide where n
    <= 64) cover every SM, none shorter than ``min_rows``."""
    bn = 64 if n <= 64 else 128
    tiles = -(-k // _MMA_BK) * -(-n // bn)
    want = max(1, -(-blocks_per_sm * sms // tiles))
    rows = max(-(-m // want), min_rows, 1)
    rows = -(-rows // _MMA_BM) * _MMA_BM
    return rows, -(-m // rows)


def dw_mma_split(m, k, n, sms):
    """``(split_rows, splits)`` of kernel 12's bfloat16 tile for x (m, k)
    and dw (k, n) on a card of ``sms`` SMs: runs of M, each a multiple
    of the 32-row stage, that tile M exactly (the last may be shorter).
    Enough runs that about ``_MMA_BLOCKS_PER_SM`` blocks of the (64,
    128) tile (64 wide where n <= 64) cover every SM, but no run so
    short that its float32 (k, n) partial, written and read back, costs
    more than an eighth of the bytes the run reads (2 (k + 2n) a row)."""
    return _dw_runs(m, k, n, sms, _MMA_BLOCKS_PER_SM,
                    32 * k * n // (k + 2 * n))


def dw_tf32_split(m, k, n, sms):
    """``(split_rows, splits)`` of kernel 12's float32 3xTF32 tile, as
    :func:`dw_mma_split`'s (runs a multiple of 32 rows, so of its 16-row
    stage) but about ``_TF32_BLOCKS_PER_SM`` blocks an SM, and no run so
    short that its float32 (k, n) partial, written and read back, costs
    more than a quarter of the bytes the run reads (4 (k + 2n) a row):
    of the rules ``scripts/torch_f32_dw_splits.py`` compares, the one
    under which phase 7's 36 launches took least time on an H100."""
    return _dw_runs(m, k, n, sms, _TF32_BLOCKS_PER_SM,
                    8 * k * n // (k + 2 * n))


# kernel 10's bfloat16 tile (fused_matmul_bn_fwd_mma): row blocks of 128
# rows of M; runs of row blocks are chosen so that the blocks fill the
# card's slots (_FWD_BLOCKS_PER_SM an SM) in as few waves as possible,
# runs of at most _FWD_MAX_RUN row blocks searched
_FWD_ROWS, _FWD_BLOCKS_PER_SM, _FWD_MAX_RUN = 128, 2, 64


@functools.lru_cache(maxsize=None)
def fwd_mma_split(m, k, n, sms):
    """``(run_rows, runs)`` of kernel 10's bfloat16 tile for x (m, k) and
    y (m, n) on a card of ``sms`` SMs: runs of whole 128-row blocks that
    tile M exactly (the last may be shorter), at most 65535 of them.
    The run length r minimises waves x r, the time of the slowest SM
    when each of the ``runs`` x (column tiles) blocks takes a slot of
    ``_FWD_BLOCKS_PER_SM`` an SM, the longer run where two tie: longer
    runs load a resident w (k <= 64) less often and leave fewer partial
    rows."""
    blocks = -(-m // _FWD_ROWS)
    tiles = -(-n // (64 if n <= 64 else 128))
    slots = _FWD_BLOCKS_PER_SM * sms
    least = max(1, -(-blocks // 65535))
    best = (None, least)
    for r in range(least, max(least, min(blocks, _FWD_MAX_RUN)) + 1):
        cost = -(-(-(-blocks // r) * tiles) // slots) * r
        if best[0] is None or cost <= best[0]:
            best = (cost, r)
    r = best[1]
    return r * _FWD_ROWS, -(-blocks // r)


def matmul_bn_reference(x, w, scale=None, bias=None):
    """Plain PyTorch forward, counterpart of the JAX package's
    ``xla_matmul_bn`` → ``(y, s1, s2)``: y in x's dtype, s1 and s2
    float32 ``(N,)``.  The product is taken in float32 on the operands
    rounded to x's dtype, as the kernel takes it."""
    y = (_fc.prologue(x, scale, bias) @ _fc.acc(w)).to(x.dtype)
    yf = _fc.acc(y)
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def matmul_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """Plain dx with the kernel's formulas → ``(dx, dscale, dbias)``; the
    last two are float32 ``(K,)``, or None without a prologue."""
    dxn = _fc.dyt(y, dy, ds1, ds2) @ _fc.acc(w).t()
    if scale is None:
        return dxn.to(x.dtype), None, None
    xf, sc = _fc.acc(x), _fc.acc(scale)
    dz = torch.where(xf * sc + _fc.acc(bias) > 0, dxn, torch.zeros_like(dxn))
    return (dz * sc).to(x.dtype), (dz * xf).sum(dim=0), dz.sum(dim=0)


def matmul_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """Plain dw with the kernel's formulas: the prologue recomputed,
    summed over M in float32, cast to w's dtype."""
    xn = _fc.prologue(x, scale, bias)
    return (xn.t() @ _fc.dyt(y, dy, ds1, ds2)).to(w.dtype)


def matmul_bn_bwd_reference(x, w, scale, bias, y, dy, ds1, ds2):
    """The plain VJP of :func:`matmul_bn_reference` for the cotangents
    ``(dy, ds1, ds2)`` → ``(dx, dw, dscale, dbias)``."""
    dx, dsc, dbi = matmul_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2)
    dw = matmul_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    return dx, dw, dsc, dbi


def _check(name, x, w, scale, bias, **more):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _fc.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (M, K) and (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if k == 0 or n == 0:
        raise ValueError(f"{name}: K and N must be positive, got {k}, {n}")
    if (scale is None) != (bias is None):
        raise ValueError(f"{name}: give both scale and bias, or neither")
    want = {"w": ((k, n), x.dtype)}
    if scale is not None:
        want.update(scale=((k,), None), bias=((k,), None))
    for vname in more:
        want[vname] = (((m, n), x.dtype) if vname in ("y", "dy")
                       else ((n,), None))
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
    return m, k, n


def _count(which):
    global fwd_launches, dx_launches, dw_launches
    with _fc.count_lock:
        if which == "fwd":
            fwd_launches += 1
        elif which == "dx":
            dx_launches += 1
        else:
            dw_launches += 1


def fused_matmul_bn_fwd(x, w, scale=None, bias=None):
    """``y = [relu(x*scale + bias)] @ w`` with its column sums →
    ``(y, s1, s2)``.

    x (M, K) and w (K, N) in one dtype, float32 or bfloat16; scale and
    bias ``(K,)`` (cast to float32), both or neither.  On a CUDA tensor:
    kernel 10 on the current stream, then the sum of its float32 partial
    rows in a fixed order: bfloat16 runs the tensor-core tile (a row for
    each run of :func:`fwd_mma_split`), float32 the FMA tile (a row for
    each block of 128 rows of M).  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return matmul_bn_reference(x, w, scale, bias)
    m, k, n = _check("fused_matmul_bn_fwd", x, w, scale, bias)
    x, w = x.contiguous(), w.contiguous()
    scale, bias = _fc.f32(scale), _fc.f32(bias)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
        return y, zeros, zeros.clone()
    if x.dtype == torch.bfloat16:
        run_rows, rows = fwd_mma_split(m, k, n, _fc.sms(x.device.index))
        vec = int(_vec16(x)) | 2 * int(_vec16(w)) | 4 * int(_vec16(y))
    else:
        run_rows, rows, vec = _fc.BLOCK_ROWS, -(-m // _fc.BLOCK_ROWS), 0
    parts = torch.empty((2, rows, n), dtype=torch.float32, device=x.device)
    fn = _build.launcher("fused_matmul_bn", "mx_fused_matmul_bn_fwd",
                         _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_fc.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
           _fc.ptr(scale), _fc.ptr(bias), int(scale is not None),
           y.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), rows, m,
           k, n, run_rows, vec, stream)
    _count("fwd")
    sums = parts.sum(dim=1)
    return y, sums[0], sums[1]


def _bwd_operands(name, x, w, scale, bias, y, dy, ds1, ds2):
    m, k, n = _check(name, x, w, scale, bias, y=y, dy=dy, ds1=ds1, ds2=ds2)
    return (m, k, n, x.contiguous(), w.contiguous(), _fc.f32(scale),
            _fc.f32(bias), y.contiguous(), dy.contiguous(), _fc.f32(ds1),
            _fc.f32(ds2))


def fused_matmul_bn_dx(x, w, scale, bias, y, dy, ds1, ds2):
    """dx of :func:`fused_matmul_bn_fwd` for the cotangents ``(dy, ds1,
    ds2)`` of ``(y, s1, s2)`` → ``(dx, dscale, dbias)``.

    dx comes out in x's dtype; dscale and dbias are float32 ``(K,)``
    with a prologue (scale given), else None.  On a CUDA tensor: kernel
    11, then the sum of its partial rows (one a block of 128 rows of M)
    in a fixed order; bfloat16 runs the tensor-core tile, float32 the FMA
    tile.  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return matmul_bn_dx_reference(x, w, scale, bias, y, dy, ds1, ds2)
    m, k, n, x, w, scale, bias, y, dy, ds1, ds2 = _bwd_operands(
        "fused_matmul_bn_dx", x, w, scale, bias, y, dy, ds1, ds2)
    prologue = scale is not None
    dx = torch.empty((m, k), dtype=x.dtype, device=x.device)
    rows = -(-m // _fc.BLOCK_ROWS)
    parts = (torch.empty((2, rows, k), dtype=torch.float32, device=x.device)
             if prologue else None)
    if m == 0:
        zeros = torch.zeros(k, dtype=torch.float32, device=x.device)
        return (dx, zeros, zeros.clone()) if prologue else (dx, None, None)
    vec = 0
    if x.dtype == torch.bfloat16:
        vec = int(_vec16(x)) | 2 * int(_vec16(y, dy)) | 4 * int(_vec16(w))
    fn = _build.launcher("fused_matmul_bn", "mx_fused_matmul_bn_dx",
                         _DX_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_fc.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
           _fc.ptr(scale), _fc.ptr(bias), int(prologue), y.data_ptr(),
           dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(), dx.data_ptr(),
           parts[0].data_ptr() if prologue else None,
           parts[1].data_ptr() if prologue else None, rows, m, k, n, vec,
           stream)
    _count("dx")
    if not prologue:
        return dx, None, None
    sums = parts.sum(dim=1)
    return dx, sums[0], sums[1]


def fused_matmul_bn_dw(x, w, scale, bias, y, dy, ds1, ds2):
    """dw of :func:`fused_matmul_bn_fwd` for the cotangents ``(dy, ds1,
    ds2)`` → dw ``(K, N)`` in w's dtype, summed over M in float32.

    On a CUDA tensor: kernel 12 over runs of M, each writing a float32
    (K, N) partial, then their sum in a fixed order; bfloat16 runs the
    bf16 tensor-core tile over the runs of :func:`dw_mma_split`, float32
    the 3xTF32 tile over those of :func:`dw_tf32_split`.  On a CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return matmul_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    m, k, n, x, w, scale, bias, y, dy, ds1, ds2 = _bwd_operands(
        "fused_matmul_bn_dw", x, w, scale, bias, y, dy, ds1, ds2)
    if m == 0:
        return torch.zeros((k, n), dtype=w.dtype, device=x.device)
    split = dw_mma_split if x.dtype == torch.bfloat16 else dw_tf32_split
    split_rows, splits = split(m, k, n, _fc.sms(x.device.index))
    vec = int(_vec16(x)) | 2 * int(_vec16(y, dy))
    parts = torch.empty((splits, k, n), dtype=torch.float32, device=x.device)
    fn = _build.launcher("fused_matmul_bn", "mx_fused_matmul_bn_dw",
                         _DW_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_fc.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
           _fc.ptr(scale), _fc.ptr(bias), int(scale is not None),
           y.data_ptr(), dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
           parts.data_ptr(), m, k, n, split_rows, splits, vec, stream)
    _count("dw")
    return parts.sum(dim=0).to(w.dtype)


class FusedMatmulBNFunction(torch.autograd.Function):
    """``apply(x, w, scale, bias)`` → ``(y, s1, s2)``, with its own
    backward: the counterpart of the JAX package's ``_fmm`` custom VJP.
    scale and bias are both None (no prologue) or both ``(K,)``.  The
    forward saves x, w, scale, bias and y, as ``_fmm_fwd`` does; the
    backward takes ``(dy, ds1, ds2)``, reads a None as zeros, runs
    :func:`fused_matmul_bn_dx` and :func:`fused_matmul_bn_dw`, and
    returns gradients for scale and bias only with a prologue."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        y, s1, s2 = fused_matmul_bn_fwd(x, w, scale, bias)
        ctx.save_for_backward(x, w, scale, bias, y)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, scale, bias, y = ctx.saved_tensors
        n = w.shape[1]
        if dy is None:
            dy = torch.zeros_like(y)
        zeros = functools.partial(torch.zeros, n, dtype=_fc.acc(y).dtype,
                                  device=y.device)
        ds1 = zeros() if ds1 is None else ds1
        ds2 = zeros() if ds2 is None else ds2
        dy = dy.to(y.dtype)
        dx, dsc, dbi = fused_matmul_bn_dx(x, w, scale, bias, y, dy, ds1, ds2)
        dw = fused_matmul_bn_dw(x, w, scale, bias, y, dy, ds1, ds2)
        return dx, dw, dsc, dbi


def fused_matmul_bn(x, w, scale=None, bias=None):
    """``y = [relu(x*scale + bias)] @ w`` with BN batch statistics in the
    epilogue → ``(y, s1, s2)``, differentiable in every input.

    x (M, K) activations (rows = flattened N*H*W); w (K, N), a 1x1 conv
    kernel reshaped; scale and bias optional per-K normalize constants
    (cast to float32).  ``mean = s1 / M`` and ``var = s2 / M - mean²``
    (one-pass BN)."""
    if scale is not None:
        scale, bias = _fc.acc(scale), _fc.acc(bias)
    return FusedMatmulBNFunction.apply(x, w, scale, bias)


def bn_consts(s1, s2, m, gamma, beta, eps=1e-5):
    """Fold kernel statistics into per-channel normalize constants →
    ``(scale, bias, mean, var)``, all float32, with y_norm = y*scale +
    bias.  Differentiable: gradients flow back into s1 and s2, which the
    kernels' backward folds into dyt."""
    mean = s1 / float(m)
    var = torch.clamp(s2 / float(m) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = gamma.float() * rstd
    bias = beta.float() - mean * scale
    return scale, bias, mean, var


def _bottleneck_core(x, w1, g1, b1, w2, g2, b2, w3, g3, b3, wsc, gsc, bsc,
                     stride, eps):
    """Bottleneck-V1 body on the fused kernels (NHWC).

    Weights are the zoo's NHWC kernels (O, kh, kw, I).  The 1x1 convs are
    :func:`fused_matmul_bn` calls (statistics from the epilogue; bn2's
    normalize + ReLU in c3's prologue); the 3x3 is
    :func:`~.fused_conv.fused_conv3_bn`, with bn1's normalize + ReLU as
    its prologue.
    Returns the block output and every BN's batch mean and variance, for
    the layer to update its moving statistics."""
    n = x.shape[0]
    s = int(stride)
    xs = x[:, ::s, ::s, :] if s > 1 else x

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def mm(w4):  # (O, 1, 1, I) -> (I, O)
        return w4.reshape(w4.shape[0], -1).t()

    hs, ws = xs.shape[1], xs.shape[2]  # ::s keeps ceil(h / s) rows
    y1, a1, c1 = fused_matmul_bn(flat(xs), mm(w1))
    m1 = y1.shape[0]
    sc1, of1, mean1, var1 = bn_consts(a1, c1, m1, g1, b1, eps)
    cm = y1.shape[-1]

    y2, a2, c2 = fused_conv3_bn(y1.reshape(n, hs, ws, cm),
                                w2.permute(1, 2, 3, 0), sc1, of1)
    sc2, of2, mean2, var2 = bn_consts(a2, c2, m1, g2, b2, eps)

    y3, a3, c3 = fused_matmul_bn(flat(y2), mm(w3), sc2, of2)
    sc3, of3, mean3, var3 = bn_consts(a3, c3, y3.shape[0], g3, b3, eps)

    if wsc is not None:
        ysc, asc, csc = fused_matmul_bn(flat(xs), mm(wsc))
        sccs, ofcs, meansc, varsc = bn_consts(asc, csc, ysc.shape[0], gsc,
                                              bsc, eps)
        short = ysc * sccs.to(x.dtype) + ofcs.to(x.dtype)
    else:
        short = flat(xs)
    out = torch.relu(y3 * sc3.to(x.dtype) + of3.to(x.dtype) + short)
    out = out.reshape(n, hs, ws, y3.shape[-1])
    stats = (mean1, var1, mean2, var2, mean3, var3)
    if wsc is not None:
        stats = stats + (meansc, varsc)
    return (out,) + stats


def _blend(momentum, old, new):
    return momentum * old + (1.0 - momentum) * new.to(old.dtype)


def fused_bottleneck_v1(x, w1, g1, b1, rm1, rv1, w2, g2, b2, rm2, rv2,
                        w3, g3, b3, rm3, rv3, stride=1, eps=1e-5,
                        momentum=0.9):
    """Identity-shortcut fused bottleneck (see :func:`_bottleneck_core`)
    → ``(out, new_rm1, new_rv1, new_rm2, new_rv2, new_rm3, new_rv3)``:
    the batch statistics blended into the moving ones, as the BatchNorm
    op returns them; the layer writes them back."""
    out, m1, v1, m2, v2, m3, v3 = _bottleneck_core(
        x, w1, g1, b1, w2, g2, b2, w3, g3, b3, None, None, None, stride, eps)
    b = functools.partial(_blend, momentum)
    return (out, b(rm1, m1), b(rv1, v1), b(rm2, m2), b(rv2, v2),
            b(rm3, m3), b(rv3, v3))


def fused_bottleneck_v1_proj(x, w1, g1, b1, rm1, rv1, w2, g2, b2, rm2, rv2,
                             w3, g3, b3, rm3, rv3, wsc, gsc, bsc, rmsc, rvsc,
                             stride=1, eps=1e-5, momentum=0.9):
    """Projection-shortcut fused bottleneck; as
    :func:`fused_bottleneck_v1`, plus the shortcut BN's moving
    statistics."""
    out, m1, v1, m2, v2, m3, v3, msc, vsc = _bottleneck_core(
        x, w1, g1, b1, w2, g2, b2, w3, g3, b3, wsc, gsc, bsc, stride, eps)
    b = functools.partial(_blend, momentum)
    return (out, b(rm1, m1), b(rv1, v1), b(rm2, m2), b(rv2, v2),
            b(rm3, m3), b(rv3, v3), b(rmsc, msc), b(rvsc, vsc))
