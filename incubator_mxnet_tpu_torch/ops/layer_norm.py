"""LayerNorm over the last axis: the CUDA kernels, their plain PyTorch
versions, and the autograd Function that joins them.

Counterpart of ``fused_layer_norm`` in
``incubator_mxnet_tpu/ops/pallas_kernels.py``: :func:`layer_norm_fwd`
ports ``_ln_fwd`` and :func:`layer_norm_bwd` ports ``_fused_ln_bwd``;
:class:`LayerNormFunction` is the custom VJP that pairs them.  Each
wrapper dispatches on where ``x`` lies: a CPU tensor takes the plain
version; a CUDA tensor launches ``csrc/layer_norm.cu`` or raises.
Nothing falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._fused_common import sms as _sms

__all__ = ["layer_norm_fwd", "layer_norm_fwd_reference", "layer_norm_bwd",
           "layer_norm_bwd_reference", "bwd_plan", "LayerNormFunction",
           "launches", "bwd_launches"]

#: Launches of the forward and the backward kernel so far; each wrapper
#: adds one per launch and nothing else touches them (a caller may reset
#: them to 0).
launches = 0
bwd_launches = 0

_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
# the C entries' arguments (csrc/layer_norm.cu)
_FWD_ARGS = [_I, _I] + [_P] * 6 + [ctypes.c_longlong, _I, ctypes.c_float, _P]
_BWD_ARGS = [_I, _I] + [_P] * 8 + [ctypes.c_longlong, _I, _I, _I, _P]
# the backward's blocks (csrc/layer_norm.cu): a row of at most
# _BWD_WARP_ROW values takes one warp, _BWD_WARPS warps a block, about
# _BWD_BLOCKS_PER_SM blocks on each SM; a wider row takes a whole block,
# about _WIDE_BLOCKS_PER_SM on each SM
_BWD_WARP_ROW = 1024
_BWD_WARPS = 8
_BWD_BLOCKS_PER_SM = 2
_WIDE_BLOCKS_PER_SM = 4


def layer_norm_fwd_reference(x, gamma, beta, eps=1e-5):
    """Plain PyTorch LayerNorm over the last axis, with the kernel's
    arithmetic: float32 two-pass statistics, gamma and beta rounded to
    x's dtype first.  Returns ``(y, mean, rstd)``; y has x's shape and
    dtype, mean and rstd are float32 of shape ``(rows,)``."""
    cols = x.shape[-1]
    xf = x.reshape(-1, cols).float()
    mean = xf.mean(dim=-1, keepdim=True)
    diff = xf - mean
    var = (diff * diff).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    g = gamma.to(x.dtype).float()
    b = beta.to(x.dtype).float()
    y = (diff * rstd * g + b).to(x.dtype).reshape(x.shape)
    return y, mean[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(x, g, gamma, mean, rstd):
    """Plain PyTorch LayerNorm backward with the kernel's arithmetic, all
    in float32: with xhat = (x - mean)·rstd and gg = g·gamma,
    dx = (gg - mean(gg) - xhat·mean(gg·xhat))·rstd in x's dtype,
    dgamma = Σ g·xhat and dbeta = Σ g over the rows in gamma's dtype."""
    cols = x.shape[-1]
    xf = x.reshape(-1, cols).float()
    gf = g.reshape(-1, cols).float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    gg = gf * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = ((gg - m1 - xhat * m2) * rstd[:, None]).to(x.dtype).reshape(x.shape)
    dgamma = (gf * xhat).sum(dim=0).to(gamma.dtype)
    dbeta = gf.sum(dim=0).to(gamma.dtype)
    return dx, dgamma, dbeta


def _check(name, x, cols, **vectors):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.dim() < 1 or cols == 0:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    for vname, (p, length) in vectors.items():
        if tuple(p.shape) != (length,):
            raise ValueError(f"{name}: {vname} shape {tuple(p.shape)} != "
                             f"({length},)")
        if p.device != x.device:
            raise ValueError(f"{name}: {vname} on {p.device}, x on "
                             f"{x.device}")


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis → ``(y, mean, rstd)``.

    On a CUDA tensor: the hand-written kernel, on the current stream.
    x must be contiguous float32 or bfloat16; gamma and beta are
    ``(cols,)`` on the same device and are cast to x's dtype first, as
    the TPU wrapper does.  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, gamma, beta, eps)
    cols = x.shape[-1] if x.dim() else 0
    _check("layer_norm_fwd", x, cols, gamma=(gamma, cols), beta=(beta, cols))
    gamma = gamma.to(x.dtype).contiguous()
    beta = beta.to(x.dtype).contiguous()
    rows = x.numel() // cols
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    fn = _build.launcher("layer_norm", "mx_layer_norm_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_DTYPE_CODES[x.dtype], x.device.index, x.data_ptr(),
           gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
           rstd.data_ptr(), rows, cols, float(eps), stream)
    global launches
    with _count_lock:
        launches += 1
    return y, mean, rstd


def bwd_plan(rows, cols, sms):
    """``(rows_per_block, blocks)`` of the backward kernel for ``rows``
    rows of ``cols`` values on a card of ``sms`` SMs.  Each block writes
    one partial row of dgamma and of dbeta, which a second kernel sums:
    enough blocks that loads overlap on every SM, and no more.  With one
    warp a row, at most one block for every eight rows (its warps)."""
    if cols <= _BWD_WARP_ROW:
        want = min(-(-rows // _BWD_WARPS), _BWD_BLOCKS_PER_SM * sms)
    else:
        want = _WIDE_BLOCKS_PER_SM * sms
    per_block = max(1, -(-rows // want))
    return per_block, -(-rows // per_block)


def layer_norm_bwd(x, g, gamma, mean, rstd):
    """Gradient of :func:`layer_norm_fwd` → ``(dx, dgamma, dbeta)``.

    ``x`` is the forward's input and ``mean``/``rstd`` its float32
    statistics; ``g`` is the gradient of y (x's shape and dtype).  dx
    comes out in x's dtype, dgamma and dbeta in gamma's.  On a CUDA
    tensor: the hand-written kernel, which writes per-block partial rows
    of dgamma and dbeta, and the file's second kernel, which sums them in
    a fixed order (the TPU wrapper sums its per-row-block partials the
    same way).  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, g, gamma, mean, rstd)
    cols = x.shape[-1] if x.dim() else 0
    rows = x.numel() // cols if cols else 0
    _check("layer_norm_bwd", x, cols, gamma=(gamma, cols), mean=(mean, rows),
           rstd=(rstd, rows))
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"layer_norm_bwd: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("layer_norm_bwd: mean and rstd must be float32")
    g = g.contiguous()
    gamma32 = gamma.float().contiguous()
    mean = mean.contiguous()
    rstd = rstd.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(cols, dtype=gamma.dtype, device=x.device)
        return dx, zeros, zeros.clone()
    per_block, blocks = bwd_plan(rows, cols, _sms(x.device.index))
    parts = torch.empty(2, blocks, cols, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, cols, dtype=torch.float32, device=x.device)
    fn = _build.launcher("layer_norm", "mx_layer_norm_bwd", _BWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_DTYPE_CODES[x.dtype], x.device.index, x.data_ptr(),
           g.data_ptr(), gamma32.data_ptr(), mean.data_ptr(),
           rstd.data_ptr(), dx.data_ptr(), parts.data_ptr(),
           sums.data_ptr(), rows, cols, per_block, blocks, stream)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    sums = sums.to(gamma.dtype)
    return dx, sums[0], sums[1]


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last axis with its own backward: the
    counterpart of the JAX package's ``fused_layer_norm`` custom VJP.
    The forward saves x, gamma and the float32 statistics, as
    ``_fused_ln_fwd`` does; the backward is :func:`layer_norm_bwd`.  Both
    run the kernels on the card and the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gy, gamma, mean, rstd)
        return dx, dgamma, dbeta, None
