"""RMSNorm over the last axis: the CUDA kernels, their plain PyTorch
versions, and the autograd Function that joins them.

Counterpart of ``fused_rms_norm`` in
``incubator_mxnet_tpu/ops/pallas_kernels.py``: :func:`rms_norm_fwd`
ports ``_rms_fwd`` and :func:`rms_norm_bwd` ports ``_rms_vjp_bwd``;
:class:`RMSNormFunction` is the custom VJP ``_fused_rms_core`` that
pairs them.  The TPU kernels take rows of at most 16384 values and the
JAX package computes wider ones with its XLA formula, the same function;
the Hopper kernels take a row of any width.  Each wrapper dispatches on
where x lies: a CPU tensor takes the plain version; a CUDA tensor
launches ``csrc/rms_norm.cu`` or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, _higher_order
from ._fused_common import sms as _sms

__all__ = ["rms_norm_fwd", "rms_norm_fwd_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference", "bwd_plan", "RMSNormFunction",
           "fwd_launches", "bwd_launches"]

#: Launches of the forward and the backward kernel so far; each wrapper
#: adds one per launch and nothing else touches them (a caller may reset
#: them to 0).
fwd_launches = 0
bwd_launches = 0

_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
# the C entries' arguments (csrc/rms_norm.cu)
_FWD_ARGS = [_I, _I] + [_P] * 4 + [ctypes.c_longlong, _I, ctypes.c_float,
                                   _P]
_BWD_ARGS = [_I, _I, _I] + [_P] * 7 + [ctypes.c_longlong, _I, _I, _I, _P]
# the backward's blocks (csrc/rms_norm.cu): a row of at most _WARP_ROW
# values takes one warp, _WARPS warps a block, at most _BWD_BLOCKS_PER_SM
# blocks on each SM for rows of at most _TWO_BLOCK_ROW values and one
# above (what the kernel's registers let stay resident); a wider row
# takes a whole block, about _WIDE_BLOCKS_PER_SM on each SM
_WARP_ROW = 1024
_TWO_BLOCK_ROW = 512
_WARPS = 8
_BWD_BLOCKS_PER_SM = 2
_WIDE_BLOCKS_PER_SM = 4


def rms_norm_fwd_reference(x, gamma, eps=1e-6):
    """Plain PyTorch RMSNorm over the last axis with the kernel's
    arithmetic: ``rrms = rsqrt(Σx²/n + eps)`` in float32, gamma rounded to
    x's dtype first, ``y = x·rrms·gamma`` in float32 and rounded once to
    x's dtype.  Returns ``(y, rrms)``; rrms is float32 of shape
    ``(rows,)``."""
    cols = x.shape[-1]
    xf = x.reshape(-1, cols).float()
    rrms = torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) / cols + eps)
    y = (xf * rrms * gamma.to(x.dtype).float()).to(x.dtype)
    return y.reshape(x.shape), rrms[:, 0]


def rms_norm_bwd_reference(x, g, gamma, rrms):
    """Plain PyTorch RMSNorm backward with the kernel's arithmetic, in
    float32, with g and gamma rounded to x's dtype first and
    ``gg = g·gamma``: ``dx = rrms·(gg − x·rrms²·Σ(gg·x)/n)`` in x's dtype
    and ``dgamma = Σ g·x·rrms`` over the rows in gamma's dtype."""
    cols = x.shape[-1]
    xf = x.reshape(-1, cols).float()
    gf = g.to(x.dtype).reshape(-1, cols).float()
    r = rrms[:, None]
    gg = gf * gamma.to(x.dtype).float()
    s = (gg * xf).sum(dim=-1, keepdim=True)
    dx = r * (gg - xf * (r * r) * s / cols)
    dgamma = (gf * xf * r).sum(dim=0).to(gamma.dtype)
    return dx.to(x.dtype).reshape(x.shape), dgamma


def _check(name, x, gamma):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    if tuple(gamma.shape) != (x.shape[-1],) or gamma.device != x.device:
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} on "
                         f"{gamma.device} does not fit x {tuple(x.shape)} on "
                         f"{x.device}")


def _launch(symbol, argtypes, device, *args):
    fn = _build.launcher("rms_norm", symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        fn(*args, stream)


def rms_norm_fwd(x, gamma, eps=1e-6):
    """RMSNorm over the last axis → ``(y, rrms)``.

    On a CUDA tensor: the hand-written kernel, on the current stream; x
    must be contiguous float32 or bfloat16, gamma ``(cols,)`` on the same
    device (cast to x's dtype first, as the TPU wrapper does).  On a CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return rms_norm_fwd_reference(x, gamma, eps)
    _check("rms_norm_fwd", x, gamma)
    gamma = gamma.to(x.dtype).contiguous()
    cols = x.shape[-1]
    rows = x.numel() // cols
    y = torch.empty_like(x)
    rrms = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, rrms
    _launch("mx_rms_norm_fwd", _FWD_ARGS, x.device, _DTYPE_CODES[x.dtype],
            x.device.index, x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
            rrms.data_ptr(), rows, cols, float(eps))
    global fwd_launches
    with _count_lock:
        fwd_launches += 1
    return y, rrms


def bwd_plan(rows, cols, sms):
    """``(rows_per_block, blocks)`` of the backward kernel for ``rows``
    rows of ``cols`` values on a card of ``sms`` SMs.  Each block writes
    one partial row of dgamma, which a second kernel sums: enough blocks
    to fill every SM once, and no more.  With one warp a row, at most one
    block for every eight rows (its warps) and at most the blocks that
    stay resident on an SM: two of eight warps for rows of at most 512
    values (at most 128 registers a thread), one above; a wider row, at
    most four blocks of 512 threads an SM."""
    if cols <= _WARP_ROW:
        per_sm = _BWD_BLOCKS_PER_SM if cols <= _TWO_BLOCK_ROW else 1
        want = min(-(-rows // _WARPS), per_sm * sms)
    else:
        want = _WIDE_BLOCKS_PER_SM * sms
    per_block = max(1, -(-rows // want))
    return per_block, -(-rows // per_block)


def rms_norm_bwd(x, g, gamma, rrms):
    """Gradient of :func:`rms_norm_fwd` → ``(dx, dgamma)``.

    ``x`` is the forward's input and ``rrms`` its float32 statistic; ``g``
    is the gradient of y, cast to x's dtype first, as the TPU wrapper
    does.  dx comes out in x's dtype, dgamma in gamma's.  On a CUDA
    tensor: the hand-written kernel, which reads gamma in its own dtype
    where that is float32 or x's (another is rounded to x's and held in
    float32 first) and rounds it to x's as the TPU wrapper casts it, and
    writes per-block partial rows of dgamma; then the file's second
    kernel, which sums them in a fixed order and writes dgamma in the
    dtype it read gamma in (the TPU wrapper sums its per-row-block
    partials the same way).  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return rms_norm_bwd_reference(x, g, gamma, rrms)
    _check("rms_norm_bwd", x, gamma)
    cols = x.shape[-1]
    rows = x.numel() // cols
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    if rrms.dtype != torch.float32 or tuple(rrms.shape) != (rows,):
        raise ValueError(f"rms_norm_bwd: rrms must be float32 ({rows},), got "
                         f"{rrms.dtype} {tuple(rrms.shape)}")
    g = g.to(x.dtype).contiguous()
    # another dtype is rounded to x's as the plain version rounds it,
    # then held exactly in float32
    gam = (gamma if gamma.dtype in (x.dtype, torch.float32)
           else gamma.to(x.dtype).float()).contiguous()
    rrms = rrms.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros(cols, dtype=gamma.dtype, device=x.device)
    per_block, blocks = bwd_plan(rows, cols, _sms(x.device.index))
    parts = torch.empty(blocks, cols, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(cols, dtype=gam.dtype, device=x.device)
    _launch("mx_rms_norm_bwd", _BWD_ARGS, x.device, _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[gam.dtype], x.device.index, x.data_ptr(),
            g.data_ptr(), gam.data_ptr(), rrms.data_ptr(), dx.data_ptr(),
            parts.data_ptr(), dgamma.data_ptr(), rows, cols, per_block,
            blocks)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dx, dgamma.to(gamma.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm over the last axis with its own backward: the counterpart
    of the JAX package's ``_fused_rms_core`` custom VJP.  The forward
    saves x, gamma and the float32 rrms, as ``_rms_fwd`` does; the
    backward is :func:`rms_norm_bwd`.  Both run the kernels on the card
    and the plain versions on the CPU.  Under ``create_graph`` the
    backward is differentiable on the CPU and refuses a second
    derivative on the card (``_higher_order.py``)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, rrms = rms_norm_fwd(x, gamma, eps)
        ctx.save_for_backward(x, gamma, rrms)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, rrms = ctx.saved_tensors
        if torch.is_grad_enabled() and x.device.type == "cpu":
            _, rrms = rms_norm_fwd_reference(x, gamma, ctx.eps)
        grads = rms_norm_bwd(x, gy, gamma, rrms)
        if torch.is_grad_enabled() and x.device.type != "cpu":
            grads = _higher_order.guard("rms_norm_bwd", grads,
                                        (x, gamma, gy))
        return (*grads, None)
