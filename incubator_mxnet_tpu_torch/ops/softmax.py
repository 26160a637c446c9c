"""Softmax along an axis: the CUDA kernels, their plain PyTorch versions,
and the autograd Function that joins them.

Counterpart of ``fused_softmax`` in
``incubator_mxnet_tpu/ops/pallas_kernels.py``: :func:`softmax_fwd` ports
``_softmax_fwd_kernel`` and :func:`softmax_bwd` ports
``_softmax_bwd_kernel``; :class:`SoftmaxFunction` is the custom VJP that
pairs them, for any axis.  The TPU kernels take rows of at most 16384
values (one row must fit its on-chip memory) and the JAX package
computes wider rows with ``jax.nn.softmax``, the same function; the
Hopper kernels take a row of any width, so every width goes through
them.

Each wrapper dispatches on where its input lies: a CPU tensor takes the
plain version; a CUDA tensor launches ``csrc/softmax.cu`` or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, _higher_order

__all__ = ["softmax_fwd", "softmax_fwd_reference", "softmax_bwd",
           "softmax_bwd_reference", "SoftmaxFunction", "fwd_launches",
           "bwd_launches"]

#: Launches of the forward and the backward kernel so far; each wrapper
#: adds one per launch and nothing else touches them (a caller may reset
#: them to 0).
fwd_launches = 0
bwd_launches = 0

_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
# the C entries' arguments (csrc/softmax.cu)
_FWD_ARGS = [_I, _I, _P, _P, ctypes.c_longlong, _I, _P]
_BWD_ARGS = [_I, _I, _P, _P, _P, ctypes.c_longlong, _I, _P]


def softmax_fwd_reference(x):
    """Plain PyTorch softmax over the last axis with the kernel's
    arithmetic: in float32, the row max, ``exp(x - max)``, its sum, the
    true division ``e / s``; y in x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_bwd_reference(y, g):
    """Plain PyTorch softmax backward over the last axis, in float32:
    ``dx = y·(g − Σ y·g)``, written in y's dtype."""
    yf, gf = y.float(), g.float()
    inner = (yf * gf).sum(dim=-1, keepdim=True)
    return (yf * (gf - inner)).to(y.dtype)


def _check(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _launch(symbol, argtypes, device, *args):
    fn = _build.launcher("softmax", symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        fn(*args, stream)


def softmax_fwd(x):
    """Softmax over the last axis → y, x's shape and dtype.

    On a CUDA tensor: the hand-written kernel, on the current stream; x
    must be contiguous float32 or bfloat16.  On a CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return softmax_fwd_reference(x)
    _check("softmax_fwd", x)
    cols = x.shape[-1]
    rows = x.numel() // cols
    y = torch.empty_like(x)
    if rows == 0:
        return y
    _launch("mx_softmax_fwd", _FWD_ARGS, x.device, _DTYPE_CODES[x.dtype],
            x.device.index, x.data_ptr(), y.data_ptr(), rows, cols)
    global fwd_launches
    with _count_lock:
        fwd_launches += 1
    return y


def softmax_bwd(y, g):
    """Gradient of :func:`softmax_fwd` → dx, y's shape and dtype.

    ``y`` is the forward's output as stored and ``g`` the gradient of y;
    g is cast to y's dtype first, the dtype of the JAX package's
    cotangent.  On a CUDA tensor: the hand-written kernel.  On a CPU
    tensor: the plain version."""
    if y.device.type == "cpu":
        return softmax_bwd_reference(y, g.to(y.dtype))
    _check("softmax_bwd", y)
    if g.shape != y.shape or g.device != y.device:
        raise ValueError(f"softmax_bwd: g {tuple(g.shape)} on {g.device} "
                         f"does not match y {tuple(y.shape)} on {y.device}")
    g = g.to(y.dtype).contiguous()
    cols = y.shape[-1]
    rows = y.numel() // cols
    dx = torch.empty_like(y)
    if rows == 0:
        return dx
    _launch("mx_softmax_bwd", _BWD_ARGS, y.device, _DTYPE_CODES[y.dtype],
            y.device.index, y.data_ptr(), g.data_ptr(), dx.data_ptr(), rows,
            cols)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dx


class SoftmaxFunction(torch.autograd.Function):
    """Softmax along ``axis`` with its own backward: the counterpart of
    the JAX package's ``fused_softmax`` custom VJP.  The axis is moved
    last for the kernels and back afterwards.  The forward saves its
    output as stored, in x's dtype, because the JAX backward reads the
    rounded y; the backward is :func:`softmax_bwd`.  Both run the kernels
    on the card and the plain versions on the CPU.  The output is saved
    as returned, so under ``create_graph`` it carries the graph and the
    plain backward on the CPU is differentiable; on the card a second
    derivative is refused (``_higher_order.py``)."""

    @staticmethod
    def forward(ctx, x, axis=-1):
        ax = axis % x.dim()
        out = softmax_fwd(x.movedim(ax, -1).contiguous()).movedim(-1, ax)
        ctx.save_for_backward(out)
        ctx.axis = ax
        return out

    @staticmethod
    def backward(ctx, gy):
        (out,) = ctx.saved_tensors
        y = out.movedim(ctx.axis, -1)      # the kernel's contiguous y
        dx = softmax_bwd(y, gy.movedim(ctx.axis, -1).contiguous())
        if torch.is_grad_enabled() and y.device.type != "cpu":
            (dx,) = _higher_order.guard("softmax_bwd", (dx,), (out, gy))
        return dx.movedim(-1, ctx.axis), None
