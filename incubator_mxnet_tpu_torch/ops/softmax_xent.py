"""Softmax cross-entropy over the last axis: the CUDA kernels, their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``fused_softmax_xent`` in
``incubator_mxnet_tpu/ops/pallas_kernels.py``: per row of logits (N, C)
and an integer label, loss = logsumexp(x) - x[clip(label, 0, C - 1)] in
float32, and dx = (softmax(x) - onehot(clip(label)))·g in the logits'
dtype.  The TPU kernel takes rows of at most 16384 columns (one row
must fit its on-chip memory) and the JAX package computes wider rows by
composition; the Hopper kernel streams a row of any width, so every
width goes through it.  The forward also keeps each row's float32
logsumexp, which the backward reuses instead of recomputing the row's
max and sum.

Each wrapper dispatches on where the logits lie: a CPU tensor takes the
plain version; a CUDA tensor launches ``csrc/softmax_xent.cu`` or
raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, _higher_order

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_reference",
           "softmax_xent_bwd", "softmax_xent_bwd_reference",
           "SoftmaxXentFunction", "fwd_launches", "bwd_launches"]

#: Launches of the forward and the backward kernel so far; each wrapper
#: adds one per launch and nothing else touches them (a caller may reset
#: them to 0).
fwd_launches = 0
bwd_launches = 0

_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
# the C entries' arguments (csrc/softmax_xent.cu)
_FWD_ARGS = [_I, _I] + [_P] * 4 + [ctypes.c_longlong, _I, _P]
_BWD_ARGS = [_I, _I] + [_P] * 5 + [ctypes.c_longlong, _I, _P]


def _clipped(labels, cols):
    return labels.long().clamp(0, cols - 1)


def softmax_xent_fwd_reference(logits, labels):
    """Plain PyTorch version → ``(loss, lse)``, both float32 ``(N,)``:
    lse = logsumexp of the float32 logits, loss = lse - x[clip(label)]."""
    xf = logits.float()
    lse = torch.logsumexp(xf, dim=-1)
    picked = xf.gather(1, _clipped(labels, logits.shape[1])[:, None])[:, 0]
    return lse - picked, lse


def softmax_xent_bwd_reference(logits, labels, lse, g):
    """Plain PyTorch version of the backward: dx = (exp(x - lse) -
    onehot(clip(label)))·g, in float32, cast to the logits' dtype."""
    xf = logits.float()
    p = torch.exp(xf - lse[:, None])
    idx = _clipped(labels, logits.shape[1])[:, None]
    p = p.scatter_add(1, idx, torch.full_like(idx, -1, dtype=p.dtype))
    return (p * g.float()[:, None]).to(logits.dtype)


def _check(name, x, labels, **vectors):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"{name}: logits must be (N, C) with C >= 1, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: logits must be contiguous")
    rows = x.shape[0]
    for vname, v in dict(labels=labels, **vectors).items():
        if tuple(v.shape) != (rows,):
            raise ValueError(f"{name}: {vname} shape {tuple(v.shape)} != "
                             f"({rows},)")
        if v.device != x.device:
            raise ValueError(f"{name}: {vname} on {v.device}, logits on "
                             f"{x.device}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex:
        raise TypeError(f"{name}: labels must be integers, got "
                        f"{labels.dtype}")


def softmax_xent_fwd(logits, labels):
    """Per-row softmax cross-entropy → ``(loss, lse)``, float32 ``(N,)``.

    ``logits`` is (N, C), float32 or bfloat16, contiguous; ``labels`` is
    (N,) integer on the same device, clipped into [0, C - 1].  On a CUDA
    tensor: the hand-written kernel, on the current stream.  On a CPU
    tensor: the plain version."""
    if logits.device.type == "cpu":
        return softmax_xent_fwd_reference(logits, labels)
    _check("softmax_xent_fwd", logits, labels)
    rows, cols = logits.shape
    labels = labels.to(torch.int32).contiguous()
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if rows == 0:
        return loss, lse
    fn = _build.launcher("softmax_xent", "mx_softmax_xent_fwd", _FWD_ARGS)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        fn(_DTYPE_CODES[logits.dtype], logits.device.index,
           logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
           lse.data_ptr(), rows, cols, stream)
    global fwd_launches
    with _count_lock:
        fwd_launches += 1
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g):
    """Gradient of :func:`softmax_xent_fwd`'s loss → dx, (N, C) in the
    logits' dtype.  ``lse`` is the forward's float32 logsumexp and ``g``
    the gradient of each row's loss, (N,).  On a CUDA tensor: the
    hand-written kernel.  On a CPU tensor: the plain version."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_reference(logits, labels, lse, g)
    _check("softmax_xent_bwd", logits, labels, lse=lse, g=g)
    if lse.dtype != torch.float32:
        raise TypeError("softmax_xent_bwd: lse must be float32")
    rows, cols = logits.shape
    labels = labels.to(torch.int32).contiguous()
    lse = lse.contiguous()
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(logits)
    if rows == 0:
        return dx
    fn = _build.launcher("softmax_xent", "mx_softmax_xent_bwd", _BWD_ARGS)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        fn(_DTYPE_CODES[logits.dtype], logits.device.index,
           logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
           g.data_ptr(), dx.data_ptr(), rows, cols, stream)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """Per-row softmax cross-entropy with its own backward: the
    counterpart of the JAX package's ``fused_softmax_xent`` custom VJP.
    ``apply(logits (N, C), labels (N,) int)`` → float32 loss (N,); labels
    get no gradient.  Under ``create_graph`` the backward is
    differentiable on the CPU (lse recomputed from the logits, so that it
    carries the graph) and refuses a second derivative on the card
    (``_higher_order.py``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        if torch.is_grad_enabled() and logits.device.type == "cpu":
            _, lse = softmax_xent_fwd_reference(logits, labels)
        dx = softmax_xent_bwd(logits, labels, lse, g)
        if torch.is_grad_enabled() and logits.device.type != "cpu":
            (dx,) = _higher_order.guard("softmax_xent_bwd", (dx,),
                                        (logits, g))
        return dx, None
