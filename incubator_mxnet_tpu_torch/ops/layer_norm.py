"""LayerNorm forward over the last axis: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``fused_layer_norm``/``_ln_fwd`` in
``incubator_mxnet_tpu/ops/pallas_kernels.py``.  :func:`layer_norm_fwd`
dispatches on where ``x`` lies: a CPU tensor takes
:func:`layer_norm_fwd_reference`; a CUDA tensor launches
``csrc/layer_norm.cu`` or raises.  Nothing falls back from the card to
the plain version.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..error import KernelError
from . import _build

__all__ = ["layer_norm_fwd", "layer_norm_fwd_reference", "launches"]

#: Kernel launches so far; :func:`layer_norm_fwd` adds one per launch
#: and nothing else touches it (a caller may reset it to 0).
launches = 0

_count_lock = threading.Lock()
_fn = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("layer_norm")
        fn = lib.mx_layer_norm_fwd
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.mx_cuda_error_string)
    return _fn


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis → ``(y, mean, rstd)``.

    On a CUDA tensor: the hand-written kernel, on the current stream.
    x must be contiguous float32 or bfloat16; gamma and beta are
    ``(cols,)`` on the same device and are cast to x's dtype first, as
    the TPU wrapper does.  On a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm_fwd: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("layer_norm_fwd: x must be contiguous")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"layer_norm_fwd: bad shape {tuple(x.shape)}")
    cols = x.shape[-1]
    for name, p in (("gamma", gamma), ("beta", beta)):
        if tuple(p.shape) != (cols,):
            raise ValueError(f"layer_norm_fwd: {name} shape "
                             f"{tuple(p.shape)} != ({cols},)")
        if p.device != x.device:
            raise ValueError(f"layer_norm_fwd: {name} on {p.device}, "
                             f"x on {x.device}")
    gamma = gamma.to(x.dtype).contiguous()
    beta = beta.to(x.dtype).contiguous()
    rows = x.numel() // cols
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.device.index, x.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), rows, cols, float(eps),
                 stream)
    if err != 0:
        raise KernelError(f"layer_norm kernel launch failed: "
                          f"{err_str(err).decode()} (cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
    return y, mean, rstd
