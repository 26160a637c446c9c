"""Flash attention: the CUDA kernels, their plain PyTorch versions, and
the autograd Function that joins them.

Counterpart of the flash-attention section of
``incubator_mxnet_tpu/ops/pallas_kernels.py``: :func:`flash_fwd` ports
``_flash_fwd_kernel`` (launched by ``_flash_fwd_impl``), and
:func:`flash_bwd` is the Hopper backward that the JAX package computes
in XLA as ``_attn_bwd_reference``; :func:`flash_attention` is the entry
``flash_attention(q, k, v, sm_scale=None, causal=False)`` with its
custom VJP.  Shapes are (B, H, T, D), any D from 1 to 128; causal
masking keeps ``col <= row``, aligned top-left, so Tq and Tk may differ.

The numbers are the JAX package's: the forward widens q to float32 and
scales it before q·kᵀ, masks with -1e30, and keeps both products and the
probabilities in float32, dividing by ``max(l, 1e-30)``; the backward
computes ``s = (q·kᵀ)·scale`` (the scale applied after the product, as
``_attn_bwd_reference`` does), ``ds = p·(dp − delta)·scale`` and the
three gradients in float32, each written in its input's dtype.

The kernels take two routes by dtype, forward and backward alike.
float32 inputs run float32-FMA kernels.  bfloat16 inputs run
tensor-core kernels (bf16 operands, float32 sums) that keep those
numbers: q·kᵀ and dO·vᵀ have bf16 operands only, so their products are
exact (the forward applies the scale to s after the product, which for
D = 64 is JAX's ``(q·scale)·kᵀ`` exactly and for other D moves s by one
float32 rounding); p and ds, which stay float32, enter p·v, pᵀ·dO, dsᵀ·q
and ds·k as two bf16 parts, hi = bf16(x) and lo = bf16(x − hi), each
product summed in float32.  The online softmax, the mask, lse and the
division stay float32.  That puts o within 0.95e-6 to 3.2e-6 of its
largest value from the Pallas kernel's float32 output, and the gradients
within 1.7e-6 to 3.2e-6 from the JAX function's float32 backward, at
the TransformerLM's T and head width (o also at cross lengths and D =
32, 128), where one bf16 rounding of p would put o 7.9e-4 away and of p
and ds the gradients 1.2e-3 to 2.4e-3 (``tests/test_torch_flash_attention.py``
emulates both).  The bfloat16 kernels copy rows 16 bytes at a time when
every input's start, strides and D allow it (:func:`_vec16`), else
element by element.  The forward writes o in float32 when autograd
wants the residual (:class:`FlashAttentionFunction`), else in q's dtype.

Two differences of method, not of result:

* The forward returns the row logsumexp ``lse = m + log l`` and the
  backward recomputes ``p = exp(s − lse)``, where JAX recomputes the row
  statistics (m, l) in a first scan.
* ``delta = rowsum(dO·O)`` must use the float32 O, as JAX's recomputed
  O is.  When a gradient is wanted, :class:`FlashAttentionFunction` has
  the forward kernel write O in float32, saves that and returns its
  bf16 rounding (the same value the kernel would write in bf16).  At the
  TransformerLM's shape, (32, 8, 1024, 64), that residual is 64 MiB a
  layer instead of the 32 MiB of the bf16 output; recomputing O would
  cost a second forward.

The kernels take strided q, k, v, O and dO as they come (the model's
heads are transposed views): only the last dimension must be
contiguous, and the outputs are laid out (B, T, H, D) in memory, so the
model's transpose back to (B, T, H·D) is a view.

Each wrapper dispatches on where its inputs lie: CPU tensors take the
plain version; CUDA tensors launch ``csrc/flash_attention.cu`` or
raise.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, _higher_order

__all__ = ["flash_fwd", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "FlashAttentionFunction",
           "flash_attention", "fwd_launches", "bwd_dkdv_launches",
           "bwd_dq_launches", "MAX_HEAD_DIM"]

#: Launches of the forward, the dk/dv and the dq kernel so far; each
#: wrapper adds one per launch and nothing else touches them (a caller
#: may reset them to 0).
fwd_launches = 0
bwd_dkdv_launches = 0
bwd_dq_launches = 0

#: The widest head the kernels take.
MAX_HEAD_DIM = 128

_NEG_INF = -1e30
_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# the C entries' arguments (csrc/flash_attention.cu)
_FWD_ARGS = [_I, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P]
_DKDV_ARGS = [_I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_DQ_ARGS = [_I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P]


def _scale(q, sm_scale):
    return float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5


def _keep(tq, tk, device):
    """``(tq, tk)`` bool, True where ``col <= row``."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()


def flash_fwd_reference(q, k, v, sm_scale=None, causal=False,
                        out_dtype=None):
    """Plain PyTorch attention with the kernel's arithmetic → ``(o,
    lse)``: ``s = (q.f32·scale)·k.f32ᵀ``, -1e30 above the diagonal in
    causal mode, ``e = exp(s − max s)``, ``o = (e·v.f32) / max(Σe,
    1e-30)`` in ``out_dtype`` (q's dtype if None), ``lse = max s +
    log max(Σe, 1e-30)`` (B, H, Tq) in float32."""
    scale = _scale(q, sm_scale)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_keep(s.shape[-2], s.shape[-1], s.device),
                          _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(e, v.float()) / den
    lse = (m + torch.log(den)).squeeze(-1)
    return o.to(out_dtype or q.dtype), lse


def flash_bwd_reference(q, k, v, o, lse, do, sm_scale=None, causal=False):
    """Plain PyTorch gradient of attention → ``(dq, dk, dv)`` in q's, k's
    and v's dtypes, all in float32 inside: ``s = (q·kᵀ)·scale``,
    ``p = exp(s − lse)`` (0 above the diagonal in causal mode),
    ``delta = Σ dO·o`` over D, ``ds = p·(dO·vᵀ − delta)·scale``; ``dq =
    ds·k``, ``dk = dsᵀ·q``, ``dv = pᵀ·dO``.  ``o`` is the forward's
    output in float32 and ``lse`` its row logsumexp."""
    scale = _scale(q, sm_scale)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    if causal:
        p = torch.where(_keep(s.shape[-2], s.shape[-1], s.device), p, 0.0)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, *more):
    """Raises unless q (B, H, Tq, D) and k, v (B, H, Tk, D) are CUDA
    tensors of one device and one supported dtype (``more`` too, device
    only) that the kernels take."""
    for t in (q, k, v, *more):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: every tensor must be on {q.device} "
                             f"(CUDA); got {t.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of float32, "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: want q (B, H, Tq, D), k and v (B, H, Tk, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d = q.shape[3]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not taken by the kernels "
                         f"(1 to {MAX_HEAD_DIM}); wider heads are future "
                         "work (ROADMAP §B, row 5)")
    if k.shape[2] == 0:
        raise ValueError(f"{name}: no keys (Tk = 0)")


def _rows(t):
    """t with its last dimension contiguous (a copy only if it is not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _bthd(b, t, h, d, dtype, device):
    """An empty (B, H, T, D) tensor laid out (B, T, H, D) in memory."""
    return torch.empty(b, t, h, d, dtype=dtype, device=device).transpose(1, 2)


def _strides(q, k, v, g=None, o=None, dq=None, dk=None, dv=None):
    """The (b, h, t) element strides of the eight tensors a C entry reads
    them for, in its order; zeros for those it does not use."""
    flat = [s for t in (q, k, v, g, o, dq, dk, dv)
            for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * 24)(*flat)


def _vec16(*tensors):
    """True when the bfloat16 kernels may copy rows of every tensor 16
    bytes at a time: each starts on 16 bytes, and its (b, h, t) strides
    and its last dimension are multiples of 8 elements.  Else they load
    element by element."""
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
               and all(s % 8 == 0 for s in t.stride()[:3]) for t in tensors)


def _shape(q, k, causal):
    b, h, tq, d = q.shape
    return (ctypes.c_longlong * 6)(b, h, tq, k.shape[2], d, int(causal))


def _launch(symbol, argtypes, device, *args):
    fn = _build.launcher("flash_attention", symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        fn(*args, stream)


def _count(attr):
    with _count_lock:
        globals()[attr] += 1


def flash_fwd(q, k, v, sm_scale=None, causal=False, out_dtype=None):
    """Attention forward → ``(o, lse)``: o (B, H, Tq, D) in ``out_dtype``
    (q's dtype if None; float32 is also taken for bfloat16 inputs), lse
    (B, H, Tq) float32.

    On CUDA tensors: the hand-written kernel, on the current stream.  On
    CPU tensors: the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, sm_scale, causal, out_dtype)
    _check("flash_fwd", q, k, v)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"flash_fwd: out_dtype {out_dtype} not supported "
                        f"for {q.dtype} inputs")
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, h, tq, d = q.shape
    o = _bthd(b, tq, h, d, out_dtype, q.device)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    if b == 0 or tq == 0:
        return o, lse
    _launch("mx_flash_fwd", _FWD_ARGS, q.device, _DTYPE_CODES[q.dtype],
            int(out_dtype != q.dtype), int(_vec16(q, k, v)), q.device.index,
            _shape(q, k, causal), _strides(q, k, v, o=o),
            _scale(q, sm_scale), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    _count("fwd_launches")
    return o, lse


def flash_bwd(q, k, v, o, lse, do, sm_scale=None, causal=False):
    """Gradient of :func:`flash_fwd` → ``(dq, dk, dv)`` in q's, k's and
    v's dtypes.  ``o`` is the forward's output in float32 (it gives delta),
    ``lse`` its row logsumexp, ``do`` the gradient of o, cast to q's dtype
    first (the dtype of the JAX package's cotangent).

    On CUDA tensors: delta = Σ dO·o over D as a torch expression, then
    the dk/dv kernel and the dq kernel.  On CPU tensors: the plain
    version."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do.to(q.dtype), sm_scale,
                                   causal)
    _check("flash_bwd", q, k, v, o, lse, do)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, tq):
        raise ValueError(f"flash_bwd: o {tuple(o.shape)}, dO "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_bwd: lse must be float32, not {lse.dtype}")
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do.to(q.dtype))
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq = _bthd(b, tq, h, d, q.dtype, q.device)
    dk = _bthd(b, tk, h, d, k.dtype, q.device)
    dv = _bthd(b, tk, h, d, v.dtype, q.device)
    if b == 0:
        return dq, dk, dv
    if tq == 0:
        return dq, dk.zero_(), dv.zero_()
    code, dev = _DTYPE_CODES[q.dtype], q.device.index
    vec = int(_vec16(q, k, v, do))
    shape, scale = _shape(q, k, causal), _scale(q, sm_scale)
    _launch("mx_flash_bwd_dkdv", _DKDV_ARGS, q.device, code, vec, dev,
            shape, _strides(q, k, v, do, dk=dk, dv=dv), scale, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    _count("bwd_dkdv_launches")
    _launch("mx_flash_bwd_dq", _DQ_ARGS, q.device, code, vec, dev, shape,
            _strides(q, k, v, do, dq=dq), scale, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr())
    _count("bwd_dq_launches")
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its own backward: the counterpart of the JAX
    package's ``_flash_core`` custom VJP.  When any of q, k, v needs a
    gradient, the forward writes O in float32, saves it with lse, q, k
    and v, and returns O in q's dtype; the backward is :func:`flash_bwd`.
    Both run the kernels on the card and the plain versions on the
    CPU.  A second derivative through it raises on either device
    (``_higher_order.py``), as the JAX package's flash attention raises
    under a second ``jax.grad`` on its CPU path too."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        grad = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd(q, k, v, sm_scale, causal,
                           torch.float32 if grad else None)
        if grad:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_bwd(q, k, v, o, lse, do, ctx.sm_scale, ctx.causal)
        if torch.is_grad_enabled():
            grads = _higher_order.guard("flash_attention_bwd", grads,
                                        (q, k, v, do))
        return (*grads, None, None)


def flash_attention(q, k, v, sm_scale=None, causal=False):
    """softmax(q·kᵀ·scale)·v over (B, H, T, D) without the (T, T) logits
    in memory; ``sm_scale`` defaults to ``D ** -0.5``.  Differentiable
    in q, k and v."""
    return FlashAttentionFunction.apply(q, k, v, _scale(q, sm_scale),
                                        bool(causal))
