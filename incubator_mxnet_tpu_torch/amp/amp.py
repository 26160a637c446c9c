"""AMP entry points (counterpart of ``incubator_mxnet_tpu/amp/amp.py``, its
eager / Gluon path).

``convert_block`` casts a block's parameters to the low-precision dtype
(the norm layers' gamma and beta and every moving statistic stay
float32) and attaches a :class:`CastPolicy` built from the op lists in
``lists.py``.  The block's forward runs under the policy
(``gluon/block.py``), and every op function of the port casts its
floating inputs through :func:`cast_args` under the op's registry name
in the JAX package (``Convolution``, ``FullyConnected``, ``mean``, ...),
where the JAX package casts them once in ``ops/registry.invoke``.

bfloat16 needs no loss scaling.  float16 (``LossScaler``,
``scale_loss``, ``unscale``, ``init_trainer``) and the symbol rewrite
(``convert_symbol``, ``convert_model``) are not ported yet.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import lists

__all__ = ["init", "CastPolicy", "current_policy", "policy_scope",
           "cast_args", "convert_block"]

_state = {"initialized": False, "dtype": None}
_tls = threading.local()

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32}


def _dtype(target_dtype) -> torch.dtype:
    if isinstance(target_dtype, torch.dtype):
        return target_dtype
    try:
        return _DTYPES[str(target_dtype)]
    except KeyError:
        raise TypeError(f"unknown AMP dtype {target_dtype!r}") from None


def init(target_dtype="bfloat16"):
    """Enable mixed precision in ``target_dtype`` (bfloat16; float16 is
    not ported yet).  bfloat16 keeps float32's exponent range, so no
    loss scaling is needed."""
    dtype = _dtype(target_dtype)
    if dtype == torch.float16:
        raise NotImplementedError(
            "AMP in float16 needs the dynamic LossScaler, which is not "
            "ported yet; use target_dtype='bfloat16'")
    _state["initialized"] = True
    _state["dtype"] = dtype
    return _state


class CastPolicy:
    """Per-op dtype decisions compiled from the AMP lists.

    ``cast_args(op_name, tensors)`` returns the tensors with their
    floating members cast per the op's class: lp16 ops to the
    low-precision target, fp32 ops to float32, widest-type ops to the
    widest floating dtype among the inputs.  Non-floating tensors (int
    labels, bool masks), ``None`` and ops in no list pass through
    untouched."""

    def __init__(self, target_dtype="bfloat16", target_dtype_ops=None,
                 fp32_ops=None, widest_dtype_ops=None, excluded_ops=None):
        self.target_dtype = _dtype(target_dtype)
        lp16, fp32, widest = lists.get_lists(target_dtype)
        self.lp16 = set(lp16 if target_dtype_ops is None else target_dtype_ops)
        self.fp32 = set(fp32 if fp32_ops is None else fp32_ops)
        self.widest = set(widest if widest_dtype_ops is None
                          else widest_dtype_ops)
        self.excluded = set(excluded_ops or ())
        overlap = self.lp16 & self.fp32
        if overlap:
            raise ValueError(
                f"ops cannot be in both the target-dtype and fp32 lists: "
                f"{sorted(overlap)}")

    def op_class(self, op_name):
        if op_name in self.excluded:
            return None
        if op_name in self.lp16:
            return "lp16"
        if op_name in self.fp32:
            return "fp32"
        if op_name in self.widest:
            return "widest"
        return None

    def cast_args(self, op_name, tensors):
        cls = self.op_class(op_name)
        if cls is None:
            return list(tensors)

        def is_float(t):
            return isinstance(t, torch.Tensor) and t.is_floating_point()

        if cls == "lp16":
            tgt = self.target_dtype
        elif cls == "fp32":
            tgt = torch.float32
        else:
            floats = [t.dtype for t in tensors if is_float(t)]
            if not floats:
                return list(tensors)
            tgt = max(floats, key=lambda d: torch.finfo(d).bits)
        return [t.to(tgt) if is_float(t) and t.dtype != tgt else t
                for t in tensors]


def current_policy():
    """The policy of the innermost converted block running on this
    thread, or None."""
    return getattr(_tls, "policy", None)


@contextlib.contextmanager
def policy_scope(policy):
    prev = getattr(_tls, "policy", None)
    _tls.policy = policy
    try:
        yield policy
    finally:
        _tls.policy = prev


def cast_args(op_name, *tensors):
    """``tensors`` cast for op ``op_name`` (its registry name in the JAX
    package) by the active policy, as a tuple; unchanged when no
    converted block is running."""
    policy = current_policy()
    if policy is None:
        return tensors
    return tuple(policy.cast_args(op_name, tensors))


_KEEP_FP32_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                       "moving_mean", "moving_var")


def convert_block(block, target_dtype="bfloat16", target_dtype_ops=None,
                  fp32_ops=None, widest_dtype_ops=None, excluded_ops=None):
    """Convert a block to mixed precision, in place, and return it.

    Casts every parameter whose name does not end in one of
    ``_KEEP_FP32_SUFFIXES`` to ``target_dtype`` (the Parameter objects
    stay, so a trainer built on them keeps working) and attaches a
    :class:`CastPolicy`, honored per op on every forward through the
    block."""
    dtype = _dtype(target_dtype)
    policy = CastPolicy(target_dtype, target_dtype_ops=target_dtype_ops,
                        fp32_ops=fp32_ops, widest_dtype_ops=widest_dtype_ops,
                        excluded_ops=excluded_ops)
    with torch.no_grad():
        for name, p in block.collect_params().items():
            if not name.endswith(_KEEP_FP32_SUFFIXES):
                p.data = p.data.to(dtype)
    block._amp_policy = policy
    return block
