"""Blocks (counterpart of ``incubator_mxnet_tpu/gluon/block.py``).

:class:`HybridBlock` is an ``nn.Module``.  Parameters are module
attributes, so ``collect_params()`` gives the JAX package's structural
names (``encoder.layer0.attention.qkv.weight``, ...) and a
``state_dict`` has the same keys.  Every shape is known at
construction: the port has no deferred initialisation.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from .. import initializer as init_mod
from ..context import resolve_device

__all__ = ["HybridBlock", "as_dtype"]


def as_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``torch.float32`` → ``torch.float32``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return out


class HybridBlock(nn.Module):
    """Base of every layer and model.  ``forward`` runs eagerly; a module
    in ``train()`` mode applies dropout, one in ``eval()`` mode does not
    (the JAX package's ``autograd.is_training()``)."""

    def __init__(self):
        super().__init__()
        self._inits: dict[str, init_mod.Initializer | None] = {}

    def new_param(self, name, shape, init=None, dtype="float32",
                  requires_grad=True):
        """Register parameter ``name`` of ``shape`` (contents unset until
        :meth:`initialize`) with its own initializer."""
        p = nn.Parameter(torch.empty(shape, dtype=as_dtype(dtype)),
                         requires_grad=requires_grad)
        self.register_parameter(name, p)
        self._inits[name] = init_mod.create(init)
        return p

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def collect_params(self, select=None) -> dict[str, nn.Parameter]:
        """``{structural name: parameter}`` of this block and its
        children, in the JAX package's order; ``select`` is a regex
        the names must match."""
        out = dict(self.named_parameters())
        if select is not None:
            pat = re.compile(select)
            out = {k: v for k, v in out.items() if pat.match(k)}
        return out

    def initialize(self, init=None, device=None, generator=None):
        """Fill every parameter, then move the block to ``device``
        (``cuda:0`` unless given; raises without CUDA).  As in the JAX
        package, ``init`` overrides each parameter's own initializer,
        and a parameter with neither gets ``Uniform()``.  Draws come
        from ``generator`` in a fixed order, so a seeded generator
        gives the same weights every time."""
        device = resolve_device(device)
        default = init_mod.create(init)
        for mod in self.modules():
            own = getattr(mod, "_inits", {})
            for name, p in mod.named_parameters(recurse=False):
                ini = default or own.get(name) or init_mod.Uniform()
                ini(name, p.data, generator)
        return self.to(device)

    def hybridize(self, active=True, **kwargs):
        """No-op, kept so code written for the JAX package runs: the
        port runs eagerly, and the JAX package's whole-graph compile
        has no counterpart here."""
        return self
