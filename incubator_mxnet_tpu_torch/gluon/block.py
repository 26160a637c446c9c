"""Blocks (counterpart of ``incubator_mxnet_tpu/gluon/block.py``).

:class:`HybridBlock` is an ``nn.Module``.  Parameters are module
attributes, so ``collect_params()`` gives the JAX package's structural
names (``encoder.layer0.attention.qkv.weight``, ...) and a
``state_dict`` has the same keys.

A parameter whose shape has a 0 (``Dense`` without ``in_units``,
``Conv2D`` without ``in_channels``) is created as PyTorch's
``UninitializedParameter``, the idiom of its ``LazyModuleMixin``: the
layer's first forward materialises it from the input's shape and fills
it with the initializer and generator that :meth:`initialize`
recorded, as the JAX package's deferred initialisation does
(``gluon/parameter.py``, ``_finish_deferred_init``).  It is the same
object before and after, so a ``Trainer`` built from
``collect_params()`` before the first batch holds the trained tensors.

``save_parameters``/``load_parameters`` write and read the ``.params``
format (``ndarray/params_io.py``) under the structural names, so a file
written by the JAX package's block loads here and the reverse.
"""
from __future__ import annotations

import re

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import initializer as init_mod
from .. import ndarray as nd
from .. import random as random_mod
from ..amp import amp as amp_mod
from ..context import resolve_device

__all__ = ["HybridBlock", "as_dtype", "register_state_update"]


def as_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``torch.float32`` → ``torch.float32``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return out


def register_state_update(param, new_value):
    """BatchNorm's moving-statistic update: copy ``new_value`` into
    ``param`` in place, under ``torch.no_grad()``, so the update is not
    recorded.  The JAX package defers the update while it traces a
    hybridized graph; the port runs eagerly, so it always applies it at
    once."""
    with torch.no_grad():
        param.copy_(new_value)


class HybridBlock(nn.Module):
    """Base of every layer and model.  ``forward`` runs eagerly.  What a
    layer computes depends on ``autograd.is_training()`` (dropout is on
    only inside ``autograd.record()``), as in the JAX package, and not on
    ``nn.Module.train()``/``eval()``.  A block converted by
    ``amp.convert_block`` runs its forward under its AMP policy."""

    def __init__(self):
        super().__init__()
        self._inits: dict[str, init_mod.Initializer | None] = {}
        # deferred parameters: their shape with 0 where the input decides,
        # and the (initializer, generator) that initialize() recorded
        self._deferred: dict[str, tuple] = {}
        self._pending: dict[str, tuple] = {}

    def __call__(self, *args, **kwargs):
        policy = getattr(self, "_amp_policy", None)
        if policy is None:
            return super().__call__(*args, **kwargs)
        with amp_mod.policy_scope(policy):
            return super().__call__(*args, **kwargs)

    def new_param(self, name, shape, init=None, dtype="float32",
                  requires_grad=True):
        """Register parameter ``name`` of ``shape`` (contents unset until
        :meth:`initialize`) with its own initializer.  A 0 in ``shape``
        defers it: see :meth:`finish_deferred_init`."""
        if 0 in shape:
            p = UninitializedParameter(requires_grad=requires_grad,
                                       dtype=as_dtype(dtype))
            self._deferred[name] = tuple(shape)
        else:
            p = nn.Parameter(torch.empty(shape, dtype=as_dtype(dtype)),
                             requires_grad=requires_grad)
        self.register_parameter(name, p)
        self._inits[name] = init_mod.create(init)
        return p

    def finish_deferred_init(self, name, shape):
        """Materialise the deferred parameter ``name`` at ``shape``, in
        place, on the device :meth:`initialize` moved it to, and fill it
        as :meth:`initialize` said.  Does nothing to a parameter that
        has its shape already."""
        p = getattr(self, name)
        if not isinstance(p, UninitializedParameter):
            return
        if name not in self._pending:
            raise RuntimeError(f"parameter {name} of {type(self).__name__} "
                               "is not initialized: call initialize() "
                               "before the first forward")
        template = self._deferred[name]
        if len(shape) != len(template) or any(
                t and t != s for t, s in zip(template, shape)):
            raise ValueError(f"{name}: the input gives shape {tuple(shape)}, "
                             f"the layer was built for {template}")
        ini, generator = self._pending.pop(name)
        p.materialize(tuple(shape))
        ini(name, p.data, generator)

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
        gives the same weights every time; without one, they come from
        ``random.generator()``, which ``random.seed`` seeds.  A deferred
        parameter records its initializer and generator here, and is
        filled at the layer's first forward."""
        device = resolve_device(device)
        default = init_mod.create(init)
        if generator is None:
            generator = random_mod.generator()
        for mod in self.modules():
            own = getattr(mod, "_inits", {})
            for name, p in mod.named_parameters(recurse=False):
                ini = default or own.get(name) or init_mod.Uniform()
                if isinstance(p, UninitializedParameter):
                    mod._pending[name] = (ini, generator)
                else:
                    ini(name, p.data, generator)
        return self.to(device)

    def _named_slots(self):
        """``{structural name: (module, attribute name)}`` of every
        parameter, in ``collect_params()``'s order."""
        slots = {}
        for name in self.collect_params():
            prefix, _, attr = name.rpartition(".")
            slots[name] = (self.get_submodule(prefix), attr)
        return slots

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter to ``filename`` in the ``.params``
        format, under its structural name, in its dtype."""
        arrays = {}
        for name, p in self.collect_params().items():
            if isinstance(p, UninitializedParameter):
                raise RuntimeError(f"parameter {name} has no shape yet: run "
                                   "a forward before saving")
            arrays[name] = p.detach()
        nd.save(filename, arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file written by :meth:`save_parameters` or
        by the JAX package.  Each value is converted to its parameter's
        dtype and device (``dtype_source="current"``, what the JAX
        package does whatever it is given).  A deferred parameter takes
        the file's shape and is materialised on ``ctx`` (its own device
        without it).  A parameter missing from the file raises
        ``KeyError`` unless ``allow_missing``, a name the block lacks
        unless ``ignore_extra``; a shape that differs raises
        ``ValueError``.  Everything is checked before anything is
        written."""
        if cast_dtype and dtype_source != "current":
            raise NotImplementedError(
                f"dtype_source={dtype_source!r}: the port loads values in "
                "each parameter's current dtype, as the JAX package does")
        loaded = nd.load(filename)
        if isinstance(loaded, list):
            raise ValueError("expected dict-of-arrays params file")
        slots = self._named_slots()
        missing = [n for n in slots if n not in loaded]
        if missing and not allow_missing:
            raise KeyError(f"parameter {missing[0]} missing in {filename}")
        extra = sorted(set(loaded) - set(slots))
        if extra and not ignore_extra:
            raise KeyError(f"extra params in file: {extra}")
        for name, (mod, attr) in slots.items():
            if name not in loaded:
                continue
            p, value = getattr(mod, attr), loaded[name]
            if value is None:
                raise ValueError(f"{name}: the file holds no value")
            if isinstance(p, UninitializedParameter):
                want = getattr(mod, "_deferred", {}).get(
                    attr, (0,) * value.dim())
            else:
                want = tuple(p.shape)
            if len(want) != value.dim() or any(
                    w and w != v for w, v in zip(want, value.shape)):
                raise ValueError(f"{name}: the file's shape "
                                 f"{tuple(value.shape)}, the parameter's "
                                 f"{want}")
        device = None if ctx is None else resolve_device(ctx)
        with torch.no_grad():
            for name, (mod, attr) in slots.items():
                if name not in loaded:
                    continue
                p, value = getattr(mod, attr), loaded[name]
                if isinstance(p, UninitializedParameter):
                    p.materialize(tuple(value.shape), device=device)
                    getattr(mod, "_pending", {}).pop(attr, None)
                p.copy_(value)

    save_params = save_parameters
    load_params = load_parameters

    def cast(self, dtype):
        """Cast every parameter (and its gradient) to ``dtype`` in place:
        the parameter objects stay, so a trainer built on them keeps
        working.  A deferred parameter is materialised in ``dtype``."""
        dtype = as_dtype(dtype)
        with torch.no_grad():
            for p in self.collect_params().values():
                if isinstance(p, UninitializedParameter):
                    p.data = torch.empty(0, dtype=dtype, device=p.device)
                    continue
                p.data = p.data.to(dtype)
                if p.grad is not None:
                    p.grad = p.grad.to(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """No-op, kept so code written for the JAX package runs: the
        port runs eagerly, and the JAX package's whole-graph compile
        has no counterpart here."""
        return self
