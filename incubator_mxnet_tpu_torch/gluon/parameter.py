"""Parameters (counterpart of ``incubator_mxnet_tpu/gluon/parameter.py``).

The port's parameters are PyTorch's own ``nn.Parameter`` s (and
``UninitializedParameter`` s until a deferred layer's first forward);
there is no Parameter class of its own.  This module gives every
``nn.Parameter`` the JAX package's per-parameter attributes:

- ``grad_req``: ``"write"`` (the default), ``"add"`` or ``"null"``.
  ``"null"`` turns ``requires_grad`` off and drops ``.grad``; setting
  ``"write"`` or ``"add"`` again turns it on.  A parameter whose
  ``requires_grad`` is off reads as ``"null"``.  ``autograd.backward``
  and the ``Trainer`` honour it;
- ``lr_mult`` and ``wd_mult`` (1.0 by default), which the optimizer
  reads through its ``param_dict``.

They live in the parameter's ``__dict__``, so a deferred parameter keeps
them when it is materialised.  ``copy.deepcopy`` of a parameter keeps
``requires_grad`` (so ``"null"``) but not the others, nor the hook
through which ``autograd.backward`` honours ``"write"``: PyTorch's
``Parameter.__deepcopy__`` copies neither.  Initialising a parameter,
collecting it into a :class:`ParameterDict` or setting its request
gives it the hook (``autograd.track``).

Where the port differs on purpose: MXNet's ``Parameter.data()`` and
``.grad()`` are methods, while ``torch.Tensor.data`` and ``.grad`` are
attributes that PyTorch itself relies on, so the port keeps the
attributes and has neither method.

:class:`ParameterDict` is what ``HybridBlock.collect_params()`` returns:
a ``dict`` of ``{structural name: parameter}`` with the JAX package's
bulk methods.  :class:`Constant` makes a parameter that holds a fixed
value and is never trained.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import initializer as init_mod
from .. import ndarray as nd
from .. import random as random_mod
from ..autograd import GRAD_REQS, grad_req_of, track
from ..context import resolve_device

__all__ = ["ParameterDict", "Constant", "set_grad_req", "fill"]


def set_grad_req(p, req):
    """Set parameter ``p``'s ``grad_req`` (what ``p.grad_req = req``
    does)."""
    if req not in GRAD_REQS:
        raise ValueError(f"grad_req {req!r} is not one of {GRAD_REQS}")
    if isinstance(p, Constant) and req != "null":
        raise ValueError("a Constant takes no gradient")
    p.__dict__["grad_req"] = req
    p.requires_grad = req != "null"     # requires_grad_ refuses a deferred p
    if req == "null":
        p.grad = None
    track(p)


def _attribute(key):
    def get(self):
        return self.__dict__.get(key, 1.0)

    def set_(self, value):
        self.__dict__[key] = value
    return property(get, set_)


def _install():
    """Give ``nn.Parameter`` the ``grad_req``, ``lr_mult`` and ``wd_mult``
    attributes (once)."""
    if "grad_req" in vars(nn.Parameter):
        return
    nn.Parameter.grad_req = property(grad_req_of, set_grad_req)
    nn.Parameter.lr_mult = _attribute("lr_mult")
    nn.Parameter.wd_mult = _attribute("wd_mult")


_install()


class Constant(nn.Parameter):
    """``Constant(name, value)`` or ``Constant(value)``: an
    ``nn.Parameter`` holding ``value`` with ``grad_req "null"``; block
    initialisation leaves it as it is.  A float64 numpy value becomes
    float32, as the JAX package's arrays are."""

    def __new__(cls, name, value=None):
        if value is None:
            value = name
        if isinstance(value, torch.Tensor):
            data = value.detach().clone()
        else:
            arr = np.asarray(value)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            data = torch.tensor(arr)
        p = nn.Parameter.__new__(cls, data, requires_grad=False)
        p.__dict__["grad_req"] = "null"
        return p

    def __deepcopy__(self, memo):
        # nn.Parameter's would call Constant(data, requires_grad)
        if id(self) not in memo:
            memo[id(self)] = Constant(self.data)
        return memo[id(self)]


def _move(p, device):
    if p.device != device:
        with torch.no_grad():
            p.data = p.data.to(device)
            if p.grad is not None:
                p.grad = p.grad.to(device)


class ParameterDict(dict):
    """``{structural name: parameter}`` in the JAX package's order, with
    its bulk methods.  Built by ``HybridBlock.collect_params()``, which
    passes ``block`` so that :meth:`initialize` and :meth:`load` reach
    each parameter's layer (its initializer, its deferred shape)."""

    def __init__(self, items=(), block=None):
        super().__init__(items)
        self._block = block
        for p in self.values():
            track(p)

    def _slots(self):
        """``{name: (module, attribute)}`` of the parameters this dict
        holds under their block's names."""
        if self._block is None:
            return {}
        slots = self._block._named_slots()
        return {k: slots[k] for k in self if k in slots}

    def get(self, name, default=None, **kwargs):
        """The parameter ``name``; if there is none and ``kwargs`` are
        given (``shape``, ``dtype``, ``init``, ``grad_req``, ``lr_mult``,
        ``wd_mult``), a new one made from them and added, which
        :meth:`initialize` fills; else ``default``, as ``dict.get``."""
        if name in self:
            return self[name]
        if not kwargs:
            return default
        from .block import as_dtype
        shape = kwargs.pop("shape")
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dtype = as_dtype(kwargs.pop("dtype", "float32"))
        init = kwargs.pop("init", None)
        if 0 in shape:
            p = UninitializedParameter(dtype=dtype)
        else:
            p = nn.Parameter(torch.empty(shape, dtype=dtype))
        if init is not None:
            p.__dict__["init"] = init_mod.create(init)
        for key, value in kwargs.items():
            setattr(p, key, value)
        self[name] = p
        return p

    def zero_grad(self):
        """Set the gradient of every parameter that takes one to zeros,
        in place (a gradient that carries a graph is detached first)."""
        with torch.no_grad():
            for p in self.values():
                if grad_req_of(p) == "null" or p.grad is None:
                    continue
                if p.grad.grad_fn is not None:
                    p.grad = p.grad.detach()
                p.grad.zero_()

    def setattr(self, name, value):
        """``setattr(p, name, value)`` on every parameter, e.g.
        ``setattr("grad_req", "null")`` or ``setattr("wd_mult", 0.0)``."""
        for p in self.values():
            setattr(p, name, value)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Fill every parameter as ``HybridBlock.initialize`` does (``init``
        overrides each one's own initializer, ``Uniform()`` where there
        is neither; draws from ``generator``, else from
        ``random.generator()``) and move it to ``ctx`` (``cuda:0``
        unless given).  A deferred parameter records its initializer
        and is filled at its layer's first forward; a :class:`Constant`
        keeps its value.  As with ``HybridBlock.initialize``, a second
        call fills again (``force_reinit`` is taken and not read)."""
        device = resolve_device(ctx)
        slots = self._slots()
        fill([(*slots.get(name, (None, name)), p)
              for name, p in self.items()], init, generator)
        for p in self.values():
            _move(p, device)

    def reset_ctx(self, ctx):
        """Move every parameter (and its gradient) to ``ctx``."""
        device = resolve_device(ctx)
        for p in self.values():
            _move(p, device)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` in the ``.params``
        format, under its name less ``strip_prefix``."""
        arrays = {}
        for name, p in self.items():
            if isinstance(p, UninitializedParameter):
                raise RuntimeError(f"parameter {name} has no shape yet: run "
                                   "a forward before saving")
            key = name[len(strip_prefix):] if name.startswith(
                strip_prefix) else name
            arrays[key] = p.detach()
        nd.save(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a ``.params`` file (names get ``restore_prefix`` in front)
        into the parameters, each in its own dtype and on its own device
        (a deferred one takes the file's shape, on ``ctx`` if given).  A
        parameter missing from the file raises ``KeyError`` unless
        ``allow_missing``, a name the dict lacks unless
        ``ignore_extra``; a shape that differs raises ``ValueError``.
        Everything is checked before anything is written."""
        loaded = nd.load(filename)
        if isinstance(loaded, list):
            raise ValueError("expected dict-of-arrays params file")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        missing = [n for n in self if n not in loaded]
        if missing and not allow_missing:
            raise KeyError(f"parameter {missing[0]} missing in {filename}")
        extra = sorted(set(loaded) - set(self))
        if extra and not ignore_extra:
            raise KeyError(f"extra params in file: {extra}")
        slots = self._slots()
        for name, p in self.items():
            if name not in loaded:
                continue
            value = loaded[name]
            if value is None:
                raise ValueError(f"{name}: the file holds no value")
            if isinstance(p, UninitializedParameter):
                mod, attr = slots.get(name, (None, None))
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
            for name, p in self.items():
                if name not in loaded:
                    continue
                value = loaded[name]
                if isinstance(p, UninitializedParameter):
                    p.materialize(tuple(value.shape), device=device)
                    mod, attr = slots.get(name, (None, None))
                    getattr(mod, "_pending", {}).pop(attr, None)
                    track(p)
                p.copy_(value)


def fill(entries, init, generator):
    """Fill each ``(module, attribute, parameter)`` of ``entries`` in
    order: ``init`` if given, else the layer's own initializer for that
    attribute (for a parameter without a layer, the one it was made
    with), else ``Uniform()``, drawing from ``generator`` (else from
    ``random.generator()``).  A deferred parameter records the
    initializer for its layer's first forward; a :class:`Constant` is
    left as it is."""
    default = init_mod.create(init)
    if generator is None:
        generator = random_mod.generator()
    for mod, attr, p in entries:
        if isinstance(p, Constant):
            continue
        own = (getattr(mod, "_inits", {}).get(attr) if mod is not None
               else p.__dict__.get("init"))
        ini = default or own or init_mod.Uniform()
        if isinstance(p, UninitializedParameter):
            if mod is None:
                raise RuntimeError(f"parameter {attr} has no shape and no "
                                   "layer to give it one")
            mod._pending[attr] = (ini, generator)
        else:
            ini(attr, p.data, generator)
            track(p)
