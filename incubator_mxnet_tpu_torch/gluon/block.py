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

:meth:`HybridBlock.hybridize` makes the outermost block's forward one
CUDA graph per call signature (``_cached_op.py``), the JAX package's
``CachedOp``: a call on CUDA tensors that records no gradient replays
it.  Under ``autograd.record()``, on CPU tensors, while a parameter is
still deferred, or inside another capture, the block runs eagerly.  The
JAX package differentiates its compiled program (a ``jax.vjp``); the
port's whole-step graph with a backward is ``FusedTrainStep``
(ROADMAP §C).  The block's own pre- and forward hooks run around each
replay; its children's run only on the calls that run eagerly (the
first call of a signature: its warm-up and its capture), as the JAX
ones run only while the JAX package traces.

``collect_params()`` returns a ``ParameterDict`` (``parameter.py``).
Forward hooks follow the JAX package: ``hook(block, args)`` before and
``hook(block, args, out)`` after the forward, in the order registered;
what a hook returns is ignored (a PyTorch hook that returns something
would replace the input or the output).  :meth:`HybridBlock.summary`
prints the JAX package's table of layers, output shapes and parameter
counts.
"""
from __future__ import annotations

import re

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import _remat
from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from ..amp import amp as amp_mod
from ..autograd import track
from ..context import resolve_device
from ._cached_op import CachedOp
from .parameter import ParameterDict, fill

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
    hybridized graph; the port runs eagerly, so it applies it at once,
    except in a rematerialized region's recompute (``FusedTrainStep(
    remat=...)``), which must not apply it a second time."""
    if _remat.recomputing():
        return
    with torch.no_grad():
        param.copy_(new_value)


class HybridBlock(nn.Module):
    """Base of every layer and model.  ``forward`` runs eagerly unless the
    block is hybridized (:meth:`hybridize`).  What a layer computes
    depends on ``autograd.is_training()`` (dropout is on only inside
    ``autograd.record()``), as in the JAX package, and not on
    ``nn.Module.train()``/``eval()``.  A block converted by
    ``amp.convert_block`` runs its forward under its AMP policy (a
    capture included)."""

    def __init__(self):
        super().__init__()
        self._inits: dict[str, init_mod.Initializer | None] = {}
        # deferred parameters: their shape with 0 where the input decides,
        # and the (initializer, generator) that initialize() recorded
        self._deferred: dict[str, tuple] = {}
        self._pending: dict[str, tuple] = {}
        self._active = False
        self._flags: dict = {}
        self._cached_op: CachedOp | None = None

    def __call__(self, *args, **kwargs):
        policy = getattr(self, "_amp_policy", None)
        if policy is None:
            return self._call(args, kwargs)
        with amp_mod.policy_scope(policy):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        if self._active and not kwargs and self._graphable(args):
            op = self._get_cached_op()
            state = op.state()
            if state is not None:         # no parameter deferred
                for hook in list(self._forward_pre_hooks.values()):
                    hook(self, args)
                out = op(args, state)
                for hook in list(self._forward_hooks.values()):
                    hook(self, args, out)
                return out
        return super().__call__(*args, **kwargs)

    @staticmethod
    def _graphable(args):
        """Whether this call may replay (or capture) a graph: CUDA tensors
        in, no gradient recorded, no capture running already."""
        if not args or not all(isinstance(a, torch.Tensor)
                               and a.device.type == "cuda" for a in args):
            return False
        if autograd.is_recording() or (torch.is_grad_enabled() and any(
                a.requires_grad for a in args)):
            return False
        return not torch.cuda.is_current_stream_capturing()

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Compile the forward: with ``active`` (the default) each call on
        CUDA tensors that records no gradient runs one CUDA graph per
        signature (see the module docstring); ``active=False`` turns it
        off.  Only the outermost block compiles: every block under it
        is deactivated.  A new call drops the graphs captured so far.
        ``static_alloc`` and ``static_shape`` are recorded, as the JAX
        package takes them; a graph holds its buffers already, so they
        change nothing else."""
        self._active = bool(active)
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape}
        self._cached_op = None
        for mod in self.modules():
            if mod is not self and isinstance(mod, HybridBlock):
                mod._active = False
                mod._cached_op = None
        return self

    def _get_cached_op(self) -> CachedOp:
        if self._cached_op is None:
            self._cached_op = CachedOp(self, **self._flags)
        return self._cached_op

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
        track(p)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def collect_params(self, select=None) -> ParameterDict:
        """``{structural name: parameter}`` of this block and its
        children, in the JAX package's order, as a ``ParameterDict``;
        ``select`` is a regex the names must match."""
        out = self.named_parameters()
        if select is not None:
            pat = re.compile(select)
            out = ((k, v) for k, v in out if pat.match(k))
        return ParameterDict(out, block=self)

    def initialize(self, init=None, device=None, generator=None):
        """Fill every parameter, then move the block to ``device``
        (``cuda:0`` unless given; raises without CUDA).  As in the JAX
        package, ``init`` overrides each parameter's own initializer,
        and a parameter with neither gets ``Uniform()``.  Draws come
        from ``generator`` in a fixed order, so a seeded generator
        gives the same weights every time; without one, they come from
        ``random.generator()``, which ``random.seed`` seeds.  A deferred
        parameter records its initializer and generator here, and is
        filled at the layer's first forward.  A ``Constant`` keeps its
        value."""
        device = resolve_device(device)
        fill([(mod, name, p) for mod in self.modules()
              for name, p in mod.named_parameters(recurse=False)],
             init, generator)
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
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra)

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

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, args)`` before every forward, after the
        hooks registered before it; its return value is ignored.
        Returns a handle whose ``detach()`` removes it.  PyTorch's own
        hook, whose return value replaces the input, stays reachable as
        ``nn.Module.register_forward_pre_hook(block, ...)``."""

        def run(block, args):
            hook(block, args)
        return _HookHandle(super().register_forward_pre_hook(run))

    def register_forward_hook(self, hook):
        """Run ``hook(block, args, out)`` after every forward, after the
        hooks registered before it; its return value is ignored.
        Returns a handle whose ``detach()`` removes it."""

        def run(block, args, out):
            hook(block, args, out)
        return _HookHandle(super().register_forward_hook(run))

    def summary(self, *inputs):
        """Run a forward on ``inputs`` and print, for each block as its
        forward ends, its name, the shapes of its tensor outputs and the
        count of its own parameters, then the block's total: the JAX
        package's table."""
        rows, handles = [], []

        def add_hooks(block, prefix):
            def hook(blk, args, out):
                outs = out if isinstance(out, (list, tuple)) else [out]
                shapes = [tuple(o.shape) for o in outs
                          if isinstance(o, torch.Tensor)]
                own = sum(p.numel() for p in blk.parameters(recurse=False)
                          if not isinstance(p, UninitializedParameter))
                rows.append((prefix or type(blk).__name__, shapes, own))
            handles.append(block.register_forward_hook(hook))
            for name, child in block.named_children():
                add_hooks(child, f"{prefix}.{name}" if prefix else name)

        add_hooks(self, "")
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        print(f"{'Layer':<40} {'Output shape':<24} {'Params':>12}")
        print("-" * 78)
        for name, shapes, own in rows:
            print(f"{name:<40} {str(shapes):<24} {own:>12}")
        total = sum(p.numel() for p in self.collect_params().values()
                    if not isinstance(p, UninitializedParameter))
        print("-" * 78)
        print(f"Total params: {total}")


class _HookHandle:
    """A registered hook: ``detach()`` (or PyTorch's ``remove()``) takes
    it off its block."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach
