"""Recording, train mode, gradients (counterpart of
``incubator_mxnet_tpu/autograd.py``).

The JAX package keeps its own tape; the port records with
``torch.autograd``.  :func:`record` enters ``torch.enable_grad()`` and
:func:`pause` ``torch.no_grad()``; :func:`set_recording` switches both.

:func:`backward` honours each leaf's ``grad_req``, as the JAX package's
does: ``"write"`` overwrites the ``.grad`` of every leaf the backward
reaches (leaves it does not reach keep theirs), ``"add"`` adds to it,
``"null"`` gets nothing (its ``requires_grad`` is off).  It does so
through a hook that runs before PyTorch accumulates a leaf's gradient
(:func:`track`), so a backward costs no walk of its graph.  The leaves
that carry it: the parameters of port blocks (from ``initialize``, a
deferred one when it takes its shape), every parameter of a
``ParameterDict`` (so of ``collect_params()``), and any tensor given a
request by ``p.grad_req = ...`` or :func:`mark_variables`.  A tensor
without it (one that PyTorch code made to require a gradient)
accumulates, as in PyTorch.  A head without a head gradient gets ones
of its own shape (PyTorch asks for one explicitly unless the head is a
scalar).  Code that calls PyTorch's own ``.backward()`` keeps PyTorch's
semantics: it adds into every ``.grad``, and the trainer clears the
``"write"`` ones after each update.

:func:`grad` returns gradients and leaves every ``.grad`` as it was.
With ``create_graph=True`` both give gradients that can be
differentiated again; through a hand-written kernel that works on the
CPU and raises on the card (``ops/_higher_order.py``).  :class:`Function`
is a differentiable function written by the user on tensors.

Train mode is one thread-local switch, as in the JAX package: it is on
inside ``record()`` (unless ``train_mode=False``) and inside
:func:`train_mode`, off elsewhere.  ``Dropout`` follows it alone —
``nn.Module.train()``/``eval()`` do not change what a port layer
computes.  Recording is a second switch, read by :func:`is_recording`;
outside :func:`record`, :func:`pause` and :func:`set_recording`,
PyTorch's own grad mode is left as the caller set it.
"""
from __future__ import annotations

import threading
import warnings
import weakref
from contextlib import contextmanager

import torch
from torch.nn.parameter import UninitializedParameter

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "get_symbol", "Function",
           "grad_req_of", "track"]

GRAD_REQS = ("write", "add", "null")


class _State(threading.local):
    recording = False
    training = False
    # PyTorch's grad mode before set_recording(True) switched it on
    grad_before = None


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_training(train: bool) -> bool:
    """Set train mode for this thread; returns the previous value."""
    prev, _state.training = _state.training, bool(train)
    return prev


def set_recording(is_rec: bool) -> bool:
    """Start or stop recording for this thread; returns the previous
    value.  Switching on enables PyTorch's grad mode; switching off
    gives back the mode it had before, or disables it inside
    :func:`record`."""
    prev, is_rec = _state.recording, bool(is_rec)
    if is_rec != prev:
        if is_rec:
            _state.grad_before = torch.is_grad_enabled()
            torch.set_grad_enabled(True)
        else:
            before, _state.grad_before = _state.grad_before, None
            torch.set_grad_enabled(bool(before))
        _state.recording = is_rec
    return prev


@contextmanager
def _scope(recording, training, grad_mode):
    prev = _state.recording, _state.training
    if recording is not None:
        _state.recording = recording
    if training is not None:
        _state.training = training
    try:
        if grad_mode is None:
            yield
        else:
            with grad_mode():
                yield
    finally:
        _state.recording, _state.training = prev


def record(train_mode=True):
    """``with autograd.record():`` record operations for
    :func:`backward`, in train mode unless ``train_mode=False``."""
    return _scope(True, train_mode, torch.enable_grad)


def pause(train_mode=False):
    """``with autograd.pause():`` record nothing, in predict mode unless
    ``train_mode=True``."""
    return _scope(False, train_mode, torch.no_grad)


def train_mode():
    return _scope(None, True, None)


def predict_mode():
    return _scope(None, False, None)


def grad_req_of(t) -> str:
    """``"null"`` for a tensor that requires no gradient, else the
    request it was given (``"write"`` or ``"add"``), ``"write"`` by
    default."""
    if not t.requires_grad:
        return "null"
    req = t.__dict__.get("grad_req", "write")
    return "write" if req == "null" else req    # requires_grad set again


class _Backwards:
    """The port's backwards in flight, for the leaves' hooks.  One count
    for the process, not per thread: a backward on the card runs the
    hooks on the autograd engine's device thread.  ``fix`` collects the
    leaves whose gradient the backward completes when it ends."""
    depth = 0
    fix = []


class _GradReqHook:
    """Runs before PyTorch accumulates a leaf's gradient.  Inside
    :func:`backward` it drops a ``"write"`` leaf's old gradient, and
    notes a ``"write"`` leaf that nothing flowed into (it gets zeros)
    and a leaf with a caller's buffer (:func:`mark_variables`)."""
    __slots__ = ("ref",)

    def __init__(self, t):
        self.ref = weakref.ref(t)

    def __call__(self, grad):
        if not _Backwards.depth:
            return
        t = self.ref()
        write = grad_req_of(t) == "write"
        if write:
            t.grad = None
        if (write and grad is None) or "grad_buffer" in t.__dict__:
            _Backwards.fix.append(t)


def track(t):
    """Give leaf ``t`` the hook through which :func:`backward` honours
    its ``grad_req`` (once).  A tensor that takes no gradient yet (a
    deferred or ``"null"`` parameter) gets it when it takes one."""
    if not t.requires_grad or isinstance(t, UninitializedParameter):
        return
    hooks = t._backward_hooks
    if hooks and any(type(h) is _GradReqHook for h in hooks.values()):
        return
    t.register_hook(_GradReqHook(t))


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each tensor of ``variables`` a leaf whose gradient
    :func:`backward` writes (``"write"``) or adds (``"add"``) into the
    caller's tensor of ``gradients`` in place; ``"null"`` turns its
    gradient off."""
    if isinstance(variables, torch.Tensor):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in GRAD_REQS:
            raise ValueError(f"grad_req {req!r} is not one of {GRAD_REQS}")
        if not var.is_leaf:
            raise ValueError("mark_variables: a variable must be a leaf "
                             "tensor (detach it first)")
        var.requires_grad_(req != "null")
        var.__dict__["grad_req"] = req
        var.__dict__["grad_buffer"] = g
        var.grad = g if req != "null" else None
        track(var)


def _heads(heads, head_grads):
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    return heads, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` (a tensor or a list) into the ``.grad`` of
    every leaf they reach, as each leaf's ``grad_req`` asks; a head
    without a head gradient gets ones.  With ``create_graph=True`` the
    gradients carry their graph (and the graph is kept), so a ``.grad``
    can be differentiated again.  The backward runs in train mode
    unless ``train_mode=False`` (it matters to what ``create_graph``
    records)."""
    heads, grads = _heads(heads, head_grads)
    _Backwards.depth += 1
    try:
        with _scope(None, train_mode, None):
            torch.autograd.backward(heads, grads,
                                    retain_graph=retain_graph or create_graph,
                                    create_graph=create_graph)
    finally:
        _Backwards.depth -= 1
        fix, _Backwards.fix = _Backwards.fix, []
    for v in fix:
        if v.grad is None:          # reached, but nothing flowed into it
            v.grad = torch.zeros_like(v)
        buf = v.__dict__.get("grad_buffer")
        if buf is not None and v.grad is not buf:
            with torch.no_grad():
                buf.copy_(v.grad)
            if not create_graph:
                v.grad = buf


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (a tensor, or
    a list → a list), returned; every ``.grad`` is left as it was.  A
    variable the heads do not reach gets zeros.  With
    ``create_graph=True`` the returned gradients carry their graph, so
    they can be differentiated again; the graph is kept unless
    ``retain_graph`` says otherwise."""
    single = isinstance(variables, torch.Tensor)
    variables = [variables] if single else list(variables)
    heads, grads = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    with _scope(None, train_mode, None):
        out = torch.autograd.grad(heads, variables, grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [torch.zeros_like(v) if g is None else g
           for v, g in zip(variables, out)]
    return out[0] if single else out


def get_symbol(x):
    """Not ported yet: the port has no symbol API (ROADMAP §A item 12);
    the JAX package's tape has no symbol identity either and raises."""
    raise NotImplementedError(
        "get_symbol needs the symbol API, which is not ported yet "
        "(ROADMAP §A item 12)")


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s forward and backward for PyTorch's
    autograd: ``apply(func, *inputs)``."""

    @staticmethod
    def forward(ctx, func, *inputs):
        ctx.func = func
        ctx.tensor_at = [isinstance(x, torch.Tensor) for x in inputs]
        with pause():
            outputs = func.forward(*inputs)
        ctx.tuple_out = isinstance(outputs, (list, tuple))
        return tuple(outputs) if ctx.tuple_out else outputs

    @staticmethod
    def backward(ctx, *out_grads):
        if torch.is_grad_enabled():
            warnings.warn(
                f"create_graph: {type(ctx.func).__name__} is a custom "
                "Function; its backward is not recorded, so a higher-order "
                "derivative through it misses it", stacklevel=2)
        with pause():
            in_grads = ctx.func.backward(*out_grads)
        if not isinstance(in_grads, (list, tuple)):
            in_grads = (in_grads,)
        it = iter(in_grads)
        return (None,) + tuple(next(it, None) if t else None
                               for t in ctx.tensor_at)


class Function:
    """A differentiable function written by the user (counterpart of the
    JAX package's ``autograd.Function``).  Subclass it and write
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` on
    tensors; ``backward`` returns one gradient per tensor input.  Keep
    what the backward needs with :meth:`save_for_backward` and read it
    back from :attr:`saved_tensors`.  Calling the instance runs
    ``forward`` under :func:`pause` and, while PyTorch records,
    records ``backward`` as the gradient of its outputs."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        return _Bridge.apply(self, *inputs)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
