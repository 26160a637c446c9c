"""Recording and train mode (counterpart of
``incubator_mxnet_tpu/autograd.py``).

The JAX package keeps its own tape; the port records with
``torch.autograd``.  :func:`record` enters ``torch.enable_grad()`` and
:func:`pause` ``torch.no_grad()``; :func:`backward` is
``torch.autograd.backward`` with the JAX package's default head
gradient (ones).  Gradients land in each parameter's ``.grad``, and
PyTorch adds to a ``.grad`` that is already there: the trainer clears
them after each update, which gives the JAX package's ``grad_req
"write"`` across steps (see ``gluon/trainer.py``).

Train mode is one thread-local switch, as in the JAX package: it is on
inside ``record()`` (unless ``train_mode=False``) and inside
:func:`train_mode`, off elsewhere.  ``Dropout`` follows it alone —
``nn.Module.train()``/``eval()`` do not change what a port layer
computes.  Recording is a second switch, read by :func:`is_recording`;
outside :func:`record` and :func:`pause`, PyTorch's own grad mode is
left as the caller set it.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_training", "backward"]


class _State(threading.local):
    recording = False
    training = False


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_training(train: bool) -> bool:
    """Set train mode for this thread; returns the previous value."""
    prev, _state.training = _state.training, bool(train)
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


def backward(heads, head_grads=None, retain_graph=False):
    """Gradients of ``heads`` (a tensor or a list) into the ``.grad`` of
    every leaf that requires one.  A head without a head gradient gets
    ones of its own shape, as in the JAX package (PyTorch asks for one
    explicitly unless the head is a scalar)."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
