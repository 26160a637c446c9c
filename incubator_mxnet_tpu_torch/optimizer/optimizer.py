"""Optimizers (subset of ``incubator_mxnet_tpu/optimizer/optimizer.py``).

The same base class, per-index state and update formulas as the JAX
package, for ``SGD`` and ``Adam``.  The JAX version rebinds immutable
arrays; here an update is plain PyTorch ops on the parameter and its
state tensors, written in place under ``torch.no_grad()``, so no second
copy of the weights or the state is made.  The gradient is never
written: the scaled (and clipped) gradient is a new tensor.

A Python hyper-parameter meets a tensor as JAX's weak-typed scalar does
(:func:`weak_scalar`): below float32 it is rounded to the tensor's dtype
first, so a bfloat16 update rounds where the JAX package's rounds.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "register",
           "create", "weak_scalar"]

_registry: dict[str, type] = {}


@functools.lru_cache(maxsize=256)  # bounded: Adam's coefficient moves
def _rounded(v, dtype):
    return torch.tensor(v, dtype=dtype).item()


def weak_scalar(v, t):
    """The Python number ``v`` as JAX meets tensor ``t`` with it: a
    weak-typed scalar takes t's dtype, so for a bfloat16 (or float16)
    tensor it is rounded to that dtype first (0.9 -> 0.8984375), where
    PyTorch would compute with it unrounded in float32.  Float32 and
    wider tensors get ``v`` unchanged.  Rounded on the host and cached:
    nothing touches the device, so a CUDA graph may capture the caller."""
    if t.dtype.is_floating_point and t.dtype.itemsize < 4:
        return _rounded(float(v), t.dtype)
    return v


def register(cls):
    """Register an optimizer class under its lower-cased name."""
    _registry[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer by name (``"sgd"``, ``"adam"``; any case)."""
    try:
        cls = _registry[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{sorted(_registry)}") from None
    return cls(**kwargs)


class Optimizer:
    """Base optimizer.  State is kept per parameter index, as in the JAX
    package (``create_state`` / ``update(index, weight, grad, state)``);
    the trainer drives it.  ``param_dict`` maps an index to its
    parameter, whose ``lr_mult``/``wd_mult`` attributes, where set,
    scale the learning rate and weight decay."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None):
        if lr_scheduler is not None:
            raise NotImplementedError("lr_scheduler is not ported yet (a "
                                      "later slice of the port)")
        if multi_precision:
            raise NotImplementedError("multi_precision is not ported yet "
                                      "(the AMP slice of the port)")
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: dict[int, int] = {}
        self.param_dict = param_dict or {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def _update_count(self, index):
        self._index_update_count[index] = (
            self._index_update_count.get(index, 0) + 1)
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _prep(self, index, weight, grad):
        """Count the update first (as the JAX package does), then return
        ``(lr, wd, rescaled and clipped gradient)``."""
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * weak_scalar(self.rescale_grad, grad)
        if self.clip_gradient is not None:
            g = g.clamp_(-self.clip_gradient, self.clip_gradient)
        return lr, wd, g

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.learning_rate})"


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: mom = momentum·mom -
    lr·(grad + wd·w); w += mom (without momentum, w -= lr·(grad +
    wd·w))."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        g = g.to(weight.dtype) + weak_scalar(wd, weight) * weight
        lr = weak_scalar(lr, g)
        if state is not None:
            state.mul_(weak_scalar(self.momentum, state)).sub_(lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with bias correction, as the JAX package writes it:
    m = β1·m + (1-β1)·g, v = β2·v + (1-β2)·g², then
    w -= lr·sqrt(1-β2^t)/(1-β1^t) · m/(sqrt(v) + ε), with g = grad +
    wd·w and t the parameter's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, v = state
        if wd:
            g = g + weak_scalar(wd, weight) * weight
        m.mul_(weak_scalar(self.beta1, m)).add_(
            weak_scalar(1 - self.beta1, g) * g)
        v.mul_(weak_scalar(self.beta2, v)).add_(
            weak_scalar(1 - self.beta2, g) * g * g)
        coef = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        weight.sub_(weak_scalar(coef, m) * m
                    / (v.sqrt() + weak_scalar(self.epsilon, v)))


class Updater:
    """Applies an optimizer by index, creating each index's state at its
    first update."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: dict = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
