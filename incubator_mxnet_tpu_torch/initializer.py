"""Weight initializers (subset of ``incubator_mxnet_tpu/initializer.py``).

An initializer fills a parameter in place from an explicit
``torch.Generator``.  Draws are made in float32 on the CPU and then
copied to the parameter's device and dtype, so one seed gives the same
weights on every device.  The two packages' random streams differ:
tests carry weights across with :func:`~.convert.params_from_jax`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "Xavier",
           "create"]


class Initializer:
    """Base initializer.  As in the JAX package, a name ending in
    ``gamma`` or ``running_var`` gets ones and one ending in ``beta``,
    ``bias`` or ``running_mean`` gets zeros, whatever the initializer;
    every other name is drawn by :meth:`_init_weight`."""

    def __call__(self, name, tensor, generator=None):
        if name.endswith(("gamma", "moving_var", "running_var")):
            values = torch.ones(tensor.shape)
        elif name.endswith(("beta", "bias", "moving_mean", "running_mean")):
            values = torch.zeros(tensor.shape)
        else:
            values = self._init_weight(tuple(tensor.shape), generator)
        with torch.no_grad():
            tensor.copy_(values)

    def _init_weight(self, shape, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, shape, generator):
        return torch.zeros(shape)


class One(Initializer):
    def _init_weight(self, shape, generator):
        return torch.ones(shape)


class Uniform(Initializer):
    """U(-scale, scale); the default weight initializer of ``Dense`` and
    ``Embedding``, as in the JAX package."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, generator):
        return torch.empty(shape).uniform_(-self.scale, self.scale,
                                           generator=generator)


class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, shape, generator):
        return torch.empty(shape).normal_(0.0, self.sigma,
                                          generator=generator)


class Xavier(Initializer):
    """Glorot initialisation, with the JAX package's fans: for a shape
    ``(d0, d1, *rest)``, fan_in = d1·prod(rest) and fan_out =
    d0·prod(rest) (a 1-D shape uses d0 for both); scale =
    sqrt(magnitude / factor), factor the mean of the fans ("avg"), or
    fan_in ("in") or fan_out ("out"); draws U(-scale, scale)
    ("uniform") or N(0, scale²) ("gaussian").  The default weight
    initializer of ``Conv2D``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, shape, generator):
        if len(shape) < 2:
            fan_in = fan_out = shape[0]
        else:
            hw_scale = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1e-12))
        if self.rnd_type == "uniform":
            return torch.empty(shape).uniform_(-scale, scale,
                                               generator=generator)
        return torch.empty(shape).normal_(0.0, scale, generator=generator)


_BY_NAME = {"zeros": Zero, "ones": One}


def create(init):
    """An initializer from an instance, a class, or a name such as
    ``"zeros"``; ``None`` stays ``None``."""
    if init is None or isinstance(init, Initializer):
        return init
    if isinstance(init, type) and issubclass(init, Initializer):
        return init()
    try:
        return _BY_NAME[str(init).lower()]()
    except KeyError:
        raise ValueError(f"unknown initializer {init!r}") from None
