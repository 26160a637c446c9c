"""Core layers (subset of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``).

``Dense`` without ``in_units``, and ``BatchNorm`` and ``LayerNorm``
without ``in_channels``, defer their parameters to the first forward
(``HybridBlock.finish_deferred_init``), as in the JAX package.
"""
from __future__ import annotations

import math

from ... import autograd
from ...ops import index_ops, nn_ops
from ..block import HybridBlock, register_state_update

__all__ = ["HybridSequential", "Dense", "Embedding", "Dropout",
           "Activation", "BatchNorm", "LayerNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Runs its children in the order they were added.  Children are
    named "0", "1", ... as in the JAX package, and ``self[i]`` returns
    the i-th."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class Dense(HybridBlock):
    """Fully connected layer; weight ``(units, in_units)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._use_bias = use_bias
        self.new_param("weight", (units, in_units), weight_initializer, dtype)
        if use_bias:
            self.new_param("bias", (units,), bias_initializer, dtype)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.finish_deferred_init("weight", (self._units, in_units))
        out = nn_ops.fully_connected(x, self.weight, self.bias,
                                     no_bias=not self._use_bias,
                                     flatten=self._flatten)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None):
        super().__init__()
        self.new_param("weight", (input_dim, output_dim), weight_initializer,
                       dtype)

    def forward(self, x):
        return index_ops.embedding(x, self.weight)


class Dropout(HybridBlock):
    """Inverted dropout, active only in train mode
    (``autograd.is_training()``: inside ``autograd.record()``), as in the
    JAX package; ``nn.Module.train()``/``eval()`` do not switch it.
    Draws come from ``generator`` (a ``torch.Generator`` on the input's
    device) when one is set, else from PyTorch's default generator."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes
        self.generator = None

    def forward(self, x):
        mode = "training" if autograd.is_training() else "predict"
        return nn_ops.dropout(x, self._rate, mode, self._axes,
                              generator=self.generator)


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return nn_ops.activation(x, act_type=self._act_type)


class BatchNorm(HybridBlock):
    """BatchNorm over ``axis`` with moving statistics.

    ``gamma`` and ``beta`` are trained (unless ``scale``/``center`` is
    off); ``running_mean`` and ``running_var`` are parameters that need
    no gradient, so the trainer leaves them alone, and in train mode
    (``autograd.is_training()``) each forward writes the blended batch
    statistics into them through ``register_state_update``, as the JAX
    layer does.  Outside train mode it normalizes with them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        c = in_channels
        self.new_param("gamma", (c,), "ones", requires_grad=scale)
        self.new_param("beta", (c,), "zeros", requires_grad=center)
        self.new_param("running_mean", (c,), "zeros", requires_grad=False)
        self.new_param("running_var", (c,), "ones", requires_grad=False)

    def forward(self, x):
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self.finish_deferred_init(name, (x.shape[self._axis],))
        training = autograd.is_training() and not self._use_global_stats
        out = nn_ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, axis=self._axis, training=training)
        if not training:
            return out
        out, new_mean, new_var = out
        register_state_update(self.running_mean, new_mean)
        register_state_update(self.running_var, new_var)
        return out


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis``: gamma starts at ones, beta at zeros."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.new_param("gamma", (in_channels,), "ones", requires_grad=scale)
        self.new_param("beta", (in_channels,), "zeros", requires_grad=center)

    def forward(self, x):
        for name in ("gamma", "beta"):
            self.finish_deferred_init(name, (x.shape[self._axis],))
        return nn_ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                                 eps=self._epsilon)


class Flatten(HybridBlock):
    """Folds every axis after the first: ``(N, ...)`` → ``(N, -1)``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
