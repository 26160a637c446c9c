"""Core layers (subset of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``)."""
from __future__ import annotations

from ...ops import index_ops, nn_ops
from ..block import HybridBlock

__all__ = ["Dense", "Embedding", "Dropout", "LayerNorm"]


def _need(value, what, layer):
    if not value:
        raise ValueError(f"{layer} needs {what}: the port has no deferred "
                         "shape inference")
    return value


class Dense(HybridBlock):
    """Fully connected layer; weight ``(units, in_units)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._flatten = flatten
        self._activation = activation
        self._use_bias = use_bias
        in_units = _need(in_units, "in_units", "Dense")
        self.new_param("weight", (units, in_units), weight_initializer, dtype)
        if use_bias:
            self.new_param("bias", (units,), bias_initializer, dtype)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
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
    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return nn_ops.dropout(x, self._rate,
                              "training" if self.training else "predict",
                              self._axes)


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis``: gamma starts at ones, beta at zeros."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        c = _need(in_channels, "in_channels", "LayerNorm")
        self.new_param("gamma", (c,), "ones", requires_grad=scale)
        self.new_param("beta", (c,), "zeros", requires_grad=center)

    def forward(self, x):
        return nn_ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                                 eps=self._epsilon)
