"""Convolution and pooling layers (subset of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D``.

Every shape is known at construction, so ``Conv2D`` takes
``in_channels``.  Its weight is ``(channels, in/groups, kh, kw)`` in the
default ``"NCHW"`` layout and ``(channels, kh, kw, in/groups)`` in a
channel-minor one (``"NHWC"``), as in the JAX package.
"""
from __future__ import annotations

from ... import initializer as init_mod
from ...ops import nn_ops
from ..block import HybridBlock
from .basic_layers import _need

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros"):
        super().__init__()
        self._layout = layout
        self._kernel = _tuple(kernel_size, 2)
        self._strides = _tuple(strides, 2)
        self._padding = _tuple(padding, 2)
        self._dilation = _tuple(dilation, 2)
        self._groups = groups
        self._activation = activation
        self._use_bias = use_bias
        cin = _need(in_channels, "in_channels", "Conv2D") // groups
        if layout.endswith("C"):
            wshape = (channels,) + self._kernel + (cin,)
        else:
            wshape = (channels, cin) + self._kernel
        self.new_param("weight", wshape,
                       weight_initializer or init_mod.Xavier())
        if use_bias:
            self.new_param("bias", (channels,), bias_initializer)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        out = nn_ops.convolution(
            x, self.weight, self.bias, stride=self._strides,
            pad=self._padding, dilate=self._dilation, num_group=self._groups,
            no_bias=not self._use_bias, layout=self._layout)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out


class _Pool2D(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout=None):
        super().__init__()
        self._layout = layout
        self._kernel = _tuple(pool_size, 2)
        self._strides = _tuple(strides if strides is not None else pool_size,
                               2)
        self._padding = _tuple(padding, 2)
        self._global = global_pool
        self._pool_type = pool_type

    def forward(self, x):
        return nn_ops.pooling(x, kernel=self._kernel,
                              pool_type=self._pool_type,
                              global_pool=self._global, stride=self._strides,
                              pad=self._padding, layout=self._layout)


class MaxPool2D(_Pool2D):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None):
        super().__init__(pool_size, strides, padding, False, "max",
                         layout=layout)


class GlobalAvgPool2D(_Pool2D):
    def __init__(self, layout=None):
        super().__init__(1, 1, 0, True, "avg", layout=layout)
