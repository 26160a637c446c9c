"""Convolution and pooling layers (subset of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv2D``,
``MaxPool2D``, ``AvgPool2D``, ``GlobalAvgPool2D`` and
``GlobalMaxPool2D``.

Without ``in_channels``, ``Conv2D`` defers its weight to the first
forward, which gives the input's channels.  Its weight is
``(channels, in/groups, kh, kw)`` in the default ``"NCHW"`` layout and
``(channels, kh, kw, in/groups)`` in a channel-minor one (``"NHWC"``),
as in the JAX package.

``ceil_mode=True`` raises: the JAX pooling takes the flag and pools in
floor mode all the same (ROADMAP §C), and the port builds no layer
whose result contradicts its arguments.
"""
from __future__ import annotations

from ... import initializer as init_mod
from ...ops import nn_ops
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "GlobalMaxPool2D"]


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
        self._channels = channels
        self.new_param("weight", self._weight_shape(in_channels),
                       weight_initializer or init_mod.Xavier())
        if use_bias:
            self.new_param("bias", (channels,), bias_initializer)
        else:
            self.register_parameter("bias", None)

    def _weight_shape(self, in_channels):
        cin = in_channels // self._groups
        if self._layout.endswith("C"):
            return (self._channels,) + self._kernel + (cin,)
        return (self._channels, cin) + self._kernel

    def forward(self, x):
        cin = x.shape[-1] if self._layout.endswith("C") else x.shape[1]
        self.finish_deferred_init("weight", self._weight_shape(cin))
        out = nn_ops.convolution(
            x, self.weight, self.bias, stride=self._strides,
            pad=self._padding, dilate=self._dilation, num_group=self._groups,
            no_bias=not self._use_bias, layout=self._layout)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out


class _Pool2D(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout=None, ceil_mode=False, count_include_pad=True):
        super().__init__()
        if ceil_mode:
            raise ValueError(
                "ceil_mode=True is not ported: the JAX pooling pools in "
                "floor mode whatever the flag says (ROADMAP §C); build the "
                "layer without it for the JAX package's shapes")
        self._layout = layout
        self._kernel = _tuple(pool_size, 2)
        self._strides = _tuple(strides if strides is not None else pool_size,
                               2)
        self._padding = _tuple(padding, 2)
        self._global = global_pool
        self._pool_type = pool_type
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return nn_ops.pooling(x, kernel=self._kernel,
                              pool_type=self._pool_type,
                              global_pool=self._global, stride=self._strides,
                              pad=self._padding,
                              count_include_pad=self._count_include_pad,
                              layout=self._layout)


class MaxPool2D(_Pool2D):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "max",
                         layout, ceil_mode, count_include_pad)


class AvgPool2D(_Pool2D):
    """Average pooling; padding counts as 0 and, by default, in the
    divisor (``count_include_pad``)."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg",
                         layout, ceil_mode, count_include_pad)


class GlobalAvgPool2D(_Pool2D):
    def __init__(self, layout=None):
        super().__init__(1, 1, 0, True, "avg", layout=layout)


class GlobalMaxPool2D(_Pool2D):
    def __init__(self, layout=None):
        super().__init__(1, 1, 0, True, "max", layout=layout)
