"""ResNet V1 with bottleneck blocks (subset of
``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``): ResNet-50,
101 and 152 v1 with the conv7 stem, NCHW or NHWC.

``fused=True`` (NHWC only): in train mode (``autograd.is_training()``)
each :class:`BottleneckV1` runs ``ops/fused_block.fused_bottleneck_v1``
(or ``_proj``): its 1x1 convolutions are the fused matmul + BatchNorm
kernels, with the BN batch statistics from their epilogues and the
previous BN's normalize + ReLU in their prologues; its 3x3 is the fused
3x3 conv + BatchNorm kernels (``ops/fused_conv.fused_conv3_bn``).  The
moving statistics are written back through ``register_state_update``,
as the layers do.  Outside train mode the block runs its layers.

The port has no deferred initialisation, so every block is given its
``in_channels``; parameter names match the JAX model's one for one
(``features.4.0.body.0.weight``, ``...body.1.running_mean``), so
``convert.params_from_jax`` carries a JAX model's weights over.
``BasicBlock*``, the V2 family, the ``"s2d"`` and thumbnail stems are
later slices of the port.
"""
from __future__ import annotations

from .... import autograd
from ....amp.amp import cast_args
from ....ops import fused_block
from ... import nn
from ...block import HybridBlock, register_state_update

__all__ = ["BottleneckV1", "ResNetV1", "resnet_spec", "get_resnet",
           "resnet50_v1"]


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _check_fused(fused, layout, cls):
    """fused=True must never quietly run the plain path."""
    if not fused:
        return
    if cls not in ("BottleneckV1", "BottleneckV2"):
        raise ValueError(
            f"fused=True is implemented for the bottleneck blocks only "
            f"(ResNet-50/101/152 v1 and v2); {cls} has no fused path")
    if layout != "NHWC":
        raise ValueError(
            "fused=True requires layout='NHWC' (the fused matmul+BN "
            "kernels read channel-minor [M, C] views)")


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn_args(bn):
    return bn.gamma, bn.beta, bn.running_mean, bn.running_var


def _bns_uniform(bns):
    """The fused functions take one eps and momentum and always use batch
    statistics; a BN with ``use_global_stats`` or its own eps/momentum
    sends the block through its layers instead."""
    ref = bns[0]
    return all(not bn._use_global_stats and bn._epsilon == ref._epsilon
               and bn._momentum == ref._momentum for bn in bns)


def _invoke_fused_bottleneck(x, fn, pairs, extra_args, state_bns, stride):
    """Call a fused bottleneck function with ``(x, [w_i, bn_i
    params]..., extra)`` and write the moving statistics it returns into
    ``state_bns``.  The arguments go through the AMP cast under the JAX
    package's op name (``_fused_bottleneck_v1[_proj]``, in no list)."""
    args = [x]
    for conv, bn in pairs:
        args.append(conv.weight)
        args.extend(_bn_args(bn))
    args.extend(extra_args)
    args = cast_args("_" + fn.__name__, *args)
    outs = fn(*args, stride=stride, eps=pairs[0][1]._epsilon,
              momentum=pairs[0][1]._momentum)
    for i, bn in enumerate(state_bns):
        register_state_update(bn.running_mean, outs[1 + 2 * i])
        register_state_update(bn.running_var, outs[2 + 2 * i])
    return outs[0]


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False):
        super().__init__()
        _check_fused(fused, layout, "BottleneckV1")
        ax = _bn_axis(layout)
        mid = channels // 4
        self._stride = stride
        self._fused = bool(fused)
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False, in_channels=in_channels,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, in_channels=mid,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels))
        else:
            self.downsample = None
        self.relu = nn.Activation("relu")

    def _forward_fused(self, x):
        bn1, bn2, bn3 = self.body[1], self.body[4], self.body[7]
        pairs = ((self.body[0], bn1), (self.body[3], bn2),
                 (self.body[6], bn3))
        if self.downsample is not None:
            dconv, dbn = self.downsample[0], self.downsample[1]
            return _invoke_fused_bottleneck(
                x, fused_block.fused_bottleneck_v1_proj, pairs,
                (dconv.weight,) + _bn_args(dbn), (bn1, bn2, bn3, dbn),
                self._stride)
        return _invoke_fused_bottleneck(
            x, fused_block.fused_bottleneck_v1, pairs, (), (bn1, bn2, bn3),
            self._stride)

    def _fused_bns_uniform(self):
        bns = [self.body[1], self.body[4], self.body[7]]
        if self.downsample is not None:
            bns.append(self.downsample[1])
        return _bns_uniform(bns)

    def forward(self, x):
        if (self._fused and autograd.is_training()
                and self._fused_bns_uniform()):
            return self._forward_fused(x)
        residual = x
        x_out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return self.relu(x_out + residual)


def _add_stem(features, channels, thumbnail, stem, layout="NCHW"):
    if thumbnail or stem != "conv7":
        raise NotImplementedError("only the conv7 stem is ported (the "
                                  "thumbnail and s2d stems are a later slice "
                                  "of the port)")
    features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False, in_channels=3,
                           layout=layout))
    features.add(nn.BatchNorm(axis=_bn_axis(layout), in_channels=channels))
    features.add(nn.Activation("relu"))
    features.add(nn.MaxPool2D(3, 2, 1, layout=layout))


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 stem="conv7", layout="NCHW", fused=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        self.features = nn.HybridSequential()
        _add_stem(self.features, channels[0], thumbnail, stem, layout)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], layout=layout, fused=fused))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, in_channels=0,
                    layout="NCHW", fused=False):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout, fused=fused))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, fused=fused))
        return layer

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


resnet_spec = {
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def get_resnet(version, num_layers, **kwargs):
    """ResNet v1 of 50, 101 or 152 layers; ``kwargs`` go to
    :class:`ResNetV1`.  Version 2 and the 18/34-layer basic-block nets
    are not ported yet."""
    if version != 1 or num_layers not in resnet_spec:
        raise NotImplementedError(
            f"resnet{num_layers}_v{version} is not ported yet (a later slice "
            f"of the port); have v1 with {sorted(resnet_spec)} layers")
    _, layers, channels = resnet_spec[num_layers]
    return ResNetV1(BottleneckV1, layers, channels, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)
