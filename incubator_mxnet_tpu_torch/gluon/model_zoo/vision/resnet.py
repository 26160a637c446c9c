"""ResNet V1 and V2 (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``): 18, 34, 50,
101 and 152 layers, post-activation (v1) and pre-activation (v2), with
the conv7, thumbnail (CIFAR) and ``"s2d"`` stems, NCHW or NHWC.

``fused=True`` (bottleneck blocks, NHWC only): in train mode
(``autograd.is_training()``) each :class:`BottleneckV1` runs
``ops/fused_block.fused_bottleneck_v1`` (or ``_proj``) and each
:class:`BottleneckV2` ``fused_bottleneck_v2`` (or ``_proj``): its 1x1
convolutions are the fused matmul + BatchNorm kernels, with the BN
batch statistics from their epilogues and the previous BN's normalize +
ReLU in their prologues; its stride-1 3x3 is the fused 3x3 conv +
BatchNorm kernels (``ops/fused_conv.fused_conv3_bn``).  The moving
statistics are written back through ``register_state_update``, as the
layers do.  Outside train mode, or when a BN has its own eps, momentum
or global statistics, the block runs its layers.  A basic block, or
``fused=True`` without NHWC, raises.

Parameter names match the JAX model's one for one
(``features.4.0.body.0.weight``, ``...bn1.running_mean``), so
``convert.params_from_jax`` carries a JAX model's weights over; a
layer the JAX model leaves deferred (the thumbnail conv, the v2 input
BN) is deferred here too.  ``pretrained=True`` raises, as in the JAX
package: there are no weights to fetch.
"""
from __future__ import annotations

from .... import autograd
from ....amp.amp import cast_args
from ....ops import fused_block, shape_ops
from ... import nn
from ...block import HybridBlock, register_state_update

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "S2DStem", "ResNetV1", "ResNetV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


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


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False):
        super().__init__()
        _check_fused(fused, layout, "BasicBlockV1")
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
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

    def forward(self, x):
        residual = x
        x_out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return self.relu(x_out + residual)


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


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False):
        super().__init__()
        _check_fused(fused, layout, "BasicBlockV2")
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax, in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax, in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.relu = nn.Activation("relu")
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.relu(self.bn2(x))
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False):
        super().__init__()
        _check_fused(fused, layout, "BottleneckV2")
        ax = _bn_axis(layout)
        mid = channels // 4
        self._stride = stride
        self._fused = bool(fused)
        self.bn1 = nn.BatchNorm(axis=ax, in_channels=in_channels)
        self.conv1 = nn.Conv2D(mid, 1, 1, use_bias=False,
                               in_channels=in_channels, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax, in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid, layout)
        self.bn3 = nn.BatchNorm(axis=ax, in_channels=mid)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False,
                               in_channels=mid, layout=layout)
        self.relu = nn.Activation("relu")
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def _forward_fused(self, x):
        # the layers do not run: give a block built without in_channels
        # its input-sized parameters here
        ci = x.shape[-1]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self.bn1.finish_deferred_init(name, (ci,))
        convs = (self.conv1,) + ((self.downsample,)
                                 if self.downsample is not None else ())
        for conv in convs:
            conv.finish_deferred_init("weight", conv._weight_shape(ci))
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        state_bns = (self.bn1, self.bn2, self.bn3)  # no shortcut BN in v2
        if self.downsample is not None:
            return _invoke_fused_bottleneck(
                x, fused_block.fused_bottleneck_v2_proj, pairs,
                (self.downsample.weight,), state_bns, self._stride)
        return _invoke_fused_bottleneck(
            x, fused_block.fused_bottleneck_v2, pairs, (), state_bns,
            self._stride)

    def _fused_bns_uniform(self):
        return _bns_uniform((self.bn1, self.bn2, self.bn3))

    def forward(self, x):
        if (self._fused and autograd.is_training()
                and self._fused_bns_uniform()):
            return self._forward_fused(x)
        residual = x
        x = self.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.relu(self.bn2(x))
        x = self.conv2(x)
        x = self.relu(self.bn3(x))
        x = self.conv3(x)
        return x + residual


class S2DStem(HybridBlock):
    """Space-to-depth stem: ``space_to_depth(2)``, then a 4x4 stride-1
    conv with padding 2 over 12 channels in place of the 7x7 stride-2
    conv over 3, its last row and column dropped.  NCHW only, as the JAX
    op is; odd image sides raise."""

    def __init__(self, channels, layout="NCHW"):
        super().__init__()
        if layout != "NCHW":
            raise ValueError("stem='s2d' is NCHW-only (space_to_depth op "
                             "layout); use the conv7 stem with NHWC")
        self.conv = nn.Conv2D(channels, 4, 1, 2, use_bias=False,
                              in_channels=12)

    def forward(self, x):
        if x.shape[-1] % 2 or x.shape[-2] % 2:
            raise ValueError(
                f"stem='s2d' needs even spatial dims (got "
                f"{tuple(x.shape[-2:])}); use the default conv7 stem for "
                "odd crop sizes")
        y = self.conv(shape_ops.space_to_depth(x, block_size=2))
        return y[:, :, :-1, :-1]


def _add_stem(features, channels, thumbnail, stem, layout="NCHW"):
    if thumbnail:
        features.add(_conv3x3(channels, 1, 0, layout))
        return
    if stem == "s2d":
        features.add(S2DStem(channels, layout=layout))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               in_channels=3, layout=layout))
    features.add(nn.BatchNorm(axis=_bn_axis(layout), in_channels=channels))
    features.add(nn.Activation("relu"))
    features.add(nn.MaxPool2D(3, 2, 1, layout=layout))


def _make_layer(block, layers, channels, stride, in_channels, layout,
                fused):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout, fused=fused))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout, fused=fused))
    return layer


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
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, channels[i],
                layout, fused))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: an input BatchNorm without scale or shift,
    the stem, the stages, then BN, ReLU, global average pooling and
    ``Flatten`` before the classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 stem="conv7", layout="NCHW", fused=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        _add_stem(self.features, channels[0], thumbnail, stem, layout)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, in_channels,
                layout, fused))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax, in_channels=in_channels))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet v``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101 or
    152); ``kwargs`` go to :class:`ResNetV1` or :class:`ResNetV2`."""
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
