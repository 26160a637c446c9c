"""MobileNet v1 and v2, four width multipliers each (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``).  The
depthwise convolutions are ``Conv2D`` with ``groups`` equal to their
channels; v2's relu6 is ``HybridLambda(lambda x: x.clip(0, 6))``, as in
the JAX package."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["MobileNet", "MobileNetV2", "get_mobilenet",
           "get_mobilenet_v2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu") if not relu6 else
                nn.HybridLambda(lambda x: x.clip(0, 6)))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, 3, stride, 1, dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, 3, stride, 1, in_channels * t,
                  relu6=True)
        _add_conv(self.out, channels, active=False)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), 3, 2, 1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 +
                             [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 +
                          [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2] + [1] * 2 + [2] + [1] * 2 + [2] + [1] * 3 + \
            [1] * 3 + [2] + [1] * 3
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_c, c, t, s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, use_bias=False))
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    """MobileNet v1 by width multiplier."""
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, **kwargs):
    """MobileNet v2 by width multiplier."""
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return MobileNet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return MobileNet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return MobileNet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return MobileNet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return MobileNetV2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return MobileNetV2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return MobileNetV2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return MobileNetV2(0.25, **kwargs)
