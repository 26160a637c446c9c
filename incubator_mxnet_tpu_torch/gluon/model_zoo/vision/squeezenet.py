"""SqueezeNet 1.0 and 1.1 (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``).

The JAX model builds its max pools with ``ceil_mode=True``, which the
JAX pooling ignores: it pools in floor mode.  The port builds them
without the flag, in floor mode, so that both give the same shapes
(ROADMAP §C)."""
from __future__ import annotations

from ....ops import shape_ops
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "get_squeezenet", "squeezenet1_0",
           "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze_channels, 1, activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, 1, activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, 3, padding=1,
                                   activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return shape_ops.concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        assert version in ("1.0", "1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(_Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, **kwargs):
    """SqueezeNet by version string, ``"1.0"`` or ``"1.1"``."""
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
