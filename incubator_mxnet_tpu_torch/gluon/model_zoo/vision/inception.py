"""Inception v3 (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py``).  It is
built for 299x299 images: the final ``AvgPool2D(8)`` wants an 8x8 map,
and at 224x224 the map is 5x5, so the net raises there, as the JAX one
does."""
from __future__ import annotations

from ....ops import shape_ops
from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(channels, **kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branching(HybridBlock):
    """Runs each branch on the input and joins their outputs along the
    channels; the branches are named ``branch0``, ``branch1``, ..."""

    def __init__(self, branches):
        super().__init__()
        for i, b in enumerate(branches):
            self.register_child(b, f"branch{i}")

    def forward(self, x):
        return shape_ops.concat(*[child(x) for child in
                                  self._modules.values()], dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(3, 1, 1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(3, 2))
    for channels, kernel, stride, pad in conv_settings:
        kw = {"kernel_size": kernel}
        if stride is not None:
            kw["strides"] = stride
        if pad is not None:
            kw["padding"] = pad
        out.add(_make_basic_conv(channels, **kw))
    return out


def _make_A(pool_features):
    return _Branching([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ])


def _make_B():
    return _Branching([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ])


def _make_C(channels_7x7):
    return _Branching([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ])


def _make_D():
    return _Branching([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch("max"),
    ])


class _BranchingE(HybridBlock):
    def __init__(self):
        super().__init__()
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_basic_conv(384, kernel_size=1)
        self.branch2_a = _make_basic_conv(384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch2_b = _make_basic_conv(384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch3_stem = nn.HybridSequential()
        self.branch3_stem.add(_make_basic_conv(448, kernel_size=1))
        self.branch3_stem.add(_make_basic_conv(384, kernel_size=3, padding=1))
        self.branch3_a = _make_basic_conv(384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch3_b = _make_basic_conv(384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch4 = _make_branch("avg", (192, 1, None, None))

    def forward(self, x):
        b1 = self.branch1(x)
        s2 = self.branch2_stem(x)
        b2 = shape_ops.concat(self.branch2_a(s2), self.branch2_b(s2), dim=1)
        s3 = self.branch3_stem(x)
        b3 = shape_ops.concat(self.branch3_a(s3), self.branch3_b(s3), dim=1)
        b4 = self.branch4(x)
        return shape_ops.concat(b1, b2, b3, b4, dim=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(32, kernel_size=3, strides=2))
        self.features.add(_make_basic_conv(32, kernel_size=3))
        self.features.add(_make_basic_conv(64, kernel_size=3, padding=1))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_make_basic_conv(80, kernel_size=1))
        self.features.add(_make_basic_conv(192, kernel_size=3))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_BranchingE())
        self.features.add(_BranchingE())
        self.features.add(nn.AvgPool2D(8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return Inception3(**kwargs)
