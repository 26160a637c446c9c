"""DenseNet 121/161/169/201 (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/densenet.py``).  The final
``AvgPool2D(7)`` wants a map of at least 7x7, so the nets need images
of about 193x193 or more (224x224 in the reference), as in the JAX
package; a smaller image raises."""
from __future__ import annotations

from ....ops import shape_ops
from ... import nn
from ...block import HybridBlock

__all__ = ["DenseNet", "get_densenet", "densenet121", "densenet161",
           "densenet169", "densenet201"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return shape_ops.concat(x, self.body(x), dim=1)


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, 1, use_bias=False))
    out.add(nn.AvgPool2D(2, 2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                    use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(3, 2, 1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            block = nn.HybridSequential()
            for _ in range(num_layers):
                block.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(block)
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(_make_transition(num_features // 2))
                num_features //= 2
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.AvgPool2D(7))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, ctx=None, **kwargs):
    """DenseNet by depth: 121, 161, 169 or 201."""
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    num_init, growth, config = densenet_spec[num_layers]
    return DenseNet(num_init, growth, config, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
