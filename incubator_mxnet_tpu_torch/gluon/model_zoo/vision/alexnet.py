"""AlexNet (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py``).  The Dense
layers defer their input width to the first forward, as in the JAX
package, so the net runs at any image size that leaves a map after the
third pooling."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, **kwargs):
    if pretrained:
        raise RuntimeError("no pretrained weights: the zoo has none to "
                           "fetch")
    return AlexNet(**kwargs)
