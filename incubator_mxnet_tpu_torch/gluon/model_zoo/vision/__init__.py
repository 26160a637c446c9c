"""Vision model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the same 34
names in ``_models``, and :func:`get_model`."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
                     resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
                     resnet152_v2)
from .alexnet import AlexNet, alexnet
from .vgg import (VGG, get_vgg, vgg11, vgg13, vgg16, vgg19, vgg11_bn,
                  vgg13_bn, vgg16_bn, vgg19_bn)
from .squeezenet import (SqueezeNet, get_squeezenet, squeezenet1_0,
                         squeezenet1_1)
from .densenet import (DenseNet, get_densenet, densenet121, densenet161,
                       densenet169, densenet201)
from .mobilenet import (MobileNet, MobileNetV2, get_mobilenet,
                        get_mobilenet_v2, mobilenet1_0, mobilenet0_75,
                        mobilenet0_5, mobilenet0_25, mobilenet_v2_1_0,
                        mobilenet_v2_0_75, mobilenet_v2_0_5,
                        mobilenet_v2_0_25)
from .inception import Inception3, inception_v3

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """The zoo's model ``name`` (case-insensitive, as ``_models`` spells
    it), built with ``kwargs``; an unknown name raises ``ValueError``."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"unknown model {name}; available: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["get_model", "AlexNet", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "DenseNet", "Inception3",
           "MobileNet", "MobileNetV2", "ResNetV1", "ResNetV2", "SqueezeNet",
           "VGG", "get_densenet", "get_mobilenet", "get_mobilenet_v2",
           "get_resnet", "get_squeezenet", "get_vgg"] + [
    fn.__name__ for fn in _models.values()]
