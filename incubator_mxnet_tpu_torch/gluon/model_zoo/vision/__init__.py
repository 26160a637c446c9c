from .resnet import BottleneckV1, ResNetV1, get_resnet, resnet50_v1

__all__ = ["BottleneckV1", "ResNetV1", "get_resnet", "resnet50_v1"]
