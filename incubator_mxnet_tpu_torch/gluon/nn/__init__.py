from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridLambda, HybridSequential, Identity,
                           Lambda, LayerNorm)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Embedding", "Flatten", "GlobalAvgPool2D",
           "GlobalMaxPool2D", "HybridLambda", "HybridSequential", "Identity",
           "Lambda", "LayerNorm", "MaxPool2D"]
