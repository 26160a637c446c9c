from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import Conv2D, GlobalAvgPool2D, GlobalMaxPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool2D", "GlobalMaxPool2D",
           "HybridSequential", "LayerNorm", "MaxPool2D"]
