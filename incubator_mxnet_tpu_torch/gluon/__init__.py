from . import loss, nn
from .block import HybridBlock
from .trainer import Trainer

__all__ = ["HybridBlock", "Trainer", "loss", "nn"]
