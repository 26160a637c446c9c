from . import nn
from .block import HybridBlock

__all__ = ["HybridBlock", "nn"]
