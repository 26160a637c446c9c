from . import data, loss, metric, nn, rnn, utils
from .block import HybridBlock
from .trainer import Trainer

__all__ = ["HybridBlock", "Trainer", "data", "loss", "metric", "nn", "rnn",
           "utils"]
