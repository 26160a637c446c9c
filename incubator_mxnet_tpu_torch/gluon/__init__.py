"""Gluon (counterpart of ``incubator_mxnet_tpu/gluon``).

``Block`` names :class:`HybridBlock`: the port's blocks run eagerly
until hybridized and have no separate non-hybrid base.  Parameters are ``nn.Parameter``s
(``Constant`` a frozen one), collected in a ``ParameterDict``."""
from . import data, loss, metric, model_zoo, nn, rnn, utils
from . import contrib
from .block import HybridBlock
from .parameter import Constant, ParameterDict
from .trainer import Trainer
from .utils import split_and_load

Block = HybridBlock

__all__ = ["Block", "HybridBlock", "Trainer", "Constant", "ParameterDict",
           "contrib", "data", "loss", "metric", "model_zoo", "nn", "rnn",
           "utils", "split_and_load"]
