"""Model definitions ported from ``incubator_mxnet_tpu/models``."""
from .lstm_lm import LSTMLanguageModel

__all__ = ["LSTMLanguageModel"]
