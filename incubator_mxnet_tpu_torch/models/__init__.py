"""Model definitions ported from ``incubator_mxnet_tpu/models``."""
from .lstm_lm import LSTMLanguageModel
from .ssd import SSD, SSDLoss, ssd_300

__all__ = ["LSTMLanguageModel", "SSD", "SSDLoss", "ssd_300"]
