"""Recurrent layers and cells (counterpart of
``incubator_mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell, RecurrentCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell", "ModifierCell",
           "HybridRecurrentCell", "HybridSequentialRNNCell"]
