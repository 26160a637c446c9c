"""Fused RNN layers (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``; reference
``python/mxnet/gluon/rnn/rnn_layer.py``) over ``ops.sequence_ops.fused_rnn``,
which runs cuDNN's RNN on the card.

A layer keeps every weight and bias in one flat parameter,
``params_flat``, in the JAX package's layout (all weights, then all
biases).  Without ``input_size`` it is deferred and takes its length
from the first batch.  It is drawn by ``Xavier()`` over its 1-D shape,
biases included, as in the JAX package: its name does not end in
``bias``, and a 1-D shape's fans are both its length, so every entry is
U(±sqrt(3/N)).
"""
from __future__ import annotations

import torch

from ... import initializer as init_mod
from ...context import resolve_device
from ...ops.sequence_ops import fused_rnn, rnn_param_size
from ..block import HybridBlock, as_dtype

__all__ = ["RNN", "LSTM", "GRU"]


def begin_states(infos, func=torch.zeros, device=None, **kwargs):
    """``func(shape, device=..., **kwargs)`` for each state of ``infos``
    (``state_info()``'s list); ``device`` is ``cuda:0`` unless given,
    and a ``dtype`` may be a name such as ``"float32"``."""
    device = resolve_device(device)
    if "dtype" in kwargs:
        kwargs["dtype"] = as_dtype(kwargs["dtype"])
    return [func(info["shape"], device=device, **kwargs) for info in infos]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"layout {layout!r}: have 'TNC' and 'NTC'")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._mode = mode
        self.new_param("params_flat", (self._param_size(input_size),),
                       init_mod.Xavier())

    def _param_size(self, input_size):
        if not input_size:
            return 0
        return rnn_param_size(input_size, self._hidden_size,
                              self._num_layers, self._mode, self._dir == 2)

    def state_info(self, batch_size=0):
        num = self._num_layers * self._dir
        info = {"shape": (num, batch_size, self._hidden_size),
                "__layout__": "LNC"}
        return [info, dict(info)] if self._mode == "lstm" else [info]

    def begin_state(self, batch_size=0, func=torch.zeros, device=None,
                    **kwargs):
        """Zero states (or ``func``'s) of ``state_info(batch_size)`` on
        ``device`` (``cuda:0`` unless given)."""
        return begin_states(self.state_info(batch_size), func, device,
                            **kwargs)

    def forward(self, inputs, states=None):
        """``inputs`` ``(T, B, I)`` (``"NTC"``: ``(B, T, I)``) → the
        outputs, and the final states as a list when ``states`` is
        given."""
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        self.finish_deferred_init("params_flat",
                                  (self._param_size(inputs.shape[-1]),))
        return_states = states is not None
        if states is None:
            states = self.begin_state(inputs.shape[1], device=inputs.device,
                                      dtype=inputs.dtype)
        if isinstance(states, torch.Tensor):
            states = [states]
        outs = fused_rnn(inputs, self.params_flat, *states,
                         state_size=self._hidden_size,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._dir == 2, p=self._dropout)
        out, new_states = outs[0], list(outs[1:])
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if return_states:
            return out, new_states
        return out


class RNN(_RNNLayer):
    """Elman RNN, ``activation`` ``"relu"`` or ``"tanh"``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm")


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru")
