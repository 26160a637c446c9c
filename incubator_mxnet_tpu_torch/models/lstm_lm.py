"""LSTM language model (counterpart of
``incubator_mxnet_tpu/models/lstm_lm.py``; BASELINE config 5, reference
``example/rnn/word_lm``): embedding, dropout, a fused LSTM (cuDNN's on
the card), dropout, and a dense decoder over the vocabulary.

The JAX package takes ``tie_weights`` and ignores it; here
``tie_weights=True`` raises ``NotImplementedError`` rather than build
an untied model.  As in the JAX package, the LSTM applies no dropout
between its layers (``fused_rnn`` takes the rate and ignores it).
"""
from __future__ import annotations

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["LSTMLanguageModel"]


class LSTMLanguageModel(HybridBlock):
    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.5, tie_weights=False):
        super().__init__()
        if tie_weights:
            raise NotImplementedError(
                "tie_weights: the decoder does not share the encoder's "
                "weight (the JAX package ignores the flag)")
        self.drop = nn.Dropout(dropout)
        self.encoder = nn.Embedding(vocab_size, embed_size)
        self.rnn = rnn.LSTM(hidden_size, num_layers, dropout=dropout,
                            input_size=embed_size)
        self.decoder = nn.Dense(vocab_size, in_units=hidden_size)
        self._hidden_size = hidden_size

    def begin_state(self, batch_size, device=None, **kwargs):
        """The LSTM's zero states ``[h, c]``, each ``(layers, B, H)``, on
        ``device`` (``cuda:0`` unless given)."""
        return self.rnn.begin_state(batch_size, device=device, **kwargs)

    def forward(self, inputs, state=None):
        """``inputs`` ``(T, B)`` integers → logits ``(T, B, V)``, and the
        final state when ``state`` is given."""
        emb = self.drop(self.encoder(inputs))
        if state is None:
            output, out_state = self.rnn(emb), None
        else:
            output, out_state = self.rnn(emb, state)
        output = self.drop(output)
        decoded = self.decoder(output.reshape(-1, self._hidden_size)).reshape(
            output.shape[0], output.shape[1], -1)
        if out_state is None:
            return decoded
        return decoded, out_state
