"""BERT encoder (counterpart of ``incubator_mxnet_tpu/models/bert.py``).

Same constructor arguments, defaults (BERT-base) and parameter names as
the JAX package, so :func:`~..convert.params_from_jax` carries weights
across one for one.  Its 25 LayerNorms (embedding plus two per layer)
run the hand-written kernel on the card.
"""
from __future__ import annotations

import torch

from .. import initializer as init_mod
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops.elemwise import gelu
from ..ops.nn_ops import dot_product_attention

__all__ = ["BERTSelfAttention", "BERTEncoderLayer", "BERTEncoder",
           "BERTModel"]


class BERTSelfAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.1):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self.qkv = nn.Dense(3 * units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        B, T, D = x.shape
        H = self._heads
        # the packed projection is q, then k, then v, each head-major
        qkv = self.qkv(x).reshape(B, T, 3, H, D // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att_mask = None if mask is None else mask.reshape(B, 1, 1, T)
        out = dot_product_attention(q, k, v, att_mask)
        out = out.permute(0, 2, 1, 3).reshape(B, T, D)
        return self.dropout(self.proj(out))


class BERTEncoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.1):
        super().__init__()
        self.attention = BERTSelfAttention(units, num_heads, dropout)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units)
        self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        h = self.ffn2(gelu(self.ffn1(x)))
        return self.ln2(x + self.dropout(h))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1):
        super().__init__()
        for i in range(num_layers):
            self.register_child(
                BERTEncoderLayer(units, hidden_size, num_heads, dropout),
                f"layer{i}")

    def forward(self, x, mask=None):
        for layer in self.children():
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Token+segment+position embeddings → encoder → MLM + NSP heads.

    ``forward(tokens (B, T) int, token_types (B, T) int or None,
    valid_length (B,) int or None)`` → ``(mlm logits (B, T, vocab),
    nsp logits (B, 2))``.  Keys at or past a row's valid length are
    masked; a row with ``valid_length`` 0 has no valid key and comes
    out NaN, as in the JAX package."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1):
        super().__init__()
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(type_vocab_size, units)
        self.new_param("pos_embed", (max_length, units),
                       init_mod.Normal(0.02))
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout)
        self.pooler = nn.Dense(units, activation="tanh", in_units=units)
        self.mlm_decoder = nn.Dense(vocab_size, flatten=False, in_units=units)
        self.nsp_classifier = nn.Dense(2, in_units=units)

    def forward(self, tokens, token_types=None, valid_length=None):
        B, T = tokens.shape
        x = self.word_embed(tokens)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = x + self.pos_embed[:T].unsqueeze(0)
        x = self.embed_dropout(self.embed_ln(x))
        mask = None
        if valid_length is not None:
            steps = torch.arange(T, device=tokens.device)
            mask = steps.unsqueeze(0) < valid_length.unsqueeze(1)
        x = self.encoder(x, mask)
        pooled = self.pooler(x[:, 0])
        return self.mlm_decoder(x), self.nsp_classifier(pooled)
