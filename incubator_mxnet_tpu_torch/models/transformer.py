"""Decoder-only transformer LM on one device (counterpart of
``incubator_mxnet_tpu/models/transformer.py``).

The JAX model is a parameter pytree with pure ``init``/``apply``
functions, built for a device mesh.  Here it is an ``nn.Module`` that
keeps the pytree's names, shapes and layout — ``embed`` (V, D),
``pos_embed`` (max_len, D), the stacked ``layers.{wqkv (L, D, 3D), wo,
ln1, ln2, w1 (L, D, F), w2}`` and ``ln_f`` — and computes ``x @ W`` with
W as (in, out), so :func:`~..convert.transformer_params_from_jax` carries
weights across one for one.  Its RMSNorms (two a layer and ``ln_f``) and
its attention softmax run the hand-written kernels on the card, forward
and backward, and the LM loss runs the softmax cross-entropy kernels.

Attention is the JAX model's ``"gspmd"`` form, causal: the logits of the
low-precision q and k are float32 (the JAX einsum's
``preferred_element_type``; here q and k are widened first, which
computes the same exact products), divided by sqrt(head_dim), filled with
-1e30 above the diagonal, and the float32 softmax is cast to the model's
dtype before the product with v.  ``attention="flash"`` runs the JAX
model's flash branch instead: the flash-attention kernels, forward and
backward (``ops/flash_attention.py``), which keep the logits, the
probabilities and both products in float32 and never write the (T, T)
logits to memory, so the two forms round differently in bfloat16.  GELU
is the tanh form, the default of ``jax.nn.gelu``.

Not ported yet (they raise ``NotImplementedError``): a device mesh,
``apply_pipelined``, ring attention and MoE (ROADMAP item 11,
distribution).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.nn_ops import rms_norm, softmax
from ..ops.softmax_xent import SoftmaxXentFunction

__all__ = ["TransformerConfig", "TransformerLM"]

_DISTRIBUTION = ("is not ported yet: the port runs one device (ROADMAP "
                 "item 11, distribution: meshes, ring attention, the "
                 "pipeline, MoE)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2048
    dtype: str = "bfloat16"
    use_moe: bool = False
    n_experts: int = 8
    attention: str = "gspmd"  # 'gspmd' | 'ring' | 'flash' (kernel 5)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(f"a device mesh {_DISTRIBUTION}")


class TransformerLM(nn.Module):
    """The JAX package's ``TransformerLM`` as a module.  Its parameters
    are empty (on the ``meta`` device) until :meth:`init` draws them or
    :func:`~..convert.transformer_params_from_jax` loads the JAX model's
    into an initialised module."""

    def __init__(self, config: TransformerConfig | None = None):
        super().__init__()
        cfg = config if config is not None else TransformerConfig()
        if cfg.use_moe:
            raise NotImplementedError(f"use_moe=True (parallel/moe) "
                                      f"{_DISTRIBUTION}")
        if cfg.attention not in ("gspmd", "flash"):
            raise NotImplementedError(f"attention={cfg.attention!r} "
                                      f"{_DISTRIBUTION}")
        self.cfg = cfg
        self.layers = nn.ParameterDict()
        for name, (shape, _) in self._shapes().items():
            self._set(name, torch.empty(shape, dtype=_dtype(cfg),
                                        device="meta"))

    def _shapes(self):
        """``{name: (shape, scale)}`` in the JAX ``init``'s draw order; a
        scale of None is a norm's ones."""
        cfg = self.cfg
        D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        return {
            "embed": ((cfg.vocab_size, D), 0.02),
            "pos_embed": ((cfg.max_len, D), 0.02),
            "layers.wqkv": ((L, D, 3 * D), D ** -0.5),
            "layers.wo": ((L, D, D), D ** -0.5),
            "layers.w1": ((L, D, F_), D ** -0.5),
            "layers.w2": ((L, F_, D), F_ ** -0.5),
            "layers.ln1": ((L, D), None),
            "layers.ln2": ((L, D), None),
            "ln_f": ((D,), None),
        }

    def _set(self, name, tensor):
        _, _, leaf = name.partition(".")
        if leaf:
            self.layers[leaf] = nn.Parameter(tensor)
        else:
            setattr(self, name, nn.Parameter(tensor))

    def init(self, generator=None, device=None):
        """Draw the weights with the JAX ``init``'s scales: N(0, 1)·0.02
        for both embeddings, ·D^-0.5 for wqkv, wo and w1, ·F^-0.5 for w2,
        ones for the norms; float32 draws from ``generator`` (seed 0 if
        None) on the CPU, cast to the config's dtype and placed on
        ``device``: ``cuda:0`` unless the CPU is named.  torch's draws are
        not jax.random's; carry the JAX model's weights with
        ``convert.transformer_params_from_jax``.  Returns the module."""
        device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        for name, (shape, scale) in self._shapes().items():
            t = (torch.ones(shape) if scale is None
                 else torch.randn(shape, generator=gen) * scale)
            self._set(name, t.to(device, _dtype(self.cfg)))
        return self

    # -- forward ----------------------------------------------------------
    def _attention(self, q, k, v):
        if self.cfg.attention == "flash":
            return flash_attention(q, k, v, causal=True).to(q.dtype)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        # in place: neither step's backward reads the logits
        logits.div_(self.cfg.head_dim ** 0.5)
        t, s = logits.shape[-2:]
        keep = torch.ones(t, s, dtype=torch.bool, device=q.device).tril()
        logits.masked_fill_(~keep, -1e30)
        probs = softmax(logits, axis=-1).to(q.dtype)
        return torch.matmul(probs, v)

    def _layer(self, i, x):
        cfg = self.cfg
        B, T, D = x.shape
        H, dh = cfg.n_heads, cfg.head_dim
        lp = self.layers
        h = rms_norm(x, lp["ln1"][i])
        q, k, v = (h @ lp["wqkv"][i]).split(D, dim=-1)

        def heads(t):
            return t.reshape(B, T, H, dh).transpose(1, 2)

        att = self._attention(heads(q), heads(k), heads(v))
        x = x + att.transpose(1, 2).reshape(B, T, D) @ lp["wo"][i]
        h = rms_norm(x, lp["ln2"][i])
        ff = F.gelu(h @ lp["w1"][i], approximate="tanh")
        return x + ff @ lp["w2"][i]

    def forward(self, tokens, mesh=None):
        """tokens (B, T) integer → logits (B, T, V) in the config's
        dtype."""
        _no_mesh(mesh)
        T = tokens.shape[1]
        x = F.embedding(tokens, self.embed) + self.pos_embed[:T][None]
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x)
        x = rms_norm(x, self.ln_f)
        return x @ self.embed.t()   # the head is tied to the embedding

    def apply_pipelined(self, tokens, mesh, n_micro):
        raise NotImplementedError(f"apply_pipelined (the pp schedule) "
                                  f"{_DISTRIBUTION}")

    # -- training ---------------------------------------------------------
    def loss(self, tokens, mesh=None):
        """Mean next-token cross-entropy of tokens (B, T + 1), float32:
        the logsumexp of each position's float32 logits less its target's
        logit, by the softmax cross-entropy kernels (the JAX loss takes
        the float32 ``log_softmax`` and picks the target)."""
        _no_mesh(mesh)
        logits = self(tokens[:, :-1])
        V = logits.shape[-1]
        nll = SoftmaxXentFunction.apply(
            logits.reshape(-1, V), tokens[:, 1:].reshape(-1).to(torch.int32))
        return nll.mean()

    def make_train_step(self, lr=1e-3, mesh=None):
        """An eager SGD step, ``step(tokens)`` → the float32 loss: every
        gradient, then each parameter updated in place by the JAX rule
        ``(p.f32 − lr·g.f32)`` cast to p's dtype.  The JAX step returns
        new parameters; updating in place is the counterpart of donating
        them."""
        _no_mesh(mesh)
        params = list(self.parameters())

        def step(tokens):
            loss = self.loss(tokens)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.copy_((p.float() - lr * g.float()).to(p.dtype))
            return loss.detach()

        return step
