"""BERT-style masked-LM + NSP pretraining on synthetic token streams
(counterpart of ``examples/train_bert.py``, with the same flags plus
``--device`` and ``--seed``).

Usage:
    python -m incubator_mxnet_tpu_torch.examples.train_bert --smoke \\
        --device cpu
    python -m incubator_mxnet_tpu_torch.examples.train_bert --steps 1000 \\
        --units 768 --layers 12

Runs on ``cuda`` unless given ``--device cpu``, and raises
``DeviceUnavailableError`` without a CUDA device.  The weights, the
batch and the dropout draws all come from ``--seed``: the weights from a
``torch.Generator`` on the CPU, the batch from numpy, dropout from a
``torch.Generator`` on the training device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import amp, autograd
from ..context import resolve_device
from ..gluon import Trainer, nn
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..models.bert import BERTModel

__all__ = ["synthetic_batch", "pretraining_loss", "use_dropout_generator",
           "main"]


def synthetic_batch(batch_size, seq_len, vocab, seed=0):
    """The example's fixed batch, as numpy int32 arrays: ``(masked tokens
    (B, T), MLM labels (B·T,), NSP labels (B,))``.  Tokens are drawn
    from [3, vocab); 15 % of positions are masked to id 0."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(3, vocab, (batch_size, seq_len)).astype(np.int32)
    nsp = (rng.rand(batch_size) > 0.5).astype(np.int32)
    masked = tokens.copy()
    masked[rng.rand(batch_size, seq_len) < 0.15] = 0   # [MASK] id
    return masked, tokens.reshape(-1), nsp


def pretraining_loss(net, ce, x, y_mlm, y_nsp):
    """Mean MLM loss over every position plus mean NSP loss."""
    b, t = x.shape
    mlm_logits, nsp_logits = net(x)
    return (ce(mlm_logits.reshape(b * t, -1), y_mlm).mean()
            + ce(nsp_logits, y_nsp).mean())


def use_dropout_generator(net, generator):
    """Make every ``Dropout`` of ``net`` draw from ``generator``."""
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m.generator = generator


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--units", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--amp", action="store_true", help="bf16 AMP")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.batch_size, args.seq_len, args.vocab = 4, 16, 60
        args.units, args.layers, args.heads, args.steps = 32, 2, 2, 30

    net = BERTModel(vocab_size=args.vocab, num_layers=args.layers,
                    units=args.units, hidden_size=args.units * 4,
                    num_heads=args.heads, max_length=args.seq_len,
                    dropout=0.0 if args.smoke else 0.1)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(args.seed))
    if args.amp:
        amp.convert_block(net, "bfloat16")
    use_dropout_generator(
        net, torch.Generator(device=device).manual_seed(args.seed))
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": args.lr})
    ce = SoftmaxCrossEntropyLoss()
    x, y_mlm, y_nsp = (torch.from_numpy(a).to(device) for a in
                       synthetic_batch(args.batch_size, args.seq_len,
                                       args.vocab, args.seed))

    first = last = None
    for step in range(args.steps):
        with autograd.record():
            loss = pretraining_loss(net, ce, x, y_mlm, y_nsp)
        autograd.backward(loss)
        trainer.step(args.batch_size)
        v = loss.item()
        first = first if first is not None else v
        last = v
        if step % 10 == 0:
            print(f"step {step:4d}  loss {v:.4f}", flush=True)
    print(f"loss {first:.4f} -> {last:.4f}")
    print("done")
    return first, last


if __name__ == "__main__":
    main()
