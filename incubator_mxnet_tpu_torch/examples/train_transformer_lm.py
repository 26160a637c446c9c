"""Train the TransformerLM on random tokens (counterpart of
``examples/train_transformer_lm.py``, on one device).

Usage:
    python -m incubator_mxnet_tpu_torch.examples.train_transformer_lm \\
        --smoke --device cpu
    python -m incubator_mxnet_tpu_torch.examples.train_transformer_lm \\
        --steps 20
    python -m incubator_mxnet_tpu_torch.examples.train_transformer_lm \\
        --attention flash

The configuration is the JAX example's: ``TransformerConfig()`` (vocab
32000, d_model 512, 8 heads, 4 layers, d_ff 2048, bfloat16) at B=32,
T=1025, SGD at lr 1e-3; ``--smoke`` takes its small float32 config at
B=8, T=33 for 3 steps.  Runs on ``cuda`` unless given ``--device cpu``,
and raises ``DeviceUnavailableError`` without a CUDA device.  The
weights come from a ``torch.Generator`` seeded with ``--seed``, and each
step draws fresh tokens from a second one seeded with ``--seed`` + 1,
as the JAX example draws them from its key.  ``--attention`` is
``gspmd`` (the default) or ``flash`` (the flash-attention kernels);
``ring`` and the device mesh flags (``--dp/--tp/--pp/--sp`` other than
1) raise: distribution is not ported yet.
"""
from __future__ import annotations

import argparse

import torch

from ..context import resolve_device
from ..models.transformer import TransformerConfig, TransformerLM

__all__ = ["config", "main"]


def config(smoke=False, attention="gspmd"):
    """``(TransformerConfig, batch, sequence length)`` of the example."""
    if smoke:
        return (TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                  n_layers=2, d_ff=128, max_len=64,
                                  dtype="float32", attention=attention),
                8, 33)
    return TransformerConfig(attention=attention), 32, 1025


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--attention", default="gspmd",
                    choices=["gspmd", "ring", "flash"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = dict(dp=args.dp, tp=args.tp, pp=args.pp, sp=args.sp)
    if any(v != 1 for v in mesh.values()):
        raise NotImplementedError(
            f"mesh {mesh}: a device mesh is not ported yet (ROADMAP item "
            "11, distribution); every axis must be 1")
    cfg, batch, seq = config(args.smoke, args.attention)
    steps = 3 if args.smoke else args.steps
    model = TransformerLM(cfg).init(
        torch.Generator().manual_seed(args.seed), device)
    step = model.make_train_step(lr=1e-3)
    tokens_gen = torch.Generator().manual_seed(args.seed + 1)
    losses = []
    for i in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=tokens_gen).to(device)
        losses.append(float(step(tokens)))
        print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    print("done")
    return losses


if __name__ == "__main__":
    main()
