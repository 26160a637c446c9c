"""Train ResNet-50 v1 on the fused-bottleneck path with the eager Trainer
(counterpart of ``examples/train_resnet_fused.py``, its eager branch,
with the same flags).

    net = resnet50_v1(layout="NHWC", fused=True)

In train mode each bottleneck runs ``fused_bottleneck_v1[_proj]``
(``ops/fused_block.py``): its 1x1 convolutions are the fused matmul +
BatchNorm kernels, which take the BN batch statistics from their
epilogue and the previous BN's normalize + ReLU in their prologue; its
3x3 is PyTorch's convolution.  SGD with momentum (lr 0.01, momentum
0.9) memorizes one synthetic batch, and the run checks that the loss is
finite and that some step after the first reaches a lower loss than
the first (tiny-batch BN makes the loss oscillate, so the last step is
no reliable probe).

Usage:
    python -m incubator_mxnet_tpu_torch.examples.train_resnet_fused \\
        [--batch 8] [--image-size 64] [--steps 4] [--classes 100] [--cpu]

Runs on ``cuda:0`` unless given ``--cpu``, and raises
``DeviceUnavailableError`` without a CUDA device.  The weights come
from a ``torch.Generator`` seeded with 0 and the batch from numpy's
seed 0.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import autograd
from ..context import resolve_device
from ..gluon import Trainer
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo.vision.resnet import resnet50_v1

__all__ = ["synthetic_batch", "build", "train_step", "main"]

LR, MOMENTUM = 0.01, 0.9


def synthetic_batch(batch, image_size, classes, seed=0):
    """The example's fixed batch as numpy arrays: images ``(B, S, S, 3)``
    float32 in [0, 1) (NHWC) and int32 labels ``(B,)``."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, image_size, image_size, 3).astype(np.float32)
    y = rng.randint(0, classes, batch).astype(np.int32)
    return x, y


def build(classes, device, seed=0):
    """``(net, trainer, loss_fn)``: ResNet-50 v1, NHWC, fused, with
    weights from ``seed``, on ``device``; SGD lr 0.01, momentum 0.9."""
    net = resnet50_v1(classes=classes, layout="NHWC", fused=True)
    net.initialize(device=device, generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": LR, "momentum": MOMENTUM})
    return net, trainer, SoftmaxCrossEntropyLoss()


def train_step(net, trainer, loss_fn, x, y):
    """One step: forward and loss in train mode, backward, update.
    Returns the per-sample loss (not synchronised)."""
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--classes", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    net, trainer, loss_fn = build(args.classes, device)
    x, y = (torch.from_numpy(a).to(device) for a in
            synthetic_batch(args.batch, args.image_size, args.classes))
    losses = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = train_step(net, trainer, loss_fn, x, y)
        losses.append(loss.mean().item())
    dt = time.perf_counter() - t0

    assert all(np.isfinite(v) for v in losses), losses
    if len(losses) > 1:
        assert min(losses[1:]) < losses[0], losses
    print(json.dumps({
        "example": "train_resnet_fused",
        "device": str(device),
        "losses": [round(v, 4) for v in losses],
        "img_per_sec": round(args.batch * args.steps / dt, 2),
    }))
    print("done")
    return losses


if __name__ == "__main__":
    main()
