"""SSD object detection training (counterpart of ``examples/train_ssd.py``;
BASELINE config 4, reference ``example/ssd``), with the same flags plus
``--device`` and ``--seed``.

Usage:
    python -m incubator_mxnet_tpu_torch.examples.train_ssd --smoke \\
        --device cpu
    python -m incubator_mxnet_tpu_torch.examples.train_ssd
    python -m incubator_mxnet_tpu_torch.examples.train_ssd --steps 500 \\
        --batch-size 32

Trains the JAX example's two-scale SSD (2 classes, base width 8) with
Adam on its synthetic scene: uniform images, one box an image whose
class says which corner it sits in.  Anchors come from
``multibox_prior``, targets from ``multibox_target`` (hard negative
mining 3:1), the loss is ``SSDLoss``; at the end ``SSD.detections`` (the
softmax kernel on the card, then ``multibox_detection``) decodes the
last batch.  ``--smoke``: B=2, 25 steps, 32x32.

Runs on ``cuda:0`` unless given ``--device cpu``, and raises
``DeviceUnavailableError`` without a CUDA device.  ``random.seed(--seed)``
seeds the weights and the images.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import autograd, random
from ..context import resolve_device
from ..gluon import Trainer
from ..models.ssd import SSD, SSDLoss

__all__ = ["ssd_net", "synthetic_labels", "main"]


def ssd_net():
    """The example's network: two scales, sizes (0.3, 0.4) and (0.6,
    0.7), ratios (1, 2), 2 classes, base width 8."""
    return SSD(num_classes=2, sizes=((0.3, 0.4), (0.6, 0.7)),
               ratios=((1, 2),) * 2, base_channels=8)


def synthetic_labels(batch_size):
    """The JAX example's labels (B, 1, 5) float32 numpy: image i holds
    one box of class i % 2, at 0.1 (class 0) or 0.5 (class 1) with side
    0.35."""
    boxes = []
    for i in range(batch_size):
        cls = i % 2
        base = 0.1 if cls == 0 else 0.5
        boxes.append([[cls, base, base, base + 0.35, base + 0.35]])
    return np.array(boxes, np.float32)


def main(argv=None):
    """Train, print the loss every 10 steps, ``loss a -> b`` and the
    detections of image 0 → ``{"losses": [...], "detections": (B, N, 6)
    numpy}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny synthetic run")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch_size, args.steps, args.image_size = 2, 25, 32
    device = resolve_device(args.device)
    random.seed(args.seed)

    net = ssd_net()
    net.initialize(device=device)
    lossfn = SSDLoss()
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": args.lr})

    bsz, size = args.batch_size, args.image_size
    x = random.uniform(shape=(bsz, 3, size, size), device=device)
    labels = torch.from_numpy(synthetic_labels(bsz)).to(device)

    losses = []
    for step in range(args.steps):
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loc_t, loc_m, cls_t = net.targets(anchors, labels, cls_preds)
            loss = lossfn(cls_preds, box_preds, cls_t, loc_t, loc_m)
        autograd.backward(loss)
        trainer.step(bsz)
        losses.append(loss.mean().item())
        if step % 10 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)

    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    det = net.detections(cls_preds, box_preds, anchors).cpu().numpy()
    kept = det[0][det[0][:, 1] > 0.3]
    print(f"detections on image 0: {len(kept)} above 0.3 confidence")
    print("done")
    return {"losses": losses, "detections": det}


if __name__ == "__main__":
    main()
