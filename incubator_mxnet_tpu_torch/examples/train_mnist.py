"""LeNet on MNIST-style digits (counterpart of ``examples/train_mnist.py``,
with the same flags plus ``--device`` and ``--seed``).

Usage:
    python -m incubator_mxnet_tpu_torch.examples.train_mnist --smoke \\
        --device cpu
    python -m incubator_mxnet_tpu_torch.examples.train_mnist
    python -m incubator_mxnet_tpu_torch.examples.train_mnist \\
        --dataset digits        # real data; needs scikit-learn

The Gluon path end to end: layers whose input sizes are left to the
first batch (deferred initialisation), ``hybridize()`` (a no-op),
``DataLoader`` over an ``ArrayDataset``, ``Trainer(kvstore="device")``
with Adam, ``SoftmaxCrossEntropyLoss`` (the cross-entropy kernels on
the card) and ``metric.Accuracy``.  The default data is the JAX
example's: 8192 random 28x28 images with random float32 labels, 2
epochs at B=64 (``--smoke``: 256 samples, 1 epoch).  ``--dataset
digits`` trains on scikit-learn's 1797 handwritten 8x8 digits, split
80/20, and asserts ``--target-acc`` held-out top-1.

Runs on ``cuda:0`` unless given ``--device cpu``, and raises
``DeviceUnavailableError`` without a CUDA device.  ``random.seed(--seed)``
seeds the weights and the shuffling; the synthetic data comes from
numpy, seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import autograd, random
from ..context import resolve_device
from ..gluon import Trainer, data, metric, nn
from ..gluon.loss import SoftmaxCrossEntropyLoss

__all__ = ["lenet", "synthetic_data", "load_digits_data", "train_step",
           "run_epoch", "main"]


def lenet():
    """The example's network: conv 32 and conv 64 (3x3, ReLU, each
    followed by a 2x2 max pool), dense 128 (ReLU), dense 10; every
    input size deferred to the first batch."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(32, 3, padding=1, activation="relu"),
            nn.MaxPool2D(2),
            nn.Conv2D(64, 3, padding=1, activation="relu"),
            nn.MaxPool2D(2), nn.Flatten(),
            nn.Dense(128, activation="relu"), nn.Dense(10))
    return net


def synthetic_data(n, seed=0):
    """``n`` uniform 28x28 images (N, 1, 28, 28) and random labels in
    [0, 10), both float32 numpy, as the JAX example makes them."""
    rng = np.random.RandomState(seed)
    images = rng.rand(n, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, (n,)).astype(np.float32)
    return images, labels


def load_digits_data():
    """scikit-learn's handwritten digits, NCHW in [0, 1], a fixed 80/20
    split → ``((train images, labels), (test images, labels))``."""
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)[:, None, :, :]
    y = d.target.astype(np.float32)
    idx = np.random.RandomState(42).permutation(len(x))
    n_test = len(x) // 5
    test, train = idx[:n_test], idx[n_test:]
    return (x[train], y[train]), (x[test], y[test])


def train_step(net, trainer, loss_fn, x, y, batch_size):
    """One step: forward and loss under ``autograd.record()``,
    backward, ``trainer.step(batch_size)`` → ``(per-sample loss,
    logits)``."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    autograd.backward(loss)
    trainer.step(batch_size)
    return loss, out


def run_epoch(net, loader, trainer, loss_fn, acc, device, batch_size,
              on_step=None):
    """One pass over ``loader``: each batch goes to ``device`` and
    through :func:`train_step`, and into ``acc``.  ``on_step(loss,
    logits)``, where given, sees every step."""
    for x, y in loader:
        x = x.to(device, non_blocking=True)
        y = y.to(device, non_blocking=True)
        loss, out = train_step(net, trainer, loss_fn, x, y, batch_size)
        acc.update([y], [out])
        if on_step is not None:
            on_step(loss, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: 2 synthetic, 40 digits")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dataset", choices=["synthetic", "digits"],
                    default="synthetic")
    ap.add_argument("--target-acc", type=float, default=0.97,
                    help="asserted held-out top-1 for --dataset digits")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny synthetic run")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    random.seed(args.seed)

    net = lenet()
    net.initialize(device=device)
    net.hybridize()

    if args.dataset == "digits":
        (images, labels), (timages, tlabels) = load_digits_data()
        epochs = args.epochs if args.epochs is not None else 40
    else:
        images, labels = synthetic_data(256 if args.smoke else 8192,
                                        args.seed)
        timages = tlabels = None
        epochs = 1 if args.smoke else (
            args.epochs if args.epochs is not None else 2)
    n = len(images)

    bs = args.batch_size
    loader = data.DataLoader(data.ArrayDataset(images, labels),
                             batch_size=bs, shuffle=True,
                             last_batch="discard",
                             pin_memory=device.type == "cuda")
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": args.lr}, kvstore="device")
    loss_fn = SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    results = []
    for epoch in range(epochs):
        acc.reset()
        t0 = time.time()
        run_epoch(net, loader, trainer, loss_fn, acc, device, bs)
        name, value = acc.get()
        results.append(value)
        print(f"epoch {epoch}: {name}={value:.3f} "
              f"({n / (time.time() - t0):.0f} samples/s)", flush=True)

    if timages is not None:
        acc.reset()
        with autograd.pause():
            for i in range(0, len(timages), bs):
                x = torch.from_numpy(timages[i:i + bs]).to(device)
                acc.update([tlabels[i:i + bs]], [net(x)])
        _, test_acc = acc.get()
        print(f"RESULT digits_test_top1 {test_acc:.4f} "
              f"(target {args.target_acc}) device={device}")
        if test_acc < args.target_acc:
            raise SystemExit(f"held-out top-1 {test_acc:.4f} < target "
                             f"{args.target_acc}")
    print("done")
    return results


if __name__ == "__main__":
    main()
