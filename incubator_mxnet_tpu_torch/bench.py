"""ResNet-50 training throughput on one GPU: the JAX package's headline
benchmark (``bench.py``'s ``measure()``) for its fused configuration.

    python -m incubator_mxnet_tpu_torch.bench [--batch 128] [--steps 10]
        [--warmup 2] [--dtype bfloat16]

The path is ``resnet50_v1(layout="NHWC", fused=True)``, converted to
bfloat16 by ``amp.convert_block``, trained by one ``FusedTrainStep``
(SGD, lr 0.1, momentum 0.9, wd 1e-4: forward, backward, update and the
BatchNorm moving statistics in one CUDA graph per batch shape) on a
fixed random batch at 224x224 with 1000 classes.  Weights come from a
``torch.Generator`` seeded with ``--seed``, the batch from numpy's.

Prints ONE JSON line: the metric
``resnet50_train_img_per_sec_bs{B}_{dtype}_fusedblk`` (img/s from the
median step), the step times, the loss, the peak device memory, and
``mfu_pct`` over the bf16 dense tensor-core peak of the card it finds
(H100 SXM5 "HBM3" 989.4e12, H100 PCIe 756e12 FLOP/s; any other card
raises: the script does not guess).  Each timed step ends in
``torch.cuda.synchronize()``, inside the timed region, and a step
faster than the analytic floor (batch x ``TRAIN_FLOPS_PER_IMG`` / peak)
is refused as a broken sync.  ``platform``, ``kind`` and
``power_limit`` come from ``nvidia-smi``.  It runs on ``cuda:0`` and
raises without a card; ``--device cpu`` runs the same path on the CPU,
tagged ``_cpu`` and without ``mfu_pct``, for tests at a tiny size.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from . import amp
from .context import resolve_device
from .fuse import make_fused_train_step
from .gluon.loss import SoftmaxCrossEntropyLoss
from .gluon.model_zoo.vision.resnet import resnet50_v1

__all__ = ["TRAIN_FLOPS_PER_IMG", "PEAK_BF16_FLOPS", "peak_flops",
           "nvidia_smi", "build", "timed", "measure", "main"]

# ResNet-50 at 224x224: 4.089 GMAC a forward, two FLOPs a multiply-add,
# training about three forwards (the JAX package's bench.py:39)
TRAIN_FLOPS_PER_IMG = 3 * 2 * 4.089e9
# dense bf16 tensor-core FLOP/s by SKU (NVIDIA's data sheets)
PEAK_BF16_FLOPS = {"H100 SXM5": 989.4e12, "H100 PCIe": 756e12}
OPTIMIZER_PARAMS = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def peak_flops(name):
    """``(sku, bf16 FLOP/s)`` of the card named ``name``; an unknown card
    raises."""
    if "H100" in name and "HBM3" in name:
        sku = "H100 SXM5"
    elif "H100" in name and "PCIe" in name:
        sku = "H100 PCIe"
    else:
        raise ValueError(f"no bf16 peak known for {name!r}; add its data "
                         "sheet's dense rate to PEAK_BF16_FLOPS")
    return sku, PEAK_BF16_FLOPS[sku]


def nvidia_smi():
    """``(name, power limit)`` of GPU 0 as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return name, limit


def build(batch, dtype="bfloat16", device=None, image=224, classes=1000,
          seed=0, **step_kwargs):
    """``(step, x, y)``: the bench path's fused step on ``device`` and its
    fixed batch, x NHWC in ``dtype``, y int32.  ``step_kwargs`` go to
    ``make_fused_train_step`` (``chunk_steps``, ``remat``, ``donate``)."""
    device = resolve_device(device)
    net = resnet50_v1(classes=classes, layout="NHWC", fused=True)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    if dtype == "bfloat16":
        amp.init("bfloat16")
        amp.convert_block(net, "bfloat16")
    elif dtype != "float32":
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(OPTIMIZER_PARAMS), device=device,
                                 **step_kwargs)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(batch, image, image, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, classes, batch).astype(np.int32))
    return step, x.to(device, getattr(torch, dtype)), y.to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(step, x, y, steps=10, warmup=2):
    """Train ``warmup`` steps on (x, y) (on the card the first one runs
    eagerly and captures the graph), then time ``steps`` more, each
    ending in a synchronise → the result dict."""
    device = x.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(float(step(x, y)))
    warmup_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(x, y)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    batch, dtype = x.shape[0], str(x.dtype).replace("torch.", "")
    med = statistics.median(step_ms)
    img_per_sec = batch / med * 1e3
    gpu = device.type == "cuda"
    result = {
        "metric": (f"resnet50_train_img_per_sec_bs{batch}_{dtype}_fusedblk"
                   + ("" if gpu else "_cpu")),
        "value": img_per_sec, "unit": "img/s",
        "platform": "gpu" if gpu else "cpu", "batch": batch,
        "image": x.shape[1], "step_ms_median": med,
        "step_ms_min": min(step_ms), "step_ms": step_ms,
        "warmup_s": warmup_s, "losses": losses, "loss": losses[-1]}
    if gpu:
        kind, limit = nvidia_smi()
        sku, peak = peak_flops(kind)
        floor_ms = batch * TRAIN_FLOPS_PER_IMG / peak * 1e3
        if med < floor_ms:
            raise RuntimeError(
                f"median step {med:.3f} ms is below the analytic floor "
                f"{floor_ms:.3f} ms: the sync is broken; refusing to "
                "publish")
        result.update(
            kind=kind, power_limit=limit, sku=sku, peak_flops=peak,
            floor_ms=floor_ms,
            mfu_pct=100.0 * img_per_sec * TRAIN_FLOPS_PER_IMG / peak,
            peak_memory_bytes=torch.cuda.max_memory_allocated(device),
            capture_launches={str(k): v for k, v in
                              step.capture_launches.items()})
    return result


def measure(batch=128, dtype="bfloat16", steps=10, warmup=2, device=None,
            image=224, classes=1000, seed=0):
    """:func:`build` the bench path, then :func:`timed` → the result."""
    step, x, y = build(batch, dtype, device, image, classes, seed)
    return timed(step, x, y, steps, warmup)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda:0 unless given; 'cpu' for a tagged CPU run")
    args = p.parse_args(argv)
    if args.steps < 1 or args.warmup < 1:
        p.error("--steps and --warmup must be at least 1")
    result = measure(args.batch, args.dtype, args.steps, args.warmup,
                     args.device, args.image_size, args.classes, args.seed)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
