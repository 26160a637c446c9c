"""Model-zoo inference throughput on one GPU: the counterpart of the JAX
package's ``examples/benchmark_score.py`` (the reference's
``example/image-classification/benchmark_score.py``, whose numbers fill
its perf tables).

For each (model, batch size) it builds the zoo's net on the card from
seed 0, resolves its deferred shapes with one forward, converts it to
bfloat16 by ``amp.convert_block`` (``--dtype bfloat16``, the default),
and times ``--steps`` eval forwards under ``torch.inference_mode()``
after ``--warmup`` ones, reading one value back to the host inside the
timed window, as the JAX script does.  Each net is hybridized, as the
JAX script hybridizes it: its first call captures one CUDA graph per
(model, batch) and the others replay it.  A model that fails prints a
``FAILED`` line and the sweep goes on, as in the reference;
``inception_v3`` wants ``--image-shape 3,299,299`` and fails
at the default 224x224, in the JAX package too.

Usage:
    python -m incubator_mxnet_tpu_torch.examples.benchmark_score
    python -m incubator_mxnet_tpu_torch.examples.benchmark_score \\
        --models resnet50_v1 vgg16 --batch-sizes 1 32 \\
        --image-shape 3,224,224 --dtype bfloat16

It runs on ``cuda:0`` and raises without a card; ``--device cpu`` runs
it on the CPU, for tests at a tiny size.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import amp
from ..context import resolve_device
from ..gluon.model_zoo import vision

__all__ = ["score", "main"]


def score(model_name, batch_size, image_shape, dtype, steps, warmup,
          device=None, hybridize=True):
    """img/s of ``steps`` eval forwards of the zoo's ``model_name`` (a
    factory name, as ``resnet50_v1``) at ``(batch_size,) + image_shape``
    in ``dtype`` (``"float32"`` or ``"bfloat16"``) on ``device``
    (``cuda:0`` unless given), hybridized unless ``hybridize`` is False,
    from the first forward's launch to the host read of one output value
    after the last."""
    device = resolve_device(device)
    net = getattr(vision, model_name)()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():       # resolve deferred shapes
        net(torch.tensor(rng.rand(1, *image_shape), dtype=torch.float32,
                         device=device))
    if dtype == "bfloat16":
        amp.convert_block(net, "bfloat16")
    if hybridize:
        net.hybridize()
    x = torch.tensor(rng.rand(batch_size, *image_shape),
                     dtype=getattr(torch, dtype), device=device)
    with torch.inference_mode():
        out = net(x)
        float(out.reshape(-1)[0])
        for _ in range(warmup):
            out = net(x)
        float(out.reshape(-1)[0])       # waits for the warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            out = net(x)
        float(out.reshape(-1)[0])       # the read-back inside the window
        dt = time.perf_counter() - t0
    return batch_size * steps / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=[
        "alexnet", "vgg16", "inception_v3", "resnet50_v1", "resnet152_v1",
        "mobilenet1_0", "densenet121", "squeezenet1_1"])
    ap.add_argument("--batch-sizes", nargs="+", type=int,
                    default=[1, 32, 64, 128])
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda:0 unless given; 'cpu' for a test run")
    args = ap.parse_args(argv)
    shape = tuple(int(d) for d in args.image_shape.split(","))
    device = resolve_device(args.device)    # no card: raise, not FAILED

    print(f"image_shape={shape} dtype={args.dtype}")
    for model in args.models:
        for bs in args.batch_sizes:
            try:
                ips = score(model, bs, shape, args.dtype, args.steps,
                            args.warmup, device)
                print(f"{model:16s} bs={bs:4d}  {ips:10.1f} img/s",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — keep sweeping
                print(f"{model:16s} bs={bs:4d}  FAILED: {e}", flush=True)
    print("done")


if __name__ == "__main__":
    main()
