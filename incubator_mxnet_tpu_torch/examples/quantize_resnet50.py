"""Int8 post-training quantization of ResNet-50 on one GPU, end to end:
the counterpart of the JAX package's ``examples/quantize_resnet50.py``
(reference example/quantization/imagenet_gen_qsym_mkldnn.py and the
python/mxnet/contrib/quantization.py flow).

It builds the zoo's float net from ``mx.random.seed(0)`` and hybridizes
it, then for each calibration mode (``naive``: min/max, ``entropy``: the
KL-optimal clip) builds it again, calibrates and converts it with
``contrib.quantization.quantize_net`` (every ``Conv2D`` and ``Dense``
but ``--exclude-layers`` runs the hand-written int8 kernels:
quantize, the int8 tensor-core convolution, dequantize), hybridizes it
and evaluates it.  One JSON line a mode: top-1 agreement with the float
net, and float against int8 img/s, each timed over the evaluation
batches after one warm-up call, with the read-back of one value inside
the window, as the JAX script times them.  Calibration (host numpy in
``entropy`` mode) stays outside every timed window.

The data is ``RandomState(0).rand`` images, as in the JAX script: top-1
agreement with the float net stands in for the top-1 delta.
``--data-rec`` (an ImageNet ``.rec`` for a true top-1) is not ported:
a missing file raises, as it would in the JAX script, and a present one
raises ``NotImplementedError``.

Usage:
    python -m incubator_mxnet_tpu_torch.examples.quantize_resnet50
    python -m incubator_mxnet_tpu_torch.examples.quantize_resnet50 \\
        --fuse-bn --modes naive

It runs on ``cuda:0`` and raises without a card; ``--device cpu`` (or
``--cpu``, the JAX script's flag) runs it on the CPU, for tests at a
tiny size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import random as mx_random
from ..context import resolve_device
from ..contrib.quantization import quantize_net
from ..gluon.model_zoo import vision

__all__ = ["build_net", "top1", "imgs_per_sec", "run", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="resnet50_v1")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--modes", default="naive,entropy")
    p.add_argument("--fuse-bn", action="store_true",
                   help="fold BatchNorm into the convolutions before "
                        "calibration (fewer layers to calibrate; the "
                        "standard deploy-quantization flow)")
    p.add_argument("--exclude-layers", default="output",
                   help="comma-separated layer names kept float (default: "
                        "the classifier head, as the reference examples' "
                        "excluded_sym_names)")
    p.add_argument("--data-rec", default=None,
                   help="an ImageNet .rec for a true top-1 (not ported)")
    p.add_argument("--device", default=None,
                   help="cuda:0 unless given; 'cpu' for a test run")
    p.add_argument("--cpu", action="store_true",
                   help="the JAX script's flag: --device cpu")
    return p.parse_args(argv)


def build_net(model, image_size, device, fuse_bn=False):
    """The zoo's ``model`` from ``mx.random.seed(0)`` on ``device``, its
    deferred shapes resolved by one forward, BatchNorm folded where asked,
    hybridized."""
    mx_random.seed(0)
    net = getattr(vision, model)()
    net.initialize(device=device)
    with torch.no_grad():
        net(torch.zeros(1, 3, image_size, image_size, device=device))
    if fuse_bn:
        from ..gluon.contrib import fuse_conv_bn
        fuse_conv_bn(net)
    net.hybridize()
    return net


def top1(net, batches):
    """The arg-max class of each image, a numpy array a batch."""
    with torch.no_grad():
        return [net(x).argmax(1).cpu().numpy() for x in batches]


def imgs_per_sec(net, batches):
    """img/s over ``batches`` after one warm-up call, the read-back of one
    value inside the window."""
    with torch.no_grad():
        float(net(batches[0]).reshape(-1)[0])        # warm-up, and a wait
        t0 = time.perf_counter()
        for x in batches:
            out = net(x)
        float(out.reshape(-1)[0])
        dt = time.perf_counter() - t0
    return sum(len(x) for x in batches) / dt


def run(args, keep=None):
    """The example's flow → its result lines, as dicts.  ``keep``, where
    given, receives the float net under ``"float"`` and each quantized
    net under its mode, and the evaluation batches under ``"eval"``."""
    if args.data_rec is not None:
        if not os.path.exists(args.data_rec):
            raise FileNotFoundError(args.data_rec)
        raise NotImplementedError("--data-rec: top-1 against ImageNet "
                                  "labels is not ported (ROADMAP §A)")
    device = resolve_device("cpu" if args.cpu else args.device)
    platform = "gpu" if device.type == "cuda" else device.type
    print(f"[int8] platform={platform} device={device}", file=sys.stderr,
          flush=True)
    rng = np.random.RandomState(0)
    shape = (args.batch, 3, args.image_size, args.image_size)
    eval_x = [torch.tensor(rng.rand(*shape).astype(np.float32),
                           device=device) for _ in range(args.eval_batches)]
    calib_x = eval_x[:args.calib_batches]
    exclude = tuple(args.exclude_layers.split(",")) \
        if args.exclude_layers else ()

    float_net = build_net(args.model, args.image_size, device, args.fuse_bn)
    ref_pred = top1(float_net, eval_x)
    float_ips = imgs_per_sec(float_net, eval_x)
    print(f"[int8] float baseline {float_ips:.1f} img/s", file=sys.stderr,
          flush=True)
    if keep is not None:
        keep.update(float=float_net, eval=eval_x)
    else:
        del float_net

    results = []
    for mode in args.modes.split(","):
        print(f"[int8] calibrating mode={mode}...", file=sys.stderr,
              flush=True)
        qnet = quantize_net(
            build_net(args.model, args.image_size, device, args.fuse_bn),
            calib_data=calib_x, calib_mode=mode, exclude_layers=exclude,
            num_calib_batches=args.calib_batches)
        qnet.hybridize()
        q_pred = top1(qnet, eval_x)
        agree = float(np.mean([(a == b).mean()
                               for a, b in zip(ref_pred, q_pred)]))
        q_ips = imgs_per_sec(qnet, eval_x)
        line = {"model": args.model, "platform": platform,
                "calib_mode": mode, "batch": args.batch,
                "top1_agreement_vs_float": round(agree, 4),
                "float_img_per_sec": round(float_ips, 2),
                "int8_img_per_sec": round(q_ips, 2),
                "speedup": round(q_ips / float_ips, 3)}
        print(json.dumps(line), flush=True)
        results.append(line)
        if keep is not None:
            keep[mode] = qnet
        else:
            del qnet
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
