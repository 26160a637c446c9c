"""Two measurements of the port against the JAX package on the CPU, run
by hand (they take minutes, and print numbers rather than assert them):

    python tests/torch_reference_checks.py [bottleneck] [resnet50]

1. ``bottleneck``: the stage-1 identity ``BottleneckV1`` at full width
   (B=4, 56x56, 256 -> 64 -> 256 channels, NHWC, fused), built in JAX
   from a seed and carried to the port with ``params_from_jax``; one
   training forward and backward of ``(out * out).mean()`` at x and at
   x + 1e-6, from the JAX package's seed-1 weights and from the port's
   (those ``chip_smoke.py`` phase 7 uses).  Printed per gradient tensor,
   as max |d| over its largest value: each package's own response to
   the move, and port against JAX at x.
2. ``resnet50``: ``resnet50_v1(layout="NHWC", fused=True)`` (1000
   classes) built in JAX from a seed and carried across, B=4 at 64x64,
   six SGD steps through each package's ``FusedTrainStep`` on one
   batch, with the bench's settings (lr 0.1, momentum 0.9, wd 1e-4) and
   with ``examples/train_resnet_fused.py``'s (lr 0.01, momentum 0.9);
   then the port again from x + 1e-6.  Printed: the loss at each step
   in each run.

The JAX package runs its XLA compositions of the fused kernels
(``MXNET_USE_PALLAS=0``, ``MXNET_FUSED_CONV3=0``): the functions its
Pallas kernels compute, which the port's tests hold the kernels to.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["MXNET_USE_PALLAS"] = "0"
os.environ["MXNET_FUSED_CONV3"] = "0"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import autograd as jax_autograd  # noqa: E402
from incubator_mxnet_tpu import gluon as jax_gluon  # noqa: E402
from incubator_mxnet_tpu import nd  # noqa: E402
from incubator_mxnet_tpu.fuse import make_fused_train_step as jax_fused  # noqa: E402,E501
from incubator_mxnet_tpu.gluon.model_zoo.vision import (  # noqa: E402
    resnet as jax_resnet)

from incubator_mxnet_tpu_torch import autograd  # noqa: E402
from incubator_mxnet_tpu_torch.convert import (  # noqa: E402
    grads_to_numpy, params_from_jax)
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step  # noqa: E402,E501
from incubator_mxnet_tpu_torch.gluon.loss import (  # noqa: E402
    SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (  # noqa: E402
    resnet)

MOVE = np.float32(1e-6)
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _weights(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _ratio(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def bottleneck():
    x = np.random.RandomState(1).rand(4, 56, 56, 256).astype(np.float32)
    mx.random.seed(1)
    jblk = jax_resnet.BottleneckV1(256, 1, False, in_channels=256,
                                   layout="NHWC", fused=True)
    jblk.initialize(ctx=mx.cpu())
    jblk.hybridize()
    jblk(nd.array(x[:1]))
    port_seed1 = resnet.BottleneckV1(256, 1, False, in_channels=256,
                                     layout="NHWC", fused=True).initialize(
        device="cpu", generator=torch.Generator().manual_seed(1))
    sources = {"the JAX package's seed-1 weights": _weights(jblk),
               "the port's seed-1 weights (chip_smoke.py phase 7)": {
                   k: p.detach().numpy().copy()
                   for k, p in port_seed1.named_parameters()}}

    def jax_grads(weights, xin):
        for k, p in jblk.collect_params().items():
            p.set_data(nd.array(weights[k]))
        with jax_autograd.record():
            out = jblk(nd.array(xin))
            loss = (out * out).mean()
        loss.backward()
        return {k: p.grad().asnumpy() for k, p in
                jblk.collect_params().items() if "running" not in k}

    def port_grads(weights, xin):
        blk = resnet.BottleneckV1(256, 1, False, in_channels=256,
                                  layout="NHWC", fused=True)
        params_from_jax(weights, blk)
        with autograd.record():
            out = blk(torch.from_numpy(xin))
            loss = (out * out).mean()
        autograd.backward(loss)
        return {k: v for k, v in grads_to_numpy(blk).items()
                if "running" not in k}

    for label, weights in sources.items():
        j0, j1 = jax_grads(weights, x), jax_grads(weights, x + MOVE)
        p0, p1 = port_grads(weights, x), port_grads(weights, x + MOVE)
        print(f"stage-1 identity bottleneck (4, 56, 56, 256), {label}; "
              "max|d| / max|g| per gradient:")
        print(f"  {'tensor':28s} {'JAX x vs x+1e-6':>16s} "
              f"{'port x vs x+1e-6':>17s} {'port vs JAX at x':>17s}")
        for k in j0:
            print(f"  {k:28s} {_ratio(j1[k], j0[k]):16.3e} "
                  f"{_ratio(p1[k], p0[k]):17.3e} "
                  f"{_ratio(p0[k], j0[k]):17.3e}", flush=True)


def resnet50(steps=6):
    rng = np.random.RandomState(2)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, 4).astype(np.int32)
    mx.random.seed(0)
    jnet = jax_resnet.resnet50_v1(layout="NHWC", fused=True)
    jnet.initialize(ctx=mx.cpu())
    jnet.hybridize()
    jnet(nd.array(x[:1]))
    weights = _weights(jnet)
    for name, sgd in (("bench.py", SGD),
                      ("examples/train_resnet_fused.py",
                       {"learning_rate": 0.01, "momentum": 0.9})):
        for k, p in jnet.collect_params().items():
            p.set_data(nd.array(weights[k]))
        jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(),
                          "sgd", dict(sgd))
        runs = {"JAX": [float(jstep(nd.array(x), nd.array(y)))
                        for _ in range(steps)]}
        for label, xin in (("port", x), ("port, x + 1e-6", x + MOVE)):
            net = resnet.resnet50_v1(layout="NHWC", fused=True)
            params_from_jax(weights, net)
            step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(),
                                         "sgd", dict(sgd), device="cpu")
            runs[label] = [step(torch.from_numpy(xin),
                                torch.from_numpy(y)).item()
                           for _ in range(steps)]
        print(f"ResNet-50 v1 NHWC fused, B=4, 64x64, {name}'s SGD {sgd}, "
              "loss per step:")
        for label, losses in runs.items():
            print(f"  {label:16s} " + " ".join(f"{v:.6f}" for v in losses),
                  flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    todo = sys.argv[1:] or ["bottleneck", "resnet50"]
    for name in todo:
        {"bottleneck": bottleneck, "resnet50": resnet50}[name]()
