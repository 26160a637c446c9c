"""ResNet v2's fused pre-activation bottleneck through the port, against
the JAX package and against the port's own layers, on the CPU.

* ``BottleneckV2(32, stride, downsample, in_channels=32, layout="NHWC",
  fused=True)``, stride 1 (identity) and stride 2 (projection, the 3x3
  as PyTorch's convolution): the training forward, every gradient of
  ``(y*y).mean()`` and bn1-3's moving statistics after it, against the
  JAX fused block (its Pallas 1x1 kernels in interpret mode,
  ``MXNET_USE_PALLAS=1``, its stride-1 3x3 through the XLA composition,
  ``MXNET_FUSED_CONV3=0``: the configuration the port ports), the
  weights carried by ``params_from_jax``.
* The same block against the port's unfused block (``fused=False``,
  the same weights), as the JAX package's
  ``tests/test_fused_block.py::test_zoo_fused_bottleneck_v2_matches_unfused``
  holds its own, at its tolerances.
* A ResNet-50 v2-shaped net of one bottleneck a stage,
  ``ResNetV2(BottleneckV2, [1, 1, 1, 1], [16, 32, 64, 128, 256],
  classes=10, layout="NHWC", fused=True)`` at 64x64, B=4: the
  predict-mode logits, then one training step: the loss, every gradient
  and every moving statistic, against the hybridized JAX model
  (``MXNET_USE_PALLAS=0``, ``MXNET_FUSED_CONV3=0``: the XLA compositions
  of its kernels, which the block test holds the port against in
  interpret mode).

Inputs come from numpy with a seed.  Tolerances, max |port - JAX| over
the largest |JAX| value of each tensor, float32 (the same formulas,
sums in another order): the block's output and moving statistics 1e-5,
its gradients 1e-4 (each passes through three BatchNorm backwards over
128 or 32 rows); the fused block against the unfused one as the JAX
test: y rtol=atol=2e-3, conv1's weight gradient rtol 2e-2 atol 2e-3,
moving statistics rtol 1e-3 atol 1e-4 (the fused BNs take one-pass
float32 statistics from sums, the layers from means); the small net's
logits and loss 1e-5, gradients and moving statistics MODEL_TOL = 2e-4,
as ``tests/test_torch_resnet_train.py`` holds the v1 net.  The stem BN's
gamma is held to MODEL_TOL of the stem beta's largest gradient instead
of its own: its exact gradient is zero but for BN's eps (with beta at
0, ReLU and max-pool commute with its scale, and the first block's bn1
normalizes it away), so both packages return a cancellation, 6e-6 of
the model's largest gradient and 1.3e-3 of the stem beta's, on which
they differ by 14 % of itself (1.8e-4 of the stem beta's largest).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV2, ResNetV2)

OP_TOL = 1e-5
BLOCK_GRAD_TOL = 1e-4
MODEL_TOL = 2e-4
LAYERS, CHANNELS = [1, 1, 1, 1], [16, 32, 64, 128, 256]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU convolutions run faster on one thread than on many that
    other processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}"


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _running(named):
    return {k: v for k, v in named.items() if "running" in k}


def _jax_block(stride, down, x):
    mx.random.seed(0)
    jblk = jax_resnet.BottleneckV2(32, stride, down, in_channels=32,
                                   layout="NHWC", fused=True)
    jblk.initialize(ctx=mx.cpu())
    jblk(nd.array(x))               # resolve shapes through the layers
    return jblk


def _port_step(blk, x):
    with autograd.record():
        y = blk(torch.tensor(x))
        loss = (y * y).mean()
    autograd.backward(loss)
    return y.detach().numpy(), grads_to_numpy(blk), _running(
        params_to_numpy(blk))


@pytest.mark.parametrize("stride,down", [(1, False), (2, True)])
def test_fused_bottleneck_v2_matches_jax(monkeypatch, stride, down):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    monkeypatch.setenv("MXNET_FUSED_CONV3", "0")
    x = np.random.RandomState(3).rand(2, 8, 8, 32).astype(np.float32)
    jblk = _jax_block(stride, down, x)
    blk = BottleneckV2(32, stride, down, in_channels=32, layout="NHWC",
                       fused=True)
    params_from_jax(_jax_params(jblk), blk)
    with jax_autograd.record():
        jy = jblk(nd.array(x))
        jloss = (jy * jy).mean()
    jloss.backward()
    y, grads, running = _port_step(blk, x)

    _close(y, jy.asnumpy(), OP_TOL, "y")
    want = {k: p.grad().asnumpy() for k, p in jblk.collect_params().items()
            if p.grad_req != "null"}
    assert len(want) == (10 if down else 9)
    for name, g in want.items():
        _close(grads[name], g, BLOCK_GRAD_TOL, name)
    jp = _jax_params(jblk)
    assert len(running) == 6
    for name, v in running.items():
        _close(v, jp[name], OP_TOL, name)
        assert not np.allclose(v, 0.0 if "mean" in name else 1.0), name


@pytest.mark.parametrize("stride,down", [(1, False), (2, True)])
def test_fused_bottleneck_v2_matches_unfused(stride, down):
    x = np.random.RandomState(5).rand(2, 8, 8, 32).astype(np.float32)
    blocks = [BottleneckV2(32, stride, down, in_channels=32, layout="NHWC",
                           fused=fused) for fused in (True, False)]
    blocks[0].initialize(device="cpu",
                         generator=torch.Generator().manual_seed(0))
    blocks[1].initialize(device="cpu")
    params_from_jax(params_to_numpy(blocks[0]), blocks[1])
    (yf, gf, rf), (yu, gu, ru) = (_port_step(b, x) for b in blocks)
    np.testing.assert_allclose(yf, yu, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(gf["conv1.weight"], gu["conv1.weight"],
                               rtol=2e-2, atol=2e-3)
    for name in rf:
        np.testing.assert_allclose(rf[name], ru[name], rtol=1e-3, atol=1e-4)


def _batch():
    rng = np.random.RandomState(4)
    return (rng.rand(4, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, 4).astype(np.int32))


def _net_grads(net, x, y):
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(torch.tensor(x)),
                                         torch.tensor(y))
    autograd.backward(loss)
    return loss, grads_to_numpy(net)


def test_small_resnet_v2_trains_like_jax(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "0")
    monkeypatch.setenv("MXNET_FUSED_CONV3", "0")
    x, y = _batch()
    mx.random.seed(0)
    jnet = jax_resnet.ResNetV2(jax_resnet.BottleneckV2, LAYERS, CHANNELS,
                               classes=10, layout="NHWC", fused=True)
    jnet.initialize(ctx=mx.cpu())
    jnet.hybridize()
    want = jnet(nd.array(x)).asnumpy()      # resolves the deferred shapes
    net = ResNetV2(BottleneckV2, LAYERS, CHANNELS, classes=10, layout="NHWC",
                   fused=True)
    params_from_jax(_jax_params(jnet), net)
    _close(net(torch.tensor(x)).detach().numpy(), want, OP_TOL, "logits")

    with jax_autograd.record():
        jloss = jax_gluon.loss.SoftmaxCrossEntropyLoss()(jnet(nd.array(x)),
                                                        nd.array(y))
    jloss.backward()
    want = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()
            if p.grad_req != "null"}
    loss, got = _net_grads(net, x, y)
    np.testing.assert_allclose(loss.detach().numpy(), jloss.asnumpy(),
                               rtol=OP_TOL)
    assert len(want) == 47
    for name, g in want.items():
        if name == "features.2.gamma":      # the stem BN's: it cancels
            err = np.abs(got[name] - g).max()
            assert err <= MODEL_TOL * np.abs(want["features.2.beta"]).max()
        else:
            _close(got[name], g, MODEL_TOL, name)
    jp = _jax_params(jnet)
    running = _running(params_to_numpy(net))
    assert len(running) == 30
    for name, v in running.items():
        _close(v, jp[name], MODEL_TOL, name)
