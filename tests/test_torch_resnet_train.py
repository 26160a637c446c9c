"""A small fused ResNet v1 through the port, against the JAX package, on
the CPU: the whole model, where ``tests/test_torch_resnet.py`` holds its
ops and one bottleneck of each kind.

The model is ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128,
256], classes=10, layout="NHWC", fused=True)`` at 64x64, B=4, built in
JAX from a seed; its weights go across with ``params_from_jax``.
Compared: the predict-mode logits, then 3 steps of SGD with momentum
(lr 0.01, momentum 0.9, as ``examples/train_resnet_fused.py``) on one
numpy batch: the loss, every gradient and every moving statistic at
each step.  The JAX model is hybridized and runs its 1x1 and 3x3
convolutions through the XLA compositions ``xla_matmul_bn`` and
``xla_conv3_bn`` (``MXNET_USE_PALLAS=0``, ``MXNET_FUSED_CONV3=0``): the
same functions as its Pallas kernels, which
``tests/test_torch_fused_block.py``, ``tests/test_torch_fused_conv.py``
and the bottleneck test hold the port against in interpret mode, at a
fraction of the time.

Tolerances, max |port - JAX| over the largest |JAX| value of each
tensor, float32: logits 1e-5 and loss 1e-5 relative (forwards in
another order of sums); gradients and moving statistics MODEL_TOL =
2e-4 at each step.  A model's gradient moves with rounding through its
chain of tiny-batch BatchNorms (the JAX package's
``tests/test_fused_block.py`` measured 0.37 of a gradient for ResNet-50
under a 1e-6 move of its input).  This test measures the same thing for
the small model in the port itself (about 1.1e-5 of the largest
gradient here) and requires it to stay below a tenth of MODEL_TOL, so
the bound sits above rounding noise; port and JAX agreed to about
1.9e-5 when the bound was set.
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
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1, ResNetV1)

FWD_TOL = 1e-5
MODEL_TOL = 2e-4
LR, MOMENTUM = 0.01, 0.9
LAYERS, CHANNELS = [1, 1, 1, 1], [16, 32, 64, 128, 256]
ENV = {"MXNET_USE_PALLAS": "0", "MXNET_FUSED_CONV3": "0"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # small products: one thread is fastest
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(4)
    return (rng.rand(4, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, 4).astype(np.int32))


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model after one predict-mode forward: ``(net, weights,
    logits)``, then hybridized for training."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mx.random.seed(0)
        net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                                  classes=10, layout="NHWC", fused=True)
        net.initialize(ctx=mx.cpu())
        logits = net(nd.array(_batch()[0])).asnumpy()
        weights = {k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
    net.hybridize()
    return net, weights, logits


def _port_model(weights):
    net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=10, layout="NHWC",
                   fused=True)
    params_from_jax(weights, net)
    return net


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}"


def _port_grads(net, x, y):
    net.zero_grad(set_to_none=True)
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(torch.from_numpy(x)),
                                         torch.from_numpy(y))
    autograd.backward(loss)
    return loss, grads_to_numpy(net)


def test_small_resnet_predicts_like_jax(jax_model):
    _, weights, want = jax_model
    x, _ = _batch()
    got = _port_model(weights)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 10)
    _close(got, want, FWD_TOL, "logits")


def test_small_resnet_trains_like_jax(jax_model):
    jnet, weights, _ = jax_model
    x, y = _batch()

    probe = _port_model(weights)        # the port's own rounding noise
    _, g0 = _port_grads(probe, x, y)
    probe = _port_model(weights)
    _, g1 = _port_grads(probe, x + np.float32(1e-6), y)
    noise = max(np.abs(g1[k] - g0[k]).max() / np.abs(g0[k]).max()
                for k in g0 if np.abs(g0[k]).max() > 0)
    assert noise < MODEL_TOL / 10, noise

    net = _port_model(weights)
    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "sgd",
                                 {"learning_rate": LR, "momentum": MOMENTUM},
                                 kvstore=None)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": LR, "momentum": MOMENTUM})
    jce = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    jx, jy = nd.array(x), nd.array(y)
    for step in range(3):
        with jax_autograd.record():
            jloss = jce(jnet(jx), jy)
        jloss.backward()
        want = {k: p.grad().asnumpy()
                for k, p in jnet.collect_params().items()
                if p.grad_req != "null"}
        jtrainer.step(4)
        loss, got = _port_grads(net, x, y)
        trainer.step(4)
        np.testing.assert_allclose(loss.detach().numpy(), jloss.asnumpy(),
                                   rtol=FWD_TOL, err_msg=f"step {step}")
        assert len(want) == 53
        for name, g in want.items():
            _close(got[name], g, MODEL_TOL, f"step {step} grad {name}")
        jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
        running = {k: v for k, v in params_to_numpy(net).items()
                   if "running" in k}
        assert len(running) == 34
        for name, v in running.items():
            _close(v, jp[name], MODEL_TOL, f"step {step} {name}")
