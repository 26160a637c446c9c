"""ResNet-50 v1 on the fused bottleneck through the port, against the JAX
package, on the CPU.

* ``convolution``, ``pooling`` and ``batch_norm`` of the port's
  ``ops/nn_ops.py`` against the JAX ops, NHWC and NCHW.
* One ``BottleneckV1(32, stride, downsample, layout="NHWC",
  fused=True)`` of each kind, identity (stride 1) and projection
  (stride 2): the training forward, every gradient of ``(y*y).mean()``
  and the moving statistics after the step.  The JAX block runs its
  Pallas 1x1 kernels in interpret mode (``MXNET_USE_PALLAS=1``) and its
  3x3 through the XLA composition (``MXNET_FUSED_CONV3=0``), which is
  the configuration the port ports; the weights go across with
  ``params_from_jax``.
* The port's ``examples/train_resnet_fused.py --cpu`` at a tiny size.

The whole small model is held against JAX in
``tests/test_torch_resnet_train.py``.

Inputs come from numpy with a seed.  Tolerances, max |port - JAX| over
the largest |JAX| value of each tensor, all float32 (both run the same
formulas, with sums in another order):
- ops: 1e-5 (bfloat16 average pooling: 1e-2, one bf16 ulp);
- one bottleneck: output and moving statistics 1e-5; gradients 1e-4,
  since each passes through three BatchNorm backwards over the 128 rows
  (stride 1) or 32 rows (stride 2) of the batch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from incubator_mxnet_tpu.ops import nn_ops as jops

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.examples import train_resnet_fused
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1)
from incubator_mxnet_tpu_torch.ops import nn_ops

OP_TOL = 1e-5
BLOCK_GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fused_config(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    monkeypatch.setenv("MXNET_FUSED_CONV3", "0")


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
    return err / scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kernel,stride,pad,dilate,groups,bias", [
    ((7, 7), (2, 2), (3, 3), (1, 1), 1, False),   # the stem
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    ((1, 1), (2, 2), (0, 0), (1, 1), 1, False),   # a strided 1x1
    ((3, 3), (2, 1), (1, 0), (2, 1), 2, True),
])
def test_convolution_matches_jax(layout, kernel, stride, pad, dilate, groups,
                                 bias):
    rng = np.random.RandomState(0)
    cin, cout = 4, 6
    x = rng.randn(2, cin, 11, 9).astype(np.float32)
    w = rng.randn(cout, cin // groups, *kernel).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    kw = dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
              num_filter=cout, num_group=groups, no_bias=not bias,
              layout=layout)
    want = jops.convolution(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b), **kw)
    got = nn_ops.convolution(_t(x), _t(w), None if b is None else _t(b), **kw)
    _close(got.numpy(), want, OP_TOL, "conv")


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(2, 3), pool_type="avg", stride=(2, 1), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling_matches_jax(layout, kw, dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 9, 7).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    want = jops.pooling(jnp.asarray(x, getattr(jnp, dtype)), layout=layout,
                        **kw)
    got = nn_ops.pooling(_t(x).to(getattr(torch, dtype)), layout=layout, **kw)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           OP_TOL if dtype == "float32" else 1e-2, "pool")


@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_matches_jax(axis, training, fix_gamma):
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 6, 5, 3) * 2 + 0.5).astype(np.float32)
    c = x.shape[axis]
    p = [(rng.rand(c) + 0.5).astype(np.float32),
         rng.randn(c).astype(np.float32),
         rng.randn(c).astype(np.float32) * 0.1,
         (rng.rand(c) + 0.5).astype(np.float32)]
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=axis,
              training=training)
    want = jops.batch_norm(jnp.asarray(x), *map(jnp.asarray, p), **kw)
    got = nn_ops.batch_norm(_t(x), *map(_t, p), **kw)
    if not training:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w, OP_TOL, "batch_norm")


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jax_grads(net):
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def _port_running(net):
    return {k: v for k, v in params_to_numpy(net).items() if "running" in k}


@pytest.mark.parametrize("stride,down", [(1, False), (2, True)])
def test_bottleneck_matches_jax(stride, down):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 8, 8, 32).astype(np.float32)
    mx.random.seed(0)
    jblk = jax_resnet.BottleneckV1(32, stride, down, in_channels=32,
                                   layout="NHWC", fused=True)
    jblk.initialize(ctx=mx.cpu())
    jblk(nd.array(x))               # resolve shapes through the layers
    blk = BottleneckV1(32, stride, down, in_channels=32, layout="NHWC",
                       fused=True)
    params_from_jax(_jax_params(jblk), blk)

    jx = nd.array(x)
    with jax_autograd.record():
        jy = jblk(jx)
        jloss = (jy * jy).mean()
    jloss.backward()
    tx = _t(x)
    with autograd.record():
        y = blk(tx)
        loss = (y * y).mean()
    autograd.backward(loss)

    _close(y.detach().numpy(), jy.asnumpy(), OP_TOL, "y")
    want = _jax_grads(jblk)
    got = grads_to_numpy(blk)
    assert len(want) == (12 if down else 9)
    for name, g in want.items():
        _close(got[name], g, BLOCK_GRAD_TOL, name)
    jp = _jax_params(jblk)
    for name, v in _port_running(blk).items():
        _close(v, jp[name], OP_TOL, name)
        assert not np.allclose(v, 0.0 if "mean" in name else 1.0), name


def test_example_trains_on_the_cpu(capsys):
    # 64x64, not 32x32: at 32x32 stage 4 is 1x1, its BatchNorm sees two
    # values, and a 1e-7 move of the input moves the first loss by 1.5 %
    # and flips the outcome of two steps.  At 64x64 the first loss holds
    # to four digits under a 1e-6 move and the second falls below it.
    losses = train_resnet_fused.main(["--cpu", "--batch", "2",
                                      "--image-size", "64", "--steps", "2"])
    assert len(losses) == 2 and min(losses[1:]) < losses[0]
    assert "done" in capsys.readouterr().out
