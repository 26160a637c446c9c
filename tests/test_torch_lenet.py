"""The LeNet/MNIST path of the port against the JAX package, on the CPU.

* Deferred initialisation: ``Conv2D``/``Dense`` (and ``BatchNorm``,
  ``LayerNorm``) without input sizes take them from the first batch;
  a ``Trainer`` built before that batch trains the materialised
  parameters.
* ``examples/train_mnist.py``'s network built in JAX and hybridized, its
  weights carried by ``params_from_jax`` into the port's still-deferred
  model: logits, loss and every gradient within 1e-5 of their largest
  value (the same convolutions and products summed in another order;
  the tests below state where a max pool's rounding widens that), then
  three Adam steps (lr 3e-3) in both packages.
* The port's ``train_mnist`` example, ``--smoke --device cpu``.
"""
import copy

import numpy as np
import pytest
import torch
from torch.nn.parameter import UninitializedParameter

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd

from incubator_mxnet_tpu_torch import autograd, random
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.examples import train_mnist
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

B, LR, TOL = 16, 3e-3, 1e-5
SHAPES = {"0.weight": (32, 1, 3, 3), "0.bias": (32,),
          "2.weight": (64, 32, 3, 3), "2.bias": (64,),
          "5.weight": (128, 3136), "5.bias": (128,),
          "6.weight": (10, 128), "6.bias": (10,)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU convolutions run far slower on threads shared with other
    processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_lenet():
    net = jax_gluon.nn.HybridSequential()
    net.add(jax_gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            jax_gluon.nn.MaxPool2D(2),
            jax_gluon.nn.Conv2D(64, 3, padding=1, activation="relu"),
            jax_gluon.nn.MaxPool2D(2), jax_gluon.nn.Flatten(),
            jax_gluon.nn.Dense(128, activation="relu"),
            jax_gluon.nn.Dense(10))
    mx.random.seed(0)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    return net


def _batch(seed=0):
    return train_mnist.synthetic_data(B, seed)


def _close_scaled(got, want, what):
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


def test_deferred_init_takes_shapes_from_the_first_batch():
    random.seed(0)
    net = train_mnist.lenet()
    with pytest.raises(RuntimeError, match="initialize"):
        net(torch.zeros(2, 1, 28, 28))
    net.initialize(device="cpu")
    params = net.collect_params()
    assert list(params) == list(SHAPES)
    assert all(isinstance(params[k], UninitializedParameter)
               for k in SHAPES if k.endswith("weight"))
    trainer = Trainer(params, "adam", {"learning_rate": LR},
                      kvstore="device")
    with pytest.raises(RuntimeError, match="forward"):
        trainer.step(2)
    x, y = (torch.from_numpy(a) for a in _batch())
    loss, out = train_mnist.train_step(net, trainer,
                                       SoftmaxCrossEntropyLoss(), x, y, B)
    assert out.shape == (B, 10) and torch.isfinite(loss).all()
    after = net.collect_params()
    assert {k: tuple(p.shape) for k, p in after.items()} == SHAPES
    assert all(after[k] is params[k] for k in SHAPES)   # same objects
    assert len(trainer._updater.states) == len(SHAPES)  # made at the step
    # the draws repeat under random.seed
    random.seed(0)
    again = train_mnist.lenet()
    again.initialize(device="cpu")
    again(x)
    random.seed(0)
    third = train_mnist.lenet()
    third.initialize(device="cpu")
    third(x)
    for k, p in again.collect_params().items():
        assert torch.equal(p, third.collect_params()[k]), k


def test_deferred_norm_layers_and_channel_minor_conv():
    for layer, x, shapes in (
            (nn.BatchNorm(), torch.randn(4, 6, 5, 5),
             {"gamma": (6,), "beta": (6,), "running_mean": (6,),
              "running_var": (6,)}),
            (nn.BatchNorm(axis=-1), torch.randn(4, 5, 7),
             {"gamma": (7,), "beta": (7,), "running_mean": (7,),
              "running_var": (7,)}),
            (nn.LayerNorm(), torch.randn(3, 9), {"gamma": (9,),
                                                 "beta": (9,)}),
            (nn.Conv2D(8, 3, layout="NHWC"), torch.randn(2, 6, 6, 5),
             {"weight": (8, 3, 3, 5), "bias": (8,)}),
            (nn.Dense(4, flatten=False), torch.randn(2, 3, 7),
             {"weight": (4, 7), "bias": (4,)})):
        layer.initialize(device="cpu")
        with autograd.record():
            out = layer(x)
        assert torch.isfinite(out).all()
        assert {k: tuple(p.shape) for k, p in
                layer.collect_params().items()} == shapes, type(layer)
    norm = nn.BatchNorm()
    norm.initialize(device="cpu")
    norm(torch.randn(2, 3, 4))
    assert torch.equal(norm.gamma, torch.ones(3))
    assert torch.equal(norm.running_var, torch.ones(3))


def test_params_from_jax_refuses_shapes_a_deferred_layer_cannot_take():
    named = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for key, bad in (("0.weight", (31, 1, 3, 3)), ("0.weight", (32, 1, 3)),
                     ("6.weight", (9, 128)), ("6.bias", (9,))):
        net = train_mnist.lenet()
        with pytest.raises(ValueError, match="shape"):
            params_from_jax(dict(named, **{key: np.zeros(bad, np.float32)}),
                            net)
        assert isinstance(net[0].weight, UninitializedParameter)
    net = train_mnist.lenet()
    params_from_jax(named, net)
    assert {k: tuple(p.shape) for k, p in
            net.collect_params().items()} == SHAPES


def _jax_run():
    """JAX LeNet after its deferred init, its inputs, and the port's
    model given its weights by ``params_from_jax`` while still
    deferred."""
    jnet = _jax_lenet()
    x, y = _batch()
    jnet(nd.array(x))
    port = train_mnist.lenet()
    params_from_jax(_named(jnet), port)
    return jnet, port, x, y


def _named(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _jax_step(jnet, x, y):
    with jax_autograd.record():
        out = jnet(nd.array(x))
        loss = jax_gluon.loss.SoftmaxCrossEntropyLoss()(out, nd.array(y))
    loss.backward()
    return (out.asnumpy(), loss.asnumpy(),
            {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()})


def _port_step(net, x, y, dtype):
    with autograd.record():
        out = net(torch.from_numpy(x).to(dtype))
        loss = SoftmaxCrossEntropyLoss()(out, torch.from_numpy(y))
    autograd.backward(loss)
    return (out.detach().double().numpy(), loss.detach().double().numpy(),
            grads_to_numpy(net))


def test_lenet_forward_and_gradients_match_jax():
    """Logits, loss and every gradient from JAX's weights: the port in
    float64 (the algorithm) within 1e-5 of each tensor's largest value;
    the port in float32 likewise, except that a gradient may differ by
    up to twice the port's own float32-vs-float64 distance where that
    is larger.  A max pool routes its gradient to the window's largest
    value, and where two values of a window lie within float32 rounding
    of each other the rounding picks it: in this batch one window of
    the second pool does, and moves conv 2's weight gradient by 6.9e-3
    of its largest value between the port's own float32 and float64
    runs (JAX's float32 run picks as the float64 one)."""
    jnet, port, x, y = _jax_run()
    port64 = copy.deepcopy(port).double()
    jout, jloss, jgrads = _jax_step(jnet, x, y)
    out, loss, grads = _port_step(port, x, y, torch.float32)
    out64, loss64, grads64 = _port_step(port64, x, y, torch.float64)
    for got in ((out, loss), (out64, loss64)):
        _close_scaled(got[0], jout, "logits")
        _close_scaled(got[1], jloss, "loss")
    assert list(grads) == list(grads64) == list(jgrads) == list(SHAPES)
    widened = []
    for k, want in jgrads.items():
        _close_scaled(grads64[k], want, f"grad {k}, float64")
        scale = np.abs(want).max()
        own = np.abs(grads[k] - grads64[k]).max()
        err = np.abs(grads[k] - want).max()
        assert err <= max(TOL * scale, 2 * own), (k, err, own, scale)
        if err > TOL * scale:
            widened.append(k)
    assert set(widened) <= {"0.weight", "0.bias", "2.weight"}, widened


def test_three_adam_steps_match_jax():
    """Three Adam steps (lr 3e-3) from JAX's weights, the port in
    float64 (a float32 trajectory follows the pool's rounding, see
    above): the loss at each step rtol 1e-5, every gradient at each
    step within 1e-5 of its largest value; after each step the update
    of every weight whose gradient was above 1e-2 of its tensor's
    largest at every step so far within 1e-2·lr, and every weight within
    2·lr (Adam moves a weight by about lr·g/(|g| + eps), so an element
    whose gradient is at float32's rounding level of its tensor moves by
    another fraction of lr in the JAX package's float32 run)."""
    jnet, port, x, y = _jax_run()
    port = port.double()
    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": LR}, kvstore="device")
    trainer = Trainer(port.collect_params(), "adam", {"learning_rate": LR},
                      kvstore="device")
    steady = None
    for step in range(3):
        _, jloss, jgrads = _jax_step(jnet, x, y)
        _, loss, grads = _port_step(port, x, y, torch.float64)
        np.testing.assert_allclose(loss.sum(), jloss.sum(), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        for k, g in grads.items():
            _close_scaled(g, jgrads[k], f"grad {k}, step {step}")
        large = {k: np.abs(g) > 1e-2 * np.abs(g).max()
                 for k, g in jgrads.items()}
        steady = large if steady is None else {
            k: steady[k] & large[k] for k in large}
        jbefore, before = _named(jnet), params_to_numpy(port)
        jtrainer.step(B)
        trainer.step(B)
        jafter, after = _named(jnet), params_to_numpy(port)
        for k, mask in steady.items():
            d = np.abs((after[k] - before[k]) - (jafter[k] - jbefore[k]))
            assert d[mask].max() <= 1e-2 * LR, (k, step, d[mask].max())
            assert np.abs(after[k] - jafter[k]).max() <= 2 * LR, (k, step)
    assert sum(int(m.sum()) for m in steady.values()) > 10000


def test_train_mnist_example_on_the_cpu(capsys):
    results = train_mnist.main(["--smoke", "--device", "cpu"])
    assert len(results) == 1 and 0.0 <= results[0] <= 1.0
    assert "done" in capsys.readouterr().out


def test_train_mnist_on_real_digits():
    pytest.importorskip("sklearn")
    results = train_mnist.main(["--dataset", "digits", "--epochs", "5",
                                "--target-acc", "0.9", "--device", "cpu"])
    assert results[-1] > 0.9
