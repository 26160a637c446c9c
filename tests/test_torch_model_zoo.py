"""The port's vision model zoo (``gluon/model_zoo/vision``) against the
JAX package's, on the CPU.

* Each family at its smallest member (ResNet 18 v1 and v2, also with
  the thumbnail and the ``"s2d"`` stems; AlexNet; VGG-11 with
  BatchNorm; SqueezeNet 1.0 and 1.1; MobileNet v1 and v2 at 0.25;
  DenseNet-121; Inception v3), 10 classes: the predict-mode logits of
  the same weights.  AlexNet and SqueezeNet run at 64x64, DenseNet at
  224x224 and Inception at 299x299 with B=1 (their final pools want
  those sizes), the rest at 32x32 with B=2.  The weights are drawn with
  numpy from a seed under the names and shapes of the port's model (one
  forward resolves the deferred ones), set into the JAX model, read
  back from it and carried into a fresh port model by
  ``params_from_jax``; the moving statistics are drawn away from 0 and
  1.  The JAX model runs hybridized: one compiled forward, where its
  first eager forward would compile each op and initializer shape
  (about 30 s for DenseNet-121).
* One bfloat16 case: ``resnet18_v2`` converted by ``amp.convert_block``
  in both packages.
* ``get_model`` builds every one of the JAX ``_models``' 34 names and
  raises ``ValueError`` for an unknown one, as the JAX one does;
  ``pretrained=True`` raises.
* ``inceptionv3`` at 224x224 and ``densenet121`` at 64x64 raise in both
  packages: their final average pool gets a map smaller than its
  window.
* The zoo's share of the op and layer library: ``concat`` (with AMP's
  widest-type cast) and ``space_to_depth`` against the JAX ops,
  ``AvgPool2D`` (both ``count_include_pad``) against the JAX layer, bit
  for bit or at 1e-6; ``ceil_mode=True`` and ``HybridLambda`` of a
  function name raise.
* ``examples/benchmark_score.py`` on the CPU at the JAX suite's size
  (``squeezenet1_1``, B=2, 3x64x64, float32), as
  ``tests/test_examples.py::test_benchmark_score_smoke`` runs the JAX
  script; without a card and without ``--device cpu`` it raises.

Tolerances: float32 logits ZOO_TOL = 1e-5 of the largest |JAX| logit
(the same products, summed in another order by oneDNN and XLA; every
case measured 7.2e-7 or less when the bound was set).  bfloat16:
the port's distance from the JAX bfloat16 logits at most twice the JAX
model's own bfloat16-vs-float32 distance (both round at other places;
the two distances are measured in the test).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ops import shape_ops as jshape
from incubator_mxnet_tpu.ndarray.ndarray import NDArray

from incubator_mxnet_tpu_torch import amp
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.examples import benchmark_score
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.ops import shape_ops

ZOO_TOL = 1e-5
CLASSES = 10

CASES = [
    ("resnet18_v1", {}, 2, 32),
    ("resnet18_v2", {}, 2, 32),
    ("resnet18_v1", {"thumbnail": True}, 2, 32),
    ("resnet18_v2", {"stem": "s2d"}, 2, 32),
    ("alexnet", {}, 2, 64),
    ("vgg11_bn", {}, 2, 32),
    ("squeezenet1.0", {}, 2, 64),
    ("squeezenet1.1", {}, 2, 64),
    ("mobilenet0.25", {}, 2, 32),
    ("mobilenetv2_0.25", {}, 2, 32),
    ("densenet121", {}, 1, 224),
    ("inceptionv3", {}, 1, 299),
]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU convolutions run faster on one thread than on many that
    other processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(batch, side, seed=0):
    return np.random.RandomState(seed).rand(batch, 3, side, side).astype(
        np.float32)


def _weights(name, kwargs, side):
    """``{name: array}`` at the shapes of the port's model (one forward at
    ``side`` resolves its deferred parameters), drawn from a seed: conv
    and dense weights N(0, 1/fan_in), biases and betas N(0, 0.1²),
    gammas 1 + N(0, 0.1²), moving means N(0, 0.1²), moving variances
    U(0.5, 1.5)."""
    net = vision.get_model(name, classes=CLASSES, **kwargs)
    net.initialize(device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 3, side, side))
    rng = np.random.RandomState(1)
    out = {}
    for k, p in net.collect_params().items():
        shape = tuple(p.shape)
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("gamma"):
            a = 1 + 0.1 * rng.randn(*shape)
        elif k.endswith(("bias", "beta", "running_mean")):
            a = 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = a.astype(np.float32)
    return out


def _jax_model(name, kwargs, weights):
    """The JAX model with ``weights`` set into its parameters (deferred
    ones take the arrays' shapes), hybridized."""
    net = jvision.get_model(name, classes=CLASSES, **kwargs)
    net.initialize(ctx=mx.cpu())
    params = net.collect_params()
    assert sorted(params.keys()) == sorted(weights)
    for k, p in params.items():
        p.shape = weights[k].shape
        p._data = NDArray(jnp.asarray(weights[k]), ctx=mx.cpu())
        p._deferred_init_args = None
        if p.grad_req != "null":
            p._data.attach_grad(p.grad_req)
    net.hybridize()
    return net


def _port_model(name, kwargs, jnet):
    net = vision.get_model(name, classes=CLASSES, **kwargs)
    net.initialize(device="cpu")
    params_from_jax({k: p.data().asnumpy()
                     for k, p in jnet.collect_params().items()}, net)
    return net


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


@pytest.mark.parametrize("name,kwargs,batch,side", CASES,
                         ids=[f"{c[0]}{''.join(c[1])}" for c in CASES])
def test_family_predicts_like_jax(name, kwargs, batch, side):
    weights = _weights(name, kwargs, side)
    jnet = _jax_model(name, kwargs, weights)
    x = _image(batch, side)
    want = jnet(nd.array(x)).asnumpy()
    net = _port_model(name, kwargs, jnet)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (batch, CLASSES)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= ZOO_TOL, _rel(got, want)


def test_bfloat16_predicts_like_jax():
    """``resnet18_v2`` converted to bfloat16 in both packages, the
    converted JAX weights carried across: the port's logits within twice
    the JAX model's own bfloat16-vs-float32 distance of JAX's."""
    name, kwargs, side = "resnet18_v2", {}, 32
    jnet = _jax_model(name, kwargs, _weights(name, kwargs, side))
    x = _image(2, side, seed=3)
    want32 = jnet(nd.array(x)).asnumpy()
    jamp.convert_block(jnet, "bfloat16")
    want = jnet(nd.array(x)).asnumpy().astype(np.float32)
    net = _port_model(name, kwargs, jnet)
    amp.convert_block(net, "bfloat16")
    assert net.features[1].weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = net(torch.tensor(x)).float().numpy()
    own = _rel(want, want32)
    assert 0 < own
    assert _rel(got, want) <= 2 * own, (_rel(got, want), own)


def test_get_model_takes_the_jax_names():
    assert sorted(vision._models) == sorted(jvision._models)
    assert len(vision._models) == 34
    for name in vision._models:
        net = vision.get_model(name.upper(), classes=CLASSES)
        want = type(jvision.get_model(name, classes=CLASSES)).__name__
        assert type(net).__name__ == want, name
    for get in (vision.get_model, jvision.get_model):
        with pytest.raises(ValueError, match="unknown model"):
            get("resnet19_v1")
    for fn in (vision.resnet18_v1, vision.alexnet, vision.inception_v3):
        with pytest.raises(RuntimeError, match="pretrained"):
            fn(pretrained=True)
    with pytest.raises(ValueError, match="fused=True"):
        vision.resnet18_v1(layout="NHWC", fused=True)
    with pytest.raises(ValueError, match="NHWC"):
        vision.resnet50_v2(fused=True)


@pytest.mark.parametrize("name,side,shapes_at", [("inceptionv3", 224, 299),
                                                 ("densenet121", 64, 224)])
def test_final_pool_too_large_raises_in_both(name, side, shapes_at):
    """Weights at the shapes of a size the net takes; at ``side`` the
    final average pool's window is larger than its map.  The JAX model
    raises as it resolves the classifier's input or flattens an empty
    map; the port's pooling raises first."""
    weights = _weights(name, {}, shapes_at)
    if name == "inceptionv3":   # the classifier's width comes from the map
        weights = {k: v for k, v in weights.items()
                   if not k.startswith("output")}
    jnet = jvision.get_model(name, classes=CLASSES)
    jnet.initialize(ctx=mx.cpu())
    for k, p in jnet.collect_params().items():
        if k in weights:
            p.shape = weights[k].shape
            p._data = NDArray(jnp.asarray(weights[k]), ctx=mx.cpu())
            p._deferred_init_args = None
    jnet.hybridize()
    x = _image(1, side)
    with pytest.raises(Exception):
        jnet(nd.array(x)).asnumpy()
    net = vision.get_model(name, classes=CLASSES)
    net.initialize(device="cpu")
    with pytest.raises(ValueError, match="window"):
        with torch.no_grad():
            net(torch.tensor(x))


def test_benchmark_score_smoke(capsys, monkeypatch):
    benchmark_score.main(["--models", "squeezenet1_1", "--batch-sizes", "2",
                          "--image-shape", "3,64,64", "--dtype", "float32",
                          "--steps", "2", "--warmup", "1", "--device",
                          "cpu"])
    out = capsys.readouterr().out
    assert "img/s" in out and "FAILED" not in out and "done" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        benchmark_score.main(["--models", "squeezenet1_1"])


def test_zoo_ops_and_layers_match_jax():
    rng = np.random.RandomState(2)
    a, b = (rng.randn(2, c, 6, 8).astype(np.float32) for c in (3, 5))
    want = np.asarray(jshape.concat(jnp.asarray(a), jnp.asarray(b), dim=1))
    got = shape_ops.concat(torch.tensor(a), torch.tensor(b), dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    policy = amp.CastPolicy("bfloat16")
    with amp.policy_scope(policy):
        mixed = shape_ops.concat(torch.tensor(a).bfloat16(), torch.tensor(b),
                                 dim=1)
    assert mixed.dtype == torch.float32
    x = rng.randn(2, 3, 8, 6).astype(np.float32)
    np.testing.assert_array_equal(
        shape_ops.space_to_depth(torch.tensor(x), 2).numpy(),
        np.asarray(jshape.space_to_depth(jnp.asarray(x), block_size=2)))
    for count in (True, False):
        want = jnn.AvgPool2D(3, 2, 1, count_include_pad=count)(
            nd.array(x)).asnumpy()
        got = nn.AvgPool2D(3, 2, 1, count_include_pad=count)(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="ceil_mode"):
        nn.MaxPool2D(3, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="callable"):
        nn.HybridLambda("relu")
    relu6 = nn.HybridLambda(lambda t: t.clip(0, 6))
    assert relu6(torch.tensor([-1.0, 3.0, 7.0])).tolist() == [0.0, 3.0, 6.0]
