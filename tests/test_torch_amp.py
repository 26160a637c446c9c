"""The port's AMP (``incubator_mxnet_tpu_torch/amp``) against the JAX
package's, on the CPU.

* The op lists are the JAX package's, and ``CastPolicy`` puts every
  listed name (and a few that are in no list) in the same class for the
  bfloat16 and float16 targets, with default, custom and excluded lists.
* ``cast_args`` gives float32, bfloat16 and integer inputs the dtypes the
  JAX policy gives them, per class.
* ``convert_block`` on the small fused ResNet of
  ``tests/test_torch_resnet_train.py`` leaves every parameter in the
  dtype the JAX package's ``convert_block`` leaves it in, name by name
  (gamma, beta and the moving statistics stay float32).
* That model converted to bfloat16, with the JAX model's converted
  weights carried across by ``params_from_jax`` (bfloat16 arrays
  included): the predict-mode logits and the training-mode loss against
  the hybridized JAX model's, in the JAX output's dtype.
* ``params_from_jax`` takes numpy's bfloat16 arrays exactly.

Tolerance: AMP_TOL = 2e-2 of the largest |JAX| value (logits) or of
each loss.  bfloat16 keeps 8 bits: a sum taken in another order flips
roundings that the network then carries forward.  The test measures that
response in the JAX model itself, as the change of its bfloat16 logits
under a 2^-8 relative move of the input (about 4e-3 of the largest logit
when the bound was set), and requires it to stay below AMP_TOL / 2, so
the bound sits above bfloat16's own noise.  Port and JAX agreed exactly
on this CPU when the bound was set.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet

from incubator_mxnet_tpu_torch import amp, autograd
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1, ResNetV1)

AMP_TOL = 2e-2
LAYERS, CHANNELS = [1, 1, 1, 1], [16, 32, 64, 128, 256]
ENV = {"MXNET_USE_PALLAS": "0", "MXNET_FUSED_CONV3": "0"}
OFF_LIST = ["Activation", "Pooling", "softmax_xent", "_fused_bottleneck_v1",
            "no_such_op"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # small convolutions: one thread is fastest
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(4)
    return (rng.rand(4, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, 4).astype(np.int32))


def _names(lists_mod):
    return sorted({n for dt in ("bfloat16", "float16")
                   for group in lists_mod.get_lists(dt) for n in group})


def test_lists_are_the_jax_packages():
    for attr in ("FP16_LP16", "FP16_FP32", "FP16_WIDEST", "BF16_LP16",
                 "BF16_FP32", "BF16_WIDEST"):
        assert getattr(amp.lists, attr) == getattr(jamp.lists, attr), attr


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
@pytest.mark.parametrize("custom", [
    {},
    {"target_dtype_ops": ["Convolution"], "fp32_ops": ["FullyConnected"],
     "widest_dtype_ops": ["mean"]},
    {"excluded_ops": ["Convolution", "mean", "add"]},
])
def test_policy_classes_match_jax(target, custom):
    port, ref = amp.CastPolicy(target, **custom), jamp.CastPolicy(target,
                                                                  **custom)
    for name in _names(jamp.lists) + OFF_LIST:
        assert port.op_class(name) == ref.op_class(name), name


def test_policy_refuses_an_op_in_two_lists():
    for mod in (amp, jamp):
        with pytest.raises(ValueError, match="both"):
            mod.CastPolicy("bfloat16", target_dtype_ops=["mean"],
                           fp32_ops=["mean"])


@pytest.mark.parametrize("op", ["Convolution", "mean", "add", "Activation"])
def test_cast_args_dtypes_match_jax(op):
    values = [np.ones(3, np.float32), np.ones(3, np.float32),
              np.ones(3, np.int32)]
    dtypes = ["float32", "bfloat16", "int32"]
    port_in = [torch.from_numpy(v).to(getattr(torch, d))
               for v, d in zip(values, dtypes)]
    jax_in = [jnp.asarray(v, d) for v, d in zip(values, dtypes)]
    with amp.policy_scope(amp.CastPolicy("bfloat16")):
        got = amp.cast_args(op, *port_in)
    want = jamp.CastPolicy("bfloat16").cast_args(op, jax_in)
    assert [str(g.dtype).replace("torch.", "") for g in got] == [
        jnp.dtype(w.dtype).name for w in want]
    assert amp.cast_args(op, *port_in) == tuple(port_in)   # no policy


def test_init_takes_bfloat16_and_refuses_float16():
    assert amp.init("bfloat16")["dtype"] == torch.bfloat16
    with pytest.raises(NotImplementedError, match="LossScaler"):
        amp.init("float16")


def test_params_from_jax_takes_bfloat16_arrays():
    dense = nn.Dense(3, in_units=2)
    amp.convert_block(dense, "bfloat16")
    w = np.array([[1.5, -2.25], [3.0, 0.0078125], [-1.0, 2.0]],
                 ml_dtypes.bfloat16)
    b = np.array([0.5, -0.5, 1.0], ml_dtypes.bfloat16)
    state = params_from_jax({"weight": w, "bias": b}, dense)
    assert dense.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(state["weight"].float().numpy(),
                                  w.astype(np.float32))
    np.testing.assert_array_equal(dense.bias.detach().float().numpy(),
                                  b.astype(np.float32))


@pytest.fixture(scope="module")
def jax_amp_model():
    """The hybridized JAX model: float32 logits, then converted to
    bfloat16: its parameter dtypes and weights (numpy arrays, bfloat16
    where cast), its bfloat16 logits, those under a 2^-8 move of the
    input, and last (it moves the BatchNorm statistics) its
    training-mode loss."""
    x, y = _batch()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mx.random.seed(0)
        net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                                  classes=10, layout="NHWC", fused=True)
        net.initialize(ctx=mx.cpu())
        net.hybridize()
        net(nd.array(x))                    # resolve shapes in float32
        jamp.convert_block(net, "bfloat16")
        params = net.collect_params()
        dtypes = {k: jnp.dtype(p.dtype).name for k, p in params.items()}
        weights = {k: np.asarray(p.data().data) for k, p in params.items()}
        out = net(nd.array(x))
        moved = net(nd.array(x * np.float32(1 + 2 ** -8))).asnumpy()
        with jax_autograd.record():
            loss = jax_gluon.loss.SoftmaxCrossEntropyLoss()(
                net(nd.array(x)), nd.array(y))
        return dict(dtypes=dtypes, weights=weights,
                    logits_dtype=jnp.dtype(out.dtype).name,
                    logits=out.asnumpy().astype(np.float32),
                    moved=moved.astype(np.float32),
                    loss_dtype=jnp.dtype(loss.dtype).name,
                    loss=loss.asnumpy().astype(np.float32))


def _port_model():
    net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=10, layout="NHWC",
                   fused=True)
    return amp.convert_block(net, "bfloat16")


def test_convert_block_casts_what_jax_casts(jax_amp_model):
    want = jax_amp_model["dtypes"]
    got = {k: str(p.dtype).replace("torch.", "")
           for k, p in _port_model().collect_params().items()}
    assert got == want
    assert {v for k, v in got.items()
            if k.endswith(("gamma", "beta", "running_mean",
                           "running_var"))} == {"float32"}
    assert "bfloat16" in got.values()


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_bfloat16_model_predicts_and_trains_like_jax(jax_amp_model):
    ref = jax_amp_model
    noise = _rel(ref["moved"], ref["logits"])
    assert noise <= AMP_TOL / 2, noise
    assert any(v.dtype == ml_dtypes.bfloat16 for v in ref["weights"].values())
    net = _port_model()
    params_from_jax(ref["weights"], net)
    x, y = _batch()
    logits = net(torch.from_numpy(x))
    assert str(logits.dtype).replace("torch.", "") == ref["logits_dtype"]
    err = _rel(logits.detach().float().numpy(), ref["logits"])
    assert err <= AMP_TOL, (err, noise)
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(torch.from_numpy(x)),
                                         torch.from_numpy(y))
    assert str(loss.dtype).replace("torch.", "") == ref["loss_dtype"]
    np.testing.assert_allclose(loss.detach().float().numpy(), ref["loss"],
                               rtol=AMP_TOL)
