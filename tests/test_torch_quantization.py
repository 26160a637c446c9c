"""The port's int8 quantization (``ops/quantization_ops.py``,
``ops/int8_conv.py``'s plain versions, ``contrib/quantization.py``,
``gluon/contrib/fuse_bn.py`` and ``examples/quantize_resnet50.py``)
against the JAX package, on the CPU.

* Every op against the JAX op on the same numpy inputs, the JAX ops run
  eagerly through their raw functions (``op.fn``), as the JAX package's
  own tests call them: eager XLA divides, where ``jax.jit`` multiplies
  by the reciprocal of a constant divisor and moves a code now and then.
  Bit for bit: the codes of ``quantize`` (with and without a range, at
  exact ties, which round half to even, and laid out channels-last), the
  int32 sums of
  ``quantized_conv2d`` and ``quantized_dense`` (strides, pads, dilation,
  a bias, a bias that wraps the int32 sums, a product whose sums wrap),
  ``dequantize``, ``requantize`` and the other nine ops, and every range
  they return.  ``quantized_batch_norm`` takes a reciprocal square root,
  which XLA's CPU code rounds differently from PyTorch's in the last bit:
  bit for bit with the JAX op's ``lax.rsqrt`` given PyTorch's value, and
  within one code of the unchanged JAX op.
* ``calibrate_entropy``, ``optimal_threshold_kl`` and the
  ``CalibrationCollector`` in both modes (its histograms, edges and
  thresholds, the range growing past a degenerate first batch): equal.
* ``quantize_net`` (with and without ``fuse_conv_bn``) on the JAX test's
  small net and on a thumbnail ``ResNetV1(BottleneckV1, [1], [16, 64])``,
  both modes, the same numpy weights and inputs: the port's logits
  against the eager JAX net's within NET_TOL of the largest |JAX| logit,
  the same top-1.  The float layers between the int8 products (BatchNorm,
  the residual sums, pooling, dequantize) round differently in oneDNN
  and XLA in the last bit; the int8 products themselves are exact.
  Measured: at most 3.9e-7 of the largest logit, no code moved.  A
  last-bit move of a layer's input that flipped a code at a tie would
  move a logit by about one code's share of the layer's range, 1/127,
  damped by the layers after it, far above NET_TOL: these inputs put no
  layer input within an ulp of a tie.
* ``examples/quantize_resnet50.py`` in process at the JAX suite's size
  class (``resnet18_v1``, B=2, 32x32): two JSON lines with the JAX
  script's keys; without a card it raises.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.contrib import quantization as jquant
from incubator_mxnet_tpu.gluon import contrib as jcontrib
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.ops import quantization_ops as jq

import incubator_mxnet_tpu_torch as pmx
from incubator_mxnet_tpu_torch.contrib import quantization as quant
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.examples import quantize_resnet50
from incubator_mxnet_tpu_torch.gluon import contrib
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from incubator_mxnet_tpu_torch.ops import int8_conv as k8
from incubator_mxnet_tpu_torch.ops import quantization_ops as q

NET_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU convolutions run faster on one thread than on many that
    other processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want):
    """Bit for bit: values, dtype and shape."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


def _codes(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# -- quantize / dequantize / requantize --------------------------------------

TIES = ((np.arange(-1040, 1040) + 0.5) * 0.125 / 8).astype(np.float32)


@pytest.mark.parametrize("data,lo,hi", [
    ("randn", None, None),
    ("randn", -3.3333, 5.123),
    ("randn", -0.5, None),
    ("randn", 1e-14, -1e-14),           # the 1e-12 floor of the scale
    ("ties", -15.875, 15.875),          # scale 1/8: x / scale = k + 0.5
    ("ties", None, None),
], ids=["own-range", "range", "min-only", "tiny", "ties", "ties-own"])
def test_quantize_matches_jax_bit_for_bit(data, lo, hi):
    x = (np.random.RandomState(0).randn(6, 7, 33) * 2.5).astype(np.float32) \
        if data == "randn" else TIES * 8
    want = jq.quantize.fn(_j(x), lo, hi)
    got = q.quantize(_t(x), lo, hi)
    for g, w in zip(got, want):
        _same(g, w)
    if data == "ties" and lo is not None:
        # the ties round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        codes = got[0].numpy()
        assert set(np.abs(codes[(TIES * 8 / 0.125).round(3) % 1 == 0.5]
                          .astype(int)) % 2) <= {0, 1}
        np.testing.assert_array_equal(codes[1040:1043], [0, 2, 2])


@pytest.mark.parametrize("shape", [(2, 5, 3, 7), (1, 3, 9, 9)])
def test_quantize_channels_last_gives_the_same_codes(shape):
    """The port's ``channels_last``: the JAX op's codes, laid out as the
    int8 convolution reads them."""
    x = (np.random.RandomState(13).randn(*shape) * 2).astype(np.float32)
    want = jq.quantize.fn(_j(x), -2.5, 3.0)
    got = q.quantize(_t(x), -2.5, 3.0, channels_last=True)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for g, w in zip(got, want):
        _same(g.contiguous(), w)


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_dequantize_matches_jax_bit_for_bit(dtype):
    rng = np.random.RandomState(1)
    data = rng.randint(-2 ** 30, 2 ** 30, (5, 9, 7)).astype(dtype) \
        if dtype == np.int32 else _codes(rng, (5, 9, 7))
    for lo, hi in [(-3.1, 2.9), (-7e5, 1e3), (0.0, 0.0)]:
        want = jq.dequantize.fn(_j(data), jnp.float32(lo), jnp.float32(hi))
        _same(q.dequantize(_t(data), lo, hi), want)
        _same(q.dequantize(_t(data), _t(np.float32(lo)), _t(np.float32(hi))),
              want)


@pytest.mark.parametrize("calib", [None, (-0.37, 0.41)])
def test_requantize_matches_jax_bit_for_bit(calib):
    acc = np.random.RandomState(2).randint(-2 ** 28, 2 ** 28,
                                           (16, 24)).astype(np.int32)
    args = () if calib is None else calib
    want = jq.requantize.fn(_j(acc), -1.0, 1.0, *args)
    got = q.requantize(_t(acc), -1.0, 1.0, *args)
    for g, w in zip(got, want):
        _same(g, w)


# -- the int8 products ---------------------------------------------------

CONV_CASES = [  # (N, C, H, W, C_out, k, stride, pad, dilate, bias)
    ((2, 3, 15, 13, 8, 7, (2, 2), (3, 3), (1, 1), None)),     # the stem
    ((2, 16, 8, 8, 24, 1, (1, 1), (0, 0), (1, 1), "small")),
    ((2, 16, 9, 7, 12, 3, (2, 1), (1, 2), (1, 2), "small")),
    ((1, 32, 6, 6, 16, 1, (2, 2), (0, 0), (1, 1), None)),      # downsample
    ((2, 5, 7, 7, 3, 3, (1, 1), (2, 2), (2, 2), "huge")),      # sums wrap
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["stem", "1x1-bias", "strided-dilated",
                              "downsample", "bias-wraps"])
def test_quantized_conv2d_matches_jax_bit_for_bit(case):
    n, c, h, w, co, k, stride, pad, dilate, bias = case
    rng = np.random.RandomState(3)
    x, wt = _codes(rng, (n, c, h, w)), _codes(rng, (co, c, k, k))
    b = None if bias is None else (rng.randn(co) * (
        1e9 if bias == "huge" else 0.1)).astype(np.float32)
    ranges = (-1.7, 2.3, -0.4, 0.35)
    want = jq.quantized_conv2d.fn(_j(x), _j(wt), None if b is None else _j(b),
                                  *ranges, stride=stride, pad=pad,
                                  dilate=dilate)
    got = q.quantized_conv2d(_t(x), _t(wt), None if b is None else _t(b),
                             *ranges, stride=stride, pad=pad, dilate=dilate)
    for g, wv in zip(got, want):
        _same(g, wv)
    if bias == "huge":   # the bias codes sit at the clip: the sums wrap
        acc = np.asarray(want[0]).astype(np.int64)
        assert (acc < 0).any() and (acc > 0).any()


@pytest.mark.parametrize("shape,bias", [((8, 32), True), ((3, 4, 48), False),
                                        ((2, 140000), False)],
                         ids=["bias", "3d", "sums-wrap"])
def test_quantized_dense_matches_jax_bit_for_bit(shape, bias):
    rng = np.random.RandomState(4)
    units = 16
    if shape[-1] > 100000:     # 140000 * 127^2 > 2^31: the int32 sums wrap
        x = np.full(shape, 127, np.int8)
        wt = np.full((units, shape[-1]), 127, np.int8)
    else:
        x, wt = _codes(rng, shape), _codes(rng, (units, shape[-1]))
    b = (rng.randn(units) * 0.1).astype(np.float32) if bias else None
    ranges = (-1.0, 1.5, -0.2, 0.3)
    want = jq.quantized_dense.fn(_j(x), _j(wt), None if b is None else _j(b),
                                 *ranges)
    got = q.quantized_dense(_t(x), _t(wt), None if b is None else _t(b),
                            *ranges)
    for g, wv in zip(got, want):
        _same(g, wv)
    if shape[-1] > 100000:
        assert int(np.asarray(want[0]).ravel()[0]) < 0


def test_int8_conv_plain_version_is_exact():
    """The plain version's float64 sums against exact int64 sums."""
    rng = np.random.RandomState(5)
    x, wt = _codes(rng, (2, 7, 6, 5)), _codes(rng, (4, 7, 3, 3))
    bias = np.array([2 ** 31 - 1, -2 ** 31, 5, 0], np.int32)
    got = k8.int8_conv_reference(_t(x), _t(wt), _t(bias), 1, 1, 1)
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((2, 4, 6, 5), np.int64)
    for i in range(6):
        for j in range(5):
            want[:, :, i, j] = np.einsum("ncij,ocij->no",
                                         xp[:, :, i:i + 3, j:j + 3], wt)
    want = (want + bias[None, :, None, None] + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# -- the other nine ops -----------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=2, pool_type="max"),
    dict(kernel=(3, 3), pool_type="avg", stride=(1, 1), pad=(1, 1)),
    dict(kernel=(2, 2), pool_type="avg"),
    dict(pool_type="max", global_pool=True),
    dict(pool_type="avg", global_pool=True),
], ids=["max-pad", "max", "avg-pad", "avg", "global-max", "global-avg"])
def test_quantized_pooling_matches_jax(kw):
    x = _codes(np.random.RandomState(6), (2, 3, 7, 8))
    want = jq.quantized_pooling.fn(_j(x), -1.0, 2.0, **kw)
    got = q.quantized_pooling(_t(x), -1.0, 2.0, **kw)
    _same(got[0], want[0])
    assert got[1:] == want[1:] == (-1.0, 2.0)     # the range passes through


def test_quantized_concat_add_mul_act_flatten_embedding_match_jax():
    rng = np.random.RandomState(7)
    a, b, c = (_codes(rng, (2, n, 3, 3)) for n in (3, 4, 2))
    mins, maxs = [-1.5, -0.3, -2.0], [1.2, 0.7, 0.5]
    want = jq.quantized_concat.fn(*map(_j, (a, b, c)), *map(jnp.float32, mins),
                                  *map(jnp.float32, maxs), dim=1)
    got = q.quantized_concat(*map(_t, (a, b, c)), *mins, *maxs, dim=1)
    for g, w in zip(got, want):
        _same(g, w)
    x, y = _codes(rng, (4, 6)), _codes(rng, (4, 6))
    for name in ("quantized_elemwise_add", "quantized_elemwise_mul"):
        want = getattr(jq, name).fn(_j(x), _j(y), -0.5, 0.6, -2.0, 1.0)
        got = getattr(q, name)(_t(x), _t(y), -0.5, 0.6, -2.0, 1.0)
        for g, w in zip(got, want):
            _same(g, w)
    want = jq.quantized_act.fn(_j(x), -0.5, 0.6)
    got = q.quantized_act(_t(x), -0.5, 0.6)
    _same(got[0], want[0])
    assert (got[1], got[2]) == (-0.5, 0.6)
    with pytest.raises(ValueError, match="relu"):
        q.quantized_act(_t(x), -0.5, 0.6, act_type="tanh")
    x4 = _codes(rng, (2, 3, 4, 5))
    _same(q.quantized_flatten(_t(x4), -1.0, 1.0)[0],
          jq.quantized_flatten.fn(_j(x4), -1.0, 1.0)[0])
    table = _codes(rng, (10, 4))
    ids = np.array([[0, 3.7, 9], [-2, 12, 5]], np.float32)
    _same(q.quantized_embedding(_t(ids), _t(table), -1.0, 1.0)[0],
          jq.quantized_embedding.fn(_j(ids), _j(table), -1.0, 1.0)[0])


def test_quantized_batch_norm_matches_jax(monkeypatch):
    rng = np.random.RandomState(8)
    x = _codes(rng, (4, 6, 5, 5))
    gamma, beta, mean = (rng.randn(6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    args = (_j(x), _j(gamma), _j(beta), _j(mean), _j(var), -1.3, 1.1)
    got = q.quantized_batch_norm(_t(x), _t(gamma), _t(beta), _t(mean),
                                 _t(var), -1.3, 1.1)
    plain = jq.quantized_batch_norm.fn(*args)
    assert np.abs(got[0].numpy().astype(int)
                  - np.asarray(plain[0]).astype(int)).max() <= 1
    np.testing.assert_allclose(got[2].item(), float(plain[2]), rtol=1e-6)
    # with PyTorch's reciprocal square root, the rest is bit for bit
    monkeypatch.setattr(jq.lax, "rsqrt", lambda v: jnp.asarray(
        torch.rsqrt(_t(v)).numpy()))
    want = jq.quantized_batch_norm.fn(*args)
    for g, w in zip(got, want):
        _same(g, w)


def test_ops_are_bound_in_nd_under_the_jax_names():
    for name in ("_contrib_quantize_v2", "quantize", "_contrib_dequantize",
                 "_contrib_requantize", "_contrib_quantized_conv",
                 "quantized_conv2d", "_contrib_quantized_fully_connected",
                 "quantized_dense", "_contrib_quantized_pooling",
                 "_contrib_quantized_concat",
                 "_contrib_quantized_elemwise_add", "_contrib_quantized_act",
                 "_contrib_quantized_flatten",
                 "_contrib_quantized_elemwise_mul",
                 "_contrib_quantized_embedding",
                 "_contrib_quantized_batch_norm",
                 "_contrib_calibrate_entropy", "calibrate_entropy"):
        assert getattr(pmx.nd, name) is q.OPS[name], name
    assert len({id(f) for f in q.OPS.values()}) == 14
    with pytest.raises(ValueError, match="out_type"):
        q.quantize(torch.zeros(3), out_type="uint8")


# -- calibration ----------------------------------------------------------


def test_calibrate_entropy_and_kl_threshold_equal_jax():
    rng = np.random.RandomState(9)
    arr = np.concatenate([rng.randn(20000), [40.0]])
    hist, edges = np.histogram(arr, bins=2001, range=(-41, 41))
    want = jq.calibrate_entropy.fn(hist, edges)
    got = q.calibrate_entropy(hist, edges)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[0].dtype == np.float32
    assert quant.optimal_threshold_kl(arr) == \
        jquant.optimal_threshold_kl(arr)
    assert quant.optimal_threshold_kl(np.zeros(5)) == 1e-8


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_collector_equals_jax(mode):
    """Both modes, the range growing past a degenerate first batch (JAX
    tests/test_quantization.py:97): the same minmax, histograms, edges
    and thresholds."""
    rng = np.random.RandomState(10)
    batches = [np.full(64, 1e-7, np.float32)] + [
        rng.randn(5000).astype(np.float32) * s for s in (1.0, 3.0, 0.5)]
    mine, ref = quant.CalibrationCollector(mode), jquant.CalibrationCollector(
        mode)
    for b in batches:
        mine.collect("l1", torch.tensor(b))
        ref.collect("l1", jnd.array(b))
    assert mine.minmax == ref.minmax
    assert mine.thresholds("l1") == ref.thresholds("l1")
    if mode == "entropy":
        np.testing.assert_array_equal(mine.hists["l1"], ref.hists["l1"])
        np.testing.assert_array_equal(mine.edges["l1"], ref.edges["l1"])
        assert abs(mine.hists["l1"].sum() - (64 + 15000)) < 1e-6


# -- whole nets ---------------------------------------------------------------


def _set_jax_weights(jnet, weights):
    for k, p in jnet.collect_params().items():
        p.shape = weights[k].shape
        p._data = NDArray(jnp.asarray(weights[k]), ctx=mx.cpu())
        p._deferred_init_args = None


def _draw(net, x, seed):
    """numpy weights at the port net's shapes (one forward resolves the
    deferred ones): weights N(0, 1/fan_in), biases and betas N(0, 0.1²),
    gammas 1 + N(0, 0.1²), moving means N(0, 0.1²), variances U(0.5,
    1.5)."""
    with torch.no_grad():
        net(torch.tensor(x))
    rng = np.random.RandomState(seed)
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


def _small_nets(pkg_nn):
    net = pkg_nn.HybridSequential()
    net.add(pkg_nn.Conv2D(8, 3, padding=1, activation="relu"),
            pkg_nn.MaxPool2D(2), pkg_nn.Flatten(),
            pkg_nn.Dense(32, activation="relu"), pkg_nn.Dense(10))
    return net


def _pair(kind, x):
    """The port net and the JAX net (eager) on the same numpy weights."""
    if kind == "small":
        net, jnet = _small_nets(nn), _small_nets(jnn)
    else:
        net = resnet.ResNetV1(resnet.BottleneckV1, [1], [16, 64], classes=4,
                              thumbnail=True)
        jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1], [16, 64],
                                classes=4, thumbnail=True)
    net.initialize(device="cpu")
    weights = _draw(net, x, seed=11)
    params_from_jax(weights, net)
    jnet.initialize(ctx=mx.cpu())
    _set_jax_weights(jnet, weights)
    return net, jnet


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind,mode,fuse", [
    ("small", "naive", False), ("small", "entropy", False),
    ("thumb", "naive", False), ("thumb", "entropy", True)])
def test_quantize_net_matches_jax(kind, mode, fuse):
    rng = np.random.RandomState(12)
    x = rng.rand(8, 1 if kind == "small" else 3, 16, 16).astype(np.float32)
    net, jnet = _pair(kind, x)
    if fuse:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert contrib.fuse_conv_bn(net) == jcontrib.fuse_conv_bn(jnet) \
                == 4
        with torch.no_grad():
            got = net(torch.tensor(x)).numpy()
        want = jnet(jnd.array(x)).asnumpy()
        assert _rel(got, want) <= 1e-5       # the float net, folded
    exclude = ("4",) if kind == "small" and mode == "entropy" else ()
    quant.quantize_net(net, calib_data=[x], calib_mode=mode,
                       exclude_layers=exclude)
    jquant.quantize_net(jnet, calib_data=[jnd.array(x)], calib_mode=mode,
                        exclude_layers=exclude)
    n_q = sum(isinstance(m, (quant.QuantizedConv2D, quant.QuantizedDense))
              for m in net.modules())
    assert n_q == (3 - len(exclude) if kind == "small" else 5 + 1)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    want = jnet(jnd.array(x)).asnumpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(got, want) <= NET_TOL, _rel(got, want)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_quantized_layers_refuse_what_the_jax_layer_mishandles():
    for kw in (dict(layout="NHWC", in_channels=4), dict(groups=2,
                                                        in_channels=4)):
        conv = nn.Conv2D(4, 3, **kw)
        conv.initialize(device="cpu")
        with pytest.raises(ValueError, match="layout|groups"):
            quant.QuantizedConv2D(conv, (-1.0, 1.0))
    with pytest.raises(ValueError, match="int8"):
        quant.quantize_net(nn.HybridSequential(), quantized_dtype="uint8")


def test_fuse_conv_bn_adds_a_bias_and_warns():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, use_bias=False, in_channels=2),
            nn.BatchNorm(in_channels=4), nn.Conv2D(2, 1, activation="relu",
                                                   in_channels=4),
            nn.BatchNorm(in_channels=2))
    net.initialize(device="cpu")
    with pytest.warns(UserWarning, match="folded 1 conv->BN pair"):
        assert contrib.fuse_conv_bn(net) == 1
    assert isinstance(net[1], nn.Identity) and net[0].bias is not None
    assert isinstance(net[3], nn.BatchNorm)   # its conv has an activation
    assert "0.bias" in net.collect_params()


# -- the example --------------------------------------------------------------


def test_example_runs_in_process(capsys, monkeypatch):
    res = quantize_resnet50.main(["--device", "cpu", "--model", "resnet18_v1",
                                  "--batch", "2", "--image-size", "32",
                                  "--eval-batches", "1", "--calib-batches",
                                  "1"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == res and [r["calib_mode"] for r in lines] == [
        "naive", "entropy"]
    for r in lines:
        assert set(r) == {"model", "platform", "calib_mode", "batch",
                          "top1_agreement_vs_float", "float_img_per_sec",
                          "int8_img_per_sec", "speedup"}
        assert r["platform"] == "cpu" and r["batch"] == 2
        assert r["float_img_per_sec"] > 0 and r["int8_img_per_sec"] > 0
    with pytest.raises(FileNotFoundError):
        quantize_resnet50.main(["--cpu", "--data-rec", "/nonexistent.rec"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        quantize_resnet50.main(["--model", "resnet18_v1"])
