"""The PyTorch port's plain ops against the JAX package's, on the CPU.

Float32, tolerance 1e-5 relative and absolute, for sums taken in
another order; the bfloat16 tests of ``log_softmax`` and ``dropout``
state theirs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.ops import index_ops as jax_index_ops
from incubator_mxnet_tpu.ops import nn_ops as jax_nn_ops
from incubator_mxnet_tpu.ops.registry import invoke

from incubator_mxnet_tpu_torch.ops import elemwise, index_ops, nn_ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_gelu_is_the_erf_form():
    x = _rand(64, seed=1) * 3
    got = elemwise.gelu(torch.from_numpy(x)).numpy()
    want = invoke("gelu", nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    tanh_form = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    assert np.abs(got - tanh_form).max() > 1e-4


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_matches_jax(flatten):
    x = _rand(2, 3, 4, seed=2)
    in_units = 12 if flatten else 4
    w = _rand(5, in_units, seed=3)
    b = _rand(5, seed=4)
    got = nn_ops.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), flatten=flatten)
    want = jax_nn_ops.fully_connected(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), flatten=flatten)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax(causal):
    q, k, v = (_rand(2, 3, 5, 8, seed=s) for s in (5, 6, 7))
    lengths = np.array([5, 2])
    mask = (np.arange(5)[None, :] < lengths[:, None]).reshape(2, 1, 1, 5)
    got = nn_ops.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
        causal=causal)
    want = jax_nn_ops.dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_clips_like_jax():
    w = _rand(10, 4, seed=8)
    ids = np.array([[0, 9, 10, -3, 25]], np.int32)
    got = index_ops.embedding(torch.from_numpy(ids), torch.from_numpy(w))
    want = jax_index_ops.embedding(jnp.asarray(ids), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_activation_tanh_and_unknown():
    x = _rand(16, seed=9)
    np.testing.assert_allclose(
        nn_ops.activation(torch.from_numpy(x), "tanh").numpy(),
        invoke("Activation", nd.array(x), act_type="tanh").asnumpy(), **TOL)
    with pytest.raises(ValueError, match="not ported"):
        nn_ops.activation(torch.from_numpy(x), "mish")


def test_dropout_identity_unless_training():
    x = torch.ones(4000)
    assert nn_ops.dropout(x, 0.5, mode="predict") is x
    assert nn_ops.dropout(x, 0.0, mode="training") is x
    g = torch.Generator().manual_seed(0)
    y = nn_ops.dropout(x, 0.25, mode="training", generator=g)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0) / 0.75)
    assert 0.70 < kept.float().mean().item() < 0.80
    y2 = nn_ops.dropout(torch.ones(64, 8), 0.5, axes=(1,),
                        generator=torch.Generator().manual_seed(1))
    assert ((y2 == 0).all(1) | (y2 != 0).all(1)).all()


def test_log_softmax_and_pick_match_jax():
    x = _rand(4, 6, 5, seed=10)
    # 7 and -9 clamp, -2 counts from the end, as in jnp.take_along_axis
    idx = np.array([[0, 4, 7, -2, -9, 1]] * 4, np.int32)
    lp = nn_ops.log_softmax(torch.from_numpy(x), axis=-1, temperature=2.0)
    want_lp = invoke("log_softmax", nd.array(x), axis=-1, temperature=2.0)
    np.testing.assert_allclose(lp.numpy(), want_lp.asnumpy(), **TOL)
    for keepdims in (False, True):
        got = index_ops.pick(lp, torch.from_numpy(idx), axis=-1,
                             keepdims=keepdims)
        want = jax_index_ops.pick(jnp.asarray(want_lp.asnumpy()),
                                  jnp.asarray(idx), axis=-1,
                                  keepdims=keepdims)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not ported"):
        index_ops.pick(lp, torch.from_numpy(idx), mode="wrap")


def test_log_softmax_bfloat16_rounds_the_temperature_like_jax():
    """bfloat16 at an inexact temperature: both divide by the temperature
    rounded to bf16 (JAX rounds the weak-typed scalar), so x / T is the
    same bf16 array on both sides; each library's own log_softmax may
    then round one bf16 ulp apart (measured: 3187 of 19200 elements,
    none by more).  Dividing by the unrounded 0.3 moves 2640 elements
    further than that."""
    x = (4 * np.random.RandomState(0).standard_normal((64, 300))).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    got = nn_ops.log_softmax(tx, axis=-1, temperature=0.3)
    want = np.asarray(jax_nn_ops.log_softmax.fn(
        jx, axis=-1, temperature=0.3).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(got), np.abs(want)))[1]
                   - 8)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_dropout_bfloat16_scales_like_jax(p):
    """The kept elements equal the JAX expression ``x / (1.0 - p)`` on the
    same bf16 values bit for bit: 1 - p is rounded to bf16 first (bf16(0.9)
    = 0.8984375).  The two packages draw different masks, so only the kept
    elements are compared."""
    jx = jnp.asarray(np.linspace(-3, 3, 1001, dtype=np.float32)).astype(
        jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    y = nn_ops.dropout(tx, p, generator=torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    want = np.asarray((jx / (1.0 - p)).astype(jnp.float32))
    kept = y != 0
    assert 0.5 * (1 - p) < kept.mean() < 1.0
    np.testing.assert_array_equal(y[kept], want[kept])


@pytest.mark.parametrize("case", ["fused", "axis0", "dense", "from_logits",
                                  "weighted"])
def test_softmax_ce_loss_matches_jax(case):
    """Both branches of ``SoftmaxCrossEntropyLoss`` and their gradients
    against the JAX loss (float32 1e-5)."""
    from incubator_mxnet_tpu import autograd as jax_autograd
    from incubator_mxnet_tpu import gluon as jax_gluon

    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    x = _rand(5, 7, seed=11)
    label = np.array([0, 6, 3, 9, -1], np.int32)
    kw, weight = {}, None
    if case == "axis0":
        kw = dict(axis=0)
        label = np.array([0, 4, 3, 2, 1, 4, 0], np.int32)
    elif case == "dense":
        kw = dict(sparse_label=False)
        label = np.abs(_rand(5, 7, seed=12))
    elif case == "from_logits":
        kw = dict(from_logits=True)
        x = np.array(jax.nn.log_softmax(jnp.asarray(x)))
        label = np.clip(label, 0, 6)
    elif case == "weighted":
        kw = dict(weight=0.5)
        weight = _rand(5, 1, seed=13)
    jloss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    jx = nd.array(x)
    jx.attach_grad()
    with jax_autograd.record():
        jl = jloss_fn(jx, nd.array(label), *(
            [nd.array(weight)] if weight is not None else []))
    jl.backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = SoftmaxCrossEntropyLoss(**kw)(
        tx, torch.from_numpy(label),
        *([torch.from_numpy(weight)] if weight is not None else []))
    loss.backward(torch.ones_like(loss))
    np.testing.assert_allclose(loss.detach().numpy(), jl.asnumpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)
