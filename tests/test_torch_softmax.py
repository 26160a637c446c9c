"""Softmax of the PyTorch port against the JAX package.

The port's plain versions (what its wrappers run on a CPU tensor), by
way of ``SoftmaxFunction``, are held against ``fused_softmax`` run
directly, which is Pallas interpret mode on the CPU (as
``tests/test_pallas.py`` runs it), and the op ``nn_ops.softmax`` against
the JAX op's function under ``MXNET_USE_PALLAS=1`` (``Op.fn``: the
registry's jitted call takes keyword arguments as static, and ``length``
is an array).  Width 16385 is the first past
the TPU kernel's cut-over, where the JAX package computes
``jax.nn.softmax`` in x's dtype; the port has no cut-over.  In bfloat16
that composition computes in bf16 arithmetic, so there the port is held
to the kernels' arithmetic instead: ``fused_softmax`` and its VJP on the
float32 widening of the same bf16 values (the backward from the
rounded y), rounded once to bf16.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``).

Tolerances: float32 y rtol=1e-5, atol=1e-6 (both sides take exp and a
sum of up to 16385 terms in float32, in another order); dx atol=1e-6
(|dx| <= |y|·(|g| + |Σy·g|), summed in another order).  bfloat16: y and
dx within one bf16 ulp of the value (2^-8 of it: both sides compute the
same float32 value up to rounding, then round once to bf16, and may land
on neighbouring bf16 values) plus the float32 allowance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import nn_ops as jax_nn_ops
from incubator_mxnet_tpu.ops import pallas_kernels as pk

from incubator_mxnet_tpu_torch.ops import nn_ops
from incubator_mxnet_tpu_torch.ops import softmax as sm

CASES = [((4, 7), -1), ((10, 300), -1), ((2, 3, 129), -1), ((3, 16385), -1),
         ((6, 5, 4), 0), ((2, 3, 129), 1)]
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")


def _assert_close(got, want, dtype):
    """``got`` and ``want`` float32 numpy; bf16: one bf16 ulp of the
    value plus the float32 allowance."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
        return
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    bound = ulp + F32["atol"] + F32["rtol"] * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        np.max(np.abs(got - want) - bound)


def _both(arr, dtype):
    return (torch.from_numpy(arr).to(getattr(torch, dtype)),
            jnp.asarray(arr).astype(getattr(jnp, dtype)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", CASES)
def test_function_matches_fused_softmax(shape, axis, dtype):
    """Forward and the gradient of a random cotangent, through
    ``SoftmaxFunction`` (plain versions) against ``jax.vjp`` of
    ``fused_softmax``."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    tx, jx = _both(x, dtype)
    tg, jg = _both(g, dtype)
    if dtype == "bfloat16" and shape[axis] > pk._MAX_COLS:
        f32 = jnp.float32
        jy = pk.fused_softmax(jx.astype(f32), axis).astype(jx.dtype)
        (jdx,) = pk._fused_softmax_bwd(axis, jy.astype(f32), jg.astype(f32))
        jdx = jdx.astype(jx.dtype)
    else:
        jy, vjp = jax.vjp(lambda a: pk.fused_softmax(a, axis), jx)
        (jdx,) = vjp(jg)
    tx.requires_grad_(True)
    before = (sm.fwd_launches, sm.bwd_launches)
    y = sm.SoftmaxFunction.apply(tx, axis)
    y.backward(tg)
    assert (sm.fwd_launches, sm.bwd_launches) == before  # CPU: plain
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == tx.shape
    _assert_close(_np(y), _np(jy), dtype)
    _assert_close(_np(tx.grad), _np(jdx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extreme_values(dtype):
    """Large logits, -inf entries (what the ``length`` mask makes) and a
    constant row, against the Pallas kernel."""
    x = np.array([[1e4, 1e4 + 1, -1e4, 0.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [3.0, -np.inf, -np.inf, 1.0],
                  [-np.inf, 2.0, -np.inf, -np.inf]], np.float32)
    tx, jx = _both(x, dtype)
    want = _np(pk.fused_softmax(jx, -1))
    got = _np(sm.softmax_fwd(tx))
    assert np.isfinite(got).all()
    _assert_close(got, want, dtype)
    np.testing.assert_array_equal(got[2:] == 0, np.isinf(x[2:]))


def test_gradient_matches_jax_grad():
    """``SoftmaxFunction``'s gradient of a weighted sum against
    ``jax.grad`` of ``jax.nn.softmax``, float32."""
    x = np.random.default_rng(1).standard_normal((5, 33)).astype(np.float32)
    w = np.arange(33, dtype=np.float32)
    want = jax.grad(lambda a: (jax.nn.softmax(a, axis=-1) * w).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (sm.SoftmaxFunction.apply(tx, -1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_op_matches_jax_op(axis, dtype):
    """``nn_ops.softmax`` with a temperature and a ``length`` mask against
    the JAX op on its kernel.  Every row keeps at least one entry: see
    the next test for a row of length 0."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    lshape = (3, 4) if axis == 1 else (3, 10)
    length = rng.integers(1, x.shape[axis] + 1, lshape).astype(np.int32)
    tx, jx = _both(x, dtype)
    want = _np(jax_nn_ops.softmax.fn(jx, axis=axis, temperature=0.7,
                                     length=jnp.asarray(length)))
    got = _np(nn_ops.softmax(tx, axis=axis, temperature=0.7,
                             length=torch.from_numpy(length)))
    _assert_close(got, want, dtype)
    assert (got == 0).sum() == x.size - length.sum()


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_length_zero_row(pallas, monkeypatch):
    """A row of length 0 is all -inf, and its softmax is NaN in the port,
    as ``jax.nn.softmax`` gives it (the JAX op without its kernel).  The
    TPU kernel pads a row to a multiple of 128 columns with -1e30, so on
    its kernel the JAX op gives NaN at width 128 and 0 at width 10: the
    padding, not the function, decides (ROADMAP §C)."""
    monkeypatch.setenv("MXNET_USE_PALLAS", pallas)
    for width in (10, 128):
        x = np.random.default_rng(4).standard_normal((2, width)).astype(
            np.float32)
        length = np.array([0, 3], np.int32)
        want = np.asarray(jax_nn_ops.softmax.fn(jnp.asarray(x),
                                                length=jnp.asarray(length)))
        got = nn_ops.softmax(torch.from_numpy(x),
                             length=torch.from_numpy(length)).numpy()
        assert np.isnan(got[0]).all() and np.isfinite(got[1]).all()
        np.testing.assert_allclose(got[1], want[1], **F32)
        if pallas == "0" or width % 128 == 0:
            assert np.isnan(want[0]).all()
        else:
            assert (want[0] == 0).all()


def test_op_is_differentiable_through_the_mask():
    """The masked entries get no gradient and the rest get the softmax's,
    as ``jax.grad`` of the JAX op gives them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    length = np.array([9, 5, 1, 3], np.int32)
    w = rng.standard_normal((4, 9)).astype(np.float32)
    want = jax.grad(lambda a: (jax_nn_ops.softmax.fn(
        a, length=jnp.asarray(length)) * w).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (nn_ops.softmax(tx, length=torch.from_numpy(length))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **F32)


def test_other_device_raises_instead_of_falling_back():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sm.softmax_fwd(x)
    with pytest.raises(ValueError, match="unsupported device"):
        sm.softmax_bwd(x, x)
