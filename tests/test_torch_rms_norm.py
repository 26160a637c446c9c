"""RMSNorm of the PyTorch port against the JAX package.

The port's plain versions (what its wrappers run on a CPU tensor), by
way of ``RMSNormFunction``, are held against ``fused_rms_norm`` under
``jax.vjp``, which runs the Pallas kernels in interpret mode on the CPU
(as ``tests/test_pallas.py`` runs them), and the op ``nn_ops.rms_norm``
against the JAX op.  Width 16385 is the first past the TPU kernels'
cut-over, where the JAX package uses its XLA formula; the port has no
cut-over.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``).

Tolerances: float32 rtol=1e-5, atol=1e-6 (sums of squares and of gg·x
over a row, and dgamma over all rows, in another order); rrms rtol=1e-6.
bfloat16: y, dx and dgamma within one bf16 ulp of the value (both sides
compute the same float32 value up to rounding, then round once, and may
land on neighbouring bf16 values) plus the float32 allowance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import nn_ops as jax_nn_ops
from incubator_mxnet_tpu.ops import pallas_kernels as pk

from incubator_mxnet_tpu_torch.ops import nn_ops
from incubator_mxnet_tpu_torch.ops import rms_norm as rn

# (x shape, x dtype, gamma dtype): tests/test_pallas.py's shapes, the
# transformer's (32, 512) bfloat16, a float32 gamma on bfloat16 x (cast
# to x's dtype first on both sides), and the first width past the cut-over
CASES = [((4, 7), "float32", "float32"), ((10, 300), "float32", "float32"),
         ((2, 3, 129), "float32", "float32"),
         ((4, 7), "bfloat16", "bfloat16"), ((10, 300), "bfloat16", "bfloat16"),
         ((2, 3, 129), "bfloat16", "bfloat16"),
         ((32, 512), "bfloat16", "bfloat16"), ((32, 512), "float32", "float32"),
         ((6, 100), "bfloat16", "float32"), ((3, 16385), "float32", "float32")]
F32 = dict(rtol=1e-5, atol=1e-6)


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
        return
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    bound = ulp + F32["atol"] + F32["rtol"] * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        np.max(np.abs(got - want) - bound)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, g


def _both(arr, dtype):
    return (torch.from_numpy(arr).to(getattr(torch, dtype)),
            jnp.asarray(arr).astype(getattr(jnp, dtype)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype,gdtype", CASES)
def test_function_matches_fused_rms_norm(shape, dtype, gdtype):
    """y, dx and dgamma through ``RMSNormFunction`` (plain versions)
    against ``jax.vjp`` of ``fused_rms_norm``."""
    x, gamma, g = _inputs(shape)
    tx, jx = _both(x, dtype)
    tgam, jgam = _both(gamma, gdtype)
    tg, jg = _both(g, dtype)
    jy, vjp = jax.vjp(lambda a, b: pk.fused_rms_norm(a, b, 1e-6), jx, jgam)
    jdx, jdgamma = vjp(jg)
    tx.requires_grad_(True)
    tgam.requires_grad_(True)
    before = (rn.fwd_launches, rn.bwd_launches)
    y = rn.RMSNormFunction.apply(tx, tgam, 1e-6)
    y.backward(tg)
    assert (rn.fwd_launches, rn.bwd_launches) == before  # CPU: plain
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert tx.grad.dtype == tx.dtype and tgam.grad.dtype == tgam.dtype
    _assert_close(_np(y), _np(jy), dtype)
    _assert_close(_np(tx.grad), _np(jdx), dtype)
    _assert_close(_np(tgam.grad), _np(jdgamma), gdtype)


@pytest.mark.parametrize("shape", [(4, 7), (10, 300), (2, 3, 129)])
def test_rrms_matches_pallas_kernel(shape):
    """The saved float32 statistic against the one ``_rms_fwd`` keeps
    (padded to a multiple of 8 rows, as (rows_p, 1))."""
    x, gamma, _ = _inputs(shape, seed=1)
    _, rrms = rn.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(gamma))
    _, (_, _, jrrms, rows) = pk._rms_fwd(jnp.asarray(x), jnp.asarray(gamma),
                                         1e-6)
    assert rrms.dtype == torch.float32 and rrms.shape == (rows,)
    np.testing.assert_allclose(rrms.numpy(), np.asarray(jrrms)[:rows, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_op_on_the_trailing_axis(dtype, monkeypatch):
    """``nn_ops.rms_norm`` over the last axis against the JAX op on its
    kernel: y comes out in x's dtype in both."""
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, _ = _inputs((5, 3, 64), seed=2)
    tx, jx = _both(x, dtype)
    tgam, jgam = _both(gamma, dtype)
    want = jax_nn_ops.rms_norm(jx, jgam)
    got = nn_ops.rms_norm(tx, tgam)
    assert got.dtype == tx.dtype
    _assert_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_op_on_another_axis(dtype):
    """Over axis 1 both packages take the plain formula (y rounded to x's
    dtype before ``* gamma``, gamma broadcast against the last axis), and
    the gradients of x and gamma agree.  In bfloat16 those gradients are
    each framework's autodiff through bf16 intermediates, rounded at
    other places, and dx's terms cancel: each is held to one bf16 ulp of
    its tensor's largest value."""
    x, _, g = _inputs((4, 6, 5), seed=3)
    gamma = (np.random.default_rng(4).random(5) + 0.5).astype(np.float32)
    tx, jx = _both(x, dtype)
    tgam, jgam = _both(gamma, dtype)
    tg, jg = _both(g, dtype)
    fn = jax_nn_ops.rms_norm.fn
    want, vjp = jax.vjp(lambda a, b: fn(a, b, axis=1), jx, jgam)
    jdx, jdgamma = vjp(jg)
    tx.requires_grad_(True)
    tgam.requires_grad_(True)
    got = nn_ops.rms_norm(tx, tgam, axis=1)
    got.backward(tg)
    assert got.dtype == tx.dtype
    _assert_close(_np(got), _np(want), dtype)
    for a, b in ((tx.grad, jdx), (tgam.grad, jdgamma)):
        a, b = _np(a), _np(b)
        if dtype == "float32":
            _assert_close(a, b, dtype)
        else:
            top = np.abs(b).max()
            assert np.abs(a - b).max() <= np.ldexp(1.0, np.frexp(top)[1] - 8)


def test_other_device_raises_instead_of_falling_back():
    x = torch.empty(4, 8, device="meta")
    gamma = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rn.rms_norm_fwd(x, gamma)
    with pytest.raises(ValueError, match="unsupported device"):
        rn.rms_norm_bwd(x, x, gamma, torch.empty(4, device="meta"))
