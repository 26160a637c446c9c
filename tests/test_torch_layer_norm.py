"""LayerNorm of the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs on a CPU tensor) is
held against the Pallas kernel ``_ln_fwd``, run in interpret mode on the
CPU as the JAX package's own tests run it, and against the op
``nn_ops.layer_norm``.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerances: float32 1e-5 (the two sides sum in another order);
bfloat16 y rtol=atol=1e-2 (one bf16 ulp at |y| ~ 1), with gamma and
beta rounded to bf16 first on both sides, and 1e-5 on the float32
statistics.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.ops import nn_ops as jax_nn_ops
from incubator_mxnet_tpu.ops import pallas_kernels as pk

from incubator_mxnet_tpu_torch.error import KernelError
from incubator_mxnet_tpu_torch.ops import _build, layer_norm as ln
from incubator_mxnet_tpu_torch.ops import nn_ops

SHAPES = [(7, 100), (16, 768), (5, 3, 64)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
STAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, gamma, beta


def _both(arr, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``
    (bf16 rounding to nearest even on both sides)."""
    t = torch.from_numpy(arr).to(getattr(torch, dtype))
    j = jnp.asarray(arr).astype(getattr(jnp, dtype))
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel(shape, dtype):
    x, gamma, beta = _inputs(shape)
    tx, jx = _both(x, dtype)
    tg, jg = _both(gamma, dtype)
    tb, jb = _both(beta, dtype)
    y, mean, rstd = ln.layer_norm_fwd(tx, tg, tb, 1e-5)
    jy, jmean, jrstd = pk._ln_fwd(jx, jg, jb, 1e-5)
    rows = int(np.prod(shape[:-1]))
    assert y.shape == tx.shape and y.dtype == tx.dtype
    assert mean.dtype == rstd.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **TOL[dtype])
    # _ln_fwd pads the statistics to a multiple of 8 rows, as (rows_p, 1)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:rows, 0],
                               **STAT_TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:rows, 0],
                               **STAT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_jax_op(shape, dtype):
    x, gamma, beta = _inputs(shape, seed=1)
    tx, jx = _both(x, dtype)
    tg, jg = _both(gamma, dtype)
    tb, jb = _both(beta, dtype)
    got = nn_ops.layer_norm(tx, tg, tb, eps=1e-5)
    want = jax_nn_ops.layer_norm(jx, jg, jb, eps=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_op_over_inner_axis_matches_jax_op():
    x, _, _ = _inputs((5, 3, 64), seed=2)
    gamma = np.array([1.0, 0.5, 2.0], np.float32)
    beta = np.array([0.0, 0.1, -0.2], np.float32)
    got = nn_ops.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                            torch.from_numpy(beta), axis=1)
    want = jax_nn_ops.layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                                 jnp.asarray(beta), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, gamma, beta = _inputs((4, 32))
    before = ln.launches
    got = ln.layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(gamma),
                            torch.from_numpy(beta))
    want = ln.layer_norm_fwd_reference(torch.from_numpy(x),
                                       torch.from_numpy(gamma),
                                       torch.from_numpy(beta))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ln.launches == before


def test_other_device_raises_instead_of_falling_back():
    x = torch.empty(4, 32, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layer_norm_fwd(x, g, g)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(KernelError, match="cannot run nvcc"):
        _build.build(["layer_norm"])
    assert not list(tmp_path.glob("*.so"))


def test_library_is_keyed_on_sources(monkeypatch):
    path = _build.library_path("layer_norm")
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path("layer_norm")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("layer_norm") != path


# ---------------------------------------------------------------------------
# backward: LayerNormFunction against fused_layer_norm's custom VJP
# ---------------------------------------------------------------------------

# ragged on purpose: widths not a multiple of 128, rows not a multiple of 8
GRAD_SHAPES = [(7, 100), (13, 200), (3, 5, 130)]
# gradients: float32 1e-4 relative to the largest |value| (sums of up to
# 65 rows and 200 columns taken in another order); bfloat16 dx 2e-2
# (one bf16 ulp of dx plus the rounding of the bf16 cotangent's
# products), dgamma/dbeta are float32 sums in both dtypes: 1e-4 in
# float32 and 1e-3 for bf16 inputs (the rounded x and g of each row).
GRAD_TOL = {"float32": dict(dx=1e-4, params=1e-4),
            "bfloat16": dict(dx=2e-2, params=1e-3)}


def _close_scaled(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_function_grads_match_fused_layer_norm_vjp(shape, dtype, monkeypatch):
    import jax

    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, beta = _inputs(shape, seed=3)
    cot = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    tx, jx = _both(x, dtype)
    tcot, jcot = _both(cot, dtype)
    jg, jb = jnp.asarray(gamma), jnp.asarray(beta)
    jy, vjp = jax.vjp(lambda a, g, b: pk.fused_layer_norm(a, g, b, 1e-5),
                      jx, jg, jb)
    jdx, jdg, jdb = vjp(jcot)

    tx.requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    tb = torch.from_numpy(beta).requires_grad_(True)
    before = (ln.launches, ln.bwd_launches)
    y = ln.LayerNormFunction.apply(tx, tg, tb, 1e-5)
    y.backward(tcot)
    assert (ln.launches, ln.bwd_launches) == before   # CPU: plain versions
    assert y.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **TOL[dtype])
    tol = GRAD_TOL[dtype]
    _close_scaled(tx.grad.float().numpy(), jdx.astype(jnp.float32),
                  tol["dx"], "dx")
    _close_scaled(tg.grad.numpy(), jdg, tol["params"], "dgamma")
    _close_scaled(tb.grad.numpy(), jdb, tol["params"], "dbeta")


def test_bwd_plain_matches_autograd_of_plain_forward():
    """The hand-derived backward against PyTorch's own derivative of
    the plain forward, float32 1e-5 relative."""
    x, gamma, beta = _inputs((9, 70), seed=5)
    cot = torch.from_numpy(
        np.random.default_rng(6).standard_normal((9, 70)).astype(np.float32))
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    tb = torch.from_numpy(beta).requires_grad_(True)
    y, mean, rstd = ln.layer_norm_fwd_reference(tx, tg, tb)
    y.backward(cot)
    dx, dg, db = ln.layer_norm_bwd_reference(tx.detach(), cot, tg.detach(),
                                             mean.detach(), rstd.detach())
    for got, want in ((dx, tx.grad), (dg, tg.grad), (db, tb.grad)):
        _close_scaled(got.numpy(), want.numpy(), 1e-5, "grad")


def test_op_output_has_the_function_as_grad_fn():
    """``nn_ops.layer_norm`` is on the Function (the card has no other
    differentiable path), and every input gets a gradient."""
    x, gamma, beta = (torch.from_numpy(a).requires_grad_(True)
                      for a in _inputs((4, 32)))
    y = nn_ops.layer_norm(x, gamma, beta)
    assert isinstance(y.grad_fn, ln.LayerNormFunction._backward_cls)
    y.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (x, gamma, beta))
