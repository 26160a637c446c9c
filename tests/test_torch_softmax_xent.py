"""Softmax cross-entropy of the PyTorch port against the JAX package.

The port's plain versions (what its wrappers run on a CPU tensor), by
way of ``SoftmaxXentFunction``, are held against ``fused_softmax_xent``
under ``jax.vjp``: in Pallas interpret mode for C <= 16384 and by the
JAX package's composition for C = 16385, the first width past its
kernel's cut-over.  The port has no cut-over (its kernel takes any
width), so both sides of it are the same port code.  The CUDA kernels
run only on the card (``tests/test_torch_cuda.py``).

Tolerances: loss float32 rtol=atol=1e-5 (logsumexp summed in another
order); dx float32 atol=1e-6 (probabilities of at most 1, one rounding
of exp apart); bfloat16 logits: loss 1e-5 (both sides widen the same
bf16 values to float32), dx rtol=8e-3 (one bf16 ulp of each element,
at most 2^-7 of it) and atol=1e-6 (for the entries near 0).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import nn_ops as jax_nn_ops
from incubator_mxnet_tpu.ops import pallas_kernels as pk

from incubator_mxnet_tpu_torch.ops import nn_ops
from incubator_mxnet_tpu_torch.ops import softmax_xent as sx

SHAPES = [(7, 100), (16, 2), (9, 1000), (3, 16384), (3, 16385),
          (35, 10000)]    # the LSTM LM's vocabulary, one batch row of T=35
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
DX_TOL = {"float32": dict(rtol=0, atol=1e-6),
          "bfloat16": dict(rtol=8e-3, atol=1e-6)}


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")


def _inputs(shape, seed=0):
    n, c = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[0] = -1          # clipped to 0
    if n > 1:
        labels[1] = c + 5   # clipped to c - 1
    g = rng.standard_normal(n).astype(np.float32)
    return x, labels, g


def _jax_loss_and_dx(x, labels, g, dtype):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    loss, vjp = jax.vjp(lambda a: pk.fused_softmax_xent(a, jnp.asarray(
        labels)), jx)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_matches_fused_softmax_xent(shape, dtype):
    x, labels, g = _inputs(shape)
    want_loss, want_dx = _jax_loss_and_dx(x, labels, g, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    before = (sx.fwd_launches, sx.bwd_launches)
    loss = sx.SoftmaxXentFunction.apply(tx, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert (sx.fwd_launches, sx.bwd_launches) == before  # CPU: plain
    assert loss.dtype == torch.float32 and loss.shape == (shape[0],)
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == shape
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.float().numpy(), want_dx,
                               **DX_TOL[dtype])


def test_labels_are_clipped_into_the_row():
    x, labels, _ = _inputs((4, 50), seed=1)
    labels[:] = [-1, 55, -7, 49]
    clipped = np.clip(labels, 0, 49)
    tx = torch.from_numpy(x)
    a, lse_a = sx.softmax_xent_fwd(tx, torch.from_numpy(labels))
    b, lse_b = sx.softmax_xent_fwd(tx, torch.from_numpy(clipped))
    assert torch.equal(a, b) and torch.equal(lse_a, lse_b)
    g = torch.ones(4)
    assert torch.equal(sx.softmax_xent_bwd(tx, torch.from_numpy(labels),
                                           lse_a, g),
                       sx.softmax_xent_bwd(tx, torch.from_numpy(clipped),
                                           lse_b, g))
    want = torch.logsumexp(tx, 1) - tx[torch.arange(4),
                                       torch.from_numpy(clipped).long()]
    torch.testing.assert_close(a, want, **LOSS_TOL)


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_op(dtype, pallas, monkeypatch):
    """``nn_ops.softmax_xent`` against the JAX op, with the JAX package
    on its kernel and on its plain formulation: the loss comes out in
    the logits' dtype in both packages."""
    monkeypatch.setenv("MXNET_USE_PALLAS", pallas)
    x, labels, _ = _inputs((6, 300), seed=2)
    want = jax_nn_ops.softmax_xent(jnp.asarray(x).astype(getattr(jnp, dtype)),
                                   jnp.asarray(labels))
    got = nn_ops.softmax_xent(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(labels))
    assert got.dtype == getattr(torch, dtype)
    tol = LOSS_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The plain backward against PyTorch's derivative of the plain
    forward, float32 atol 1e-6."""
    x, labels, g = _inputs((5, 40), seed=3)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss, lse = sx.softmax_xent_fwd_reference(tx, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    dx = sx.softmax_xent_bwd_reference(tx.detach(), torch.from_numpy(labels),
                                       lse.detach(), torch.from_numpy(g))
    torch.testing.assert_close(dx, tx.grad, rtol=0, atol=1e-6)


def test_other_device_raises_instead_of_falling_back():
    x = torch.empty(4, 8, device="meta")
    lbl = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sx.softmax_xent_fwd(x, lbl)
    with pytest.raises(ValueError, match="unsupported device"):
        sx.softmax_xent_bwd(x, lbl, torch.empty(4, device="meta"),
                            torch.empty(4, device="meta"))
