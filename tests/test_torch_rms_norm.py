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


# ---------------------------------------------------------------------------
# the backward kernel's order of sums, emulated
# ---------------------------------------------------------------------------

def _f32(v):
    return np.float32(v)


def _fma(a, b, c):
    """a*b + c rounded once to float32, as the card's fused multiply-add
    (the product of two float32 values is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _kernel_rms_bwd(x, g, gamma, rrms, sms=132):
    """(dx, dgamma) in float32 by ``csrc/rms_norm.cu``'s order of sums for
    float32 rows of at most 1024 values: lane l holds values (l + 32 j) *
    E + e, with E = 4 (16-byte chunks) where the width is a multiple of 4
    and E = 1 (single values l + 32 j) elsewhere; it sums gg·x over them
    in order and the warp adds the lanes' sums by shuffles (xor 16, 8, 4,
    2, 1); dx = rrms·(gg − x·rrms²·s/n).  Warp w of a block adds the
    dgamma terms g·x·rrms of rows first + w, first + w + 8, ...; the block
    adds its 8 warps in order; then warp v of the partials' sum
    (``rms_bwd_sum``) adds blocks v, v + 32, ... and the 32 warps are
    added in order.  The blocks are ``rn.bwd_plan``'s."""
    rows, cols = x.shape
    assert cols <= 1024
    e = 4 if cols % 4 == 0 else 1
    nc = -(-cols // (32 * e))
    order = [[(lane + 32 * j) * e + k for j in range(nc) for k in range(e)]
             for lane in range(32)]
    gam = gamma.astype(np.float32)
    n = _f32(cols)
    dx = np.zeros((rows, cols), np.float32)
    for row in range(rows):
        r = _f32(rrms[row])
        gg = (g[row] * gam).astype(np.float32)
        lanes = []
        for cs in order:
            s = _f32(0)
            for c in cs:
                if c < cols:
                    s = _fma(gg[c], x[row, c], s)
            lanes.append(s)
        v = np.array(lanes, np.float32)
        for off in (16, 8, 4, 2, 1):
            v = (v[:off] + v[off:2 * off]).astype(np.float32)
        t = ((x[row] * _f32(r * r)).astype(np.float32) * v[0]).astype(
            np.float32)
        dx[row] = (r * (gg - (t / n).astype(np.float32))).astype(np.float32)
    per_block, blocks = rn.bwd_plan(rows, cols, sms)
    parts = np.zeros((blocks, cols), np.float32)
    for blk in range(blocks):
        first, last = blk * per_block, min(rows, (blk + 1) * per_block)
        warps = np.zeros((8, cols), np.float32)
        for w in range(8):
            for row in range(first + w, last, 8):
                gx = (g[row] * x[row]).astype(np.float32)
                warps[w] = _fma(gx, _f32(rrms[row]), warps[w])
        for w in range(8):
            parts[blk] = (parts[blk] + warps[w]).astype(np.float32)
    red = np.zeros((32, cols), np.float32)
    for v in range(32):
        for b in range(v, blocks, 32):
            red[v] = (red[v] + parts[b]).astype(np.float32)
    dgamma = np.zeros(cols, np.float32)
    for v in range(32):
        dgamma = (dgamma + red[v]).astype(np.float32)
    return dx, dgamma


def _close_scaled(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("shape", [(16, 512), (7, 100), (40, 1024),
                                   (5, 301)])
def test_kernel_bwd_order_matches_rms_vjp_bwd(shape, sms, monkeypatch):
    """The backward kernel's order of sums (``_kernel_rms_bwd``; at sms=1
    every block takes several rows a warp and several warps sum into one
    block; width 301 takes single values) against the JAX package's
    ``_rms_vjp_bwd`` (the Pallas kernel in interpret mode), float32, dx
    and dgamma each within 1e-5 of its largest value."""
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, g = _inputs(shape, seed=7)
    _, res = pk._rms_fwd(jnp.asarray(x), jnp.asarray(gamma), 1e-6)
    want = pk._rms_vjp_bwd(1e-6, res, jnp.asarray(g))
    rrms = np.asarray(res[2])[:shape[0], 0]
    got = _kernel_rms_bwd(x, g, gamma, rrms, sms)
    for name, a, b in zip(("dx", "dgamma"), got, want):
        _close_scaled(a, np.asarray(b), 1e-5, name)


@pytest.mark.parametrize("rows,cols,sms", [
    (32768, 512, 132), (16, 512, 132), (7, 100, 132), (40, 1024, 1),
    (1000, 7, 132), (100000, 513, 132), (100000, 1024, 132),
    (64, 1025, 132), (3, 16385, 132), (100000, 64, 132), (9, 64, 132),
    (1, 1, 1)])
def test_bwd_plan_gives_every_row_one_block(rows, cols, sms):
    """Every row lies in exactly one block; rows of at most 1024 values
    take at most one block for every eight rows (a block's warps) and at
    most the blocks that stay resident, two an SM up to 512 values and
    one above; wider rows at most four blocks an SM."""
    per_block, blocks = rn.bwd_plan(rows, cols, sms)
    assert per_block >= 1 and (blocks - 1) * per_block < rows <= (
        blocks * per_block)
    if cols <= 1024:
        per_sm = 2 if cols <= 512 else 1
        assert blocks <= min(per_sm * sms, -(-rows // 8))
    else:
        assert blocks <= 4 * sms


def test_path_plan_fills_every_sm_once():
    """The TransformerLM's rows, (32768, 512) on 132 SMs: 263 blocks, two
    on every SM but one, each 125 rows (about 16 a warp), the last 18."""
    assert rn.bwd_plan(32768, 512, 132) == (125, 263)
