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


# ---------------------------------------------------------------------------
# the backward kernel's order of sums, emulated
# ---------------------------------------------------------------------------

def _f32(v):
    return np.float32(v)


def _fma(a, b, c):
    """a*b + c rounded once to float32, as the card's fused multiply-add
    (the product of two float32 values is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _kernel_ln_bwd(x, g, gamma, mean, rstd, sms=132):
    """(dx, dgamma, dbeta) in float32 by ``csrc/layer_norm.cu``'s order
    of sums for a row of at most 1024 float32 values whose chunks of 4
    load 16 bytes at a time: lane l sums its values (l + 32 j) * 4 + e in
    order and the warp adds the lanes' sums by shuffles (xor 16, 8, 4,
    2, 1); warp w of a block adds the dgamma and dbeta terms of rows
    first + w, first + w + 8, ...; the block adds its 8 warps in order;
    then warp v of the partials' sum adds blocks v, v + 32, ... and the
    32 warps are added in order.  The blocks are ``ln.bwd_plan``'s."""
    rows, cols = x.shape
    assert cols <= 1024 and cols % 4 == 0
    nc = -(-cols // 128)
    order = [[(lane + 32 * j) * 4 + e for j in range(nc) for e in range(4)]
             for lane in range(32)]
    gam = gamma.astype(np.float32)
    dx = np.zeros((rows, cols), np.float32)
    xh_all = ((x - mean[:, None]).astype(np.float32)
              * rstd[:, None]).astype(np.float32)
    for r in range(rows):
        xh = xh_all[r]
        gg = (g[r] * gam).astype(np.float32)
        lane1, lane2 = [], []
        for cs in order:
            s1 = s2 = _f32(0)
            for c in cs:
                if c < cols:
                    s1 = _f32(s1 + gg[c])
                    s2 = _fma(gg[c], xh[c], s2)
            lane1.append(s1)
            lane2.append(s2)
        v1, v2 = np.array(lane1, np.float32), np.array(lane2, np.float32)
        for off in (16, 8, 4, 2, 1):
            v1 = (v1[:off] + v1[off:2 * off]).astype(np.float32)
            v2 = (v2[:off] + v2[off:2 * off]).astype(np.float32)
        m1 = _f32(v1[0] / _f32(cols))
        m2 = _f32(v2[0] / _f32(cols))
        dx[r] = ((gg - m1).astype(np.float32)
                 - (xh * m2).astype(np.float32)).astype(np.float32) * rstd[r]
    per_block, blocks = ln.bwd_plan(rows, cols, sms)
    parts = np.zeros((2, blocks, cols), np.float32)
    for blk in range(blocks):
        first, last = blk * per_block, min(rows, (blk + 1) * per_block)
        warps = np.zeros((2, 8, cols), np.float32)
        for w in range(8):
            for r in range(first + w, last, 8):
                warps[0, w] = _fma(g[r], xh_all[r], warps[0, w])
                warps[1, w] = (warps[1, w] + g[r]).astype(np.float32)
        for w in range(8):
            parts[:, blk] = (parts[:, blk] + warps[:, w]).astype(np.float32)
    red = np.zeros((2, 32, cols), np.float32)
    for v in range(32):
        for b in range(v, blocks, 32):
            red[:, v] = (red[:, v] + parts[:, b]).astype(np.float32)
    sums = np.zeros((2, cols), np.float32)
    for v in range(32):
        sums = (sums + red[:, v]).astype(np.float32)
    return dx, sums[0], sums[1]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("shape", [(16, 768), (7, 100)])
def test_kernel_bwd_order_matches_fused_ln_bwd(shape, sms, monkeypatch):
    """The backward kernel's order of sums (``_kernel_ln_bwd``; at
    sms=1 every block takes several rows a warp and several warps sum
    into one block) against the JAX package's ``_fused_ln_bwd`` (the
    Pallas kernel in interpret mode), float32, each of dx, dgamma and
    dbeta within 1e-5 of its largest value."""
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, beta = _inputs(shape, seed=8)
    g = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    _, res = pk._fused_ln_fwd(jnp.asarray(x), jnp.asarray(gamma),
                              jnp.asarray(beta), 1e-5)
    want = pk._fused_ln_bwd(1e-5, res, jnp.asarray(g))
    mean = np.asarray(res[2])[:shape[0], 0]
    rstd = np.asarray(res[3])[:shape[0], 0]
    got = _kernel_ln_bwd(x, g, gamma, mean, rstd, sms)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        _close_scaled(a, np.asarray(b), 1e-5, name)


@pytest.mark.parametrize("rows,cols,sms", [
    (2048, 768, 132), (16, 768, 132), (7, 100, 132), (1000, 100, 132),
    (3, 4096, 132), (5, 20000, 132), (100000, 64, 132), (9, 64, 132),
    (1, 1, 1)])
def test_bwd_plan_gives_every_row_one_block(rows, cols, sms):
    """Every row lies in exactly one block; rows of at most 1024 values
    take at most two blocks an SM and one block for every eight rows
    (a block's warps), wider rows at most four blocks an SM."""
    per_block, blocks = ln.bwd_plan(rows, cols, sms)
    assert per_block >= 1 and (blocks - 1) * per_block < rows <= (
        blocks * per_block)
    if cols <= 1024:
        assert blocks <= min(2 * sms, -(-rows // 8))
    else:
        assert blocks <= 4 * sms


# ---------------------------------------------------------------------------
# the forward kernel's order of sums, emulated
# ---------------------------------------------------------------------------

def _kernel_ln_fwd(x, gamma, beta, eps):
    """(y, mean, rstd) in float32 by ``csrc/layer_norm.cu``'s forward
    for float32 rows of at most 1024 values: lane l holds values (l + 32
    j) * E + e, with E = 4 (16-byte chunks) where the width is a multiple
    of 4 and E = 1 (single values l + 32 j) elsewhere, sums them in that
    order, and the warp adds the lanes' sums by shuffles (xor 16, 8, 4,
    2, 1): mean = Σx / D; then the same for Σ(x − mean)² from the same
    registers: var = Σ / D, rstd = 1 / sqrt(var + eps); y = (x − mean)·
    rstd·gamma + beta with one rounding for the last multiply-add."""
    rows, cols = x.shape
    assert cols <= 1024
    e = 4 if cols % 4 == 0 else 1
    nc = -(-cols // (32 * e))
    order = [[(lane + 32 * j) * e + k for j in range(nc) for k in range(e)]
             for lane in range(32)]

    def warp_sum(lanes):
        v = np.array(lanes, np.float32)
        for off in (16, 8, 4, 2, 1):
            v = (v[:off] + v[off:2 * off]).astype(np.float32)
        return v[0]

    n = _f32(cols)
    y = np.zeros((rows, cols), np.float32)
    mean = np.zeros(rows, np.float32)
    rstd = np.zeros(rows, np.float32)
    for r in range(rows):
        xr = x[r].astype(np.float32)
        lanes = []
        for cs in order:
            s = _f32(0)
            for c in cs:
                if c < cols:
                    s = _f32(s + xr[c])
            lanes.append(s)
        mean[r] = _f32(warp_sum(lanes) / n)
        d = (xr - mean[r]).astype(np.float32)
        lanes = []
        for cs in order:
            s = _f32(0)
            for c in cs:
                if c < cols:
                    s = _fma(d[c], d[c], s)
            lanes.append(s)
        var = _f32(warp_sum(lanes) / n)
        rstd[r] = _f32(_f32(1) / np.sqrt(_f32(var + _f32(eps))))
        y[r] = _fma((d * rstd[r]).astype(np.float32), gamma, beta)
    return y, mean, rstd


@pytest.mark.parametrize("shape", [(16, 768), (7, 100), (5, 301)])
def test_kernel_fwd_order_matches_ln_fwd(shape, monkeypatch):
    """The forward kernel's order of sums (``_kernel_ln_fwd``; width 301
    takes single values) against the JAX package's ``_ln_fwd`` (the
    Pallas kernel in interpret mode), float32: y, mean and rstd each
    within 1e-6 of its largest value."""
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, beta = _inputs(shape, seed=10)
    jy, jmean, jrstd = pk._ln_fwd(jnp.asarray(x), jnp.asarray(gamma),
                                  jnp.asarray(beta), 1e-5)
    y, mean, rstd = _kernel_ln_fwd(x, gamma, beta, 1e-5)
    _close_scaled(y, np.asarray(jy), 1e-6, "y")
    _close_scaled(mean, np.asarray(jmean)[:shape[0], 0], 1e-6, "mean")
    _close_scaled(rstd, np.asarray(jrstd)[:shape[0], 0], 1e-6, "rstd")


@pytest.mark.parametrize("shape", [(16, 768), (7, 100)])
def test_plain_with_float32_params_on_bf16_x_matches_jax(shape, monkeypatch):
    """float32 gamma and beta on bfloat16 x, as amp leaves BERT's
    LayerNorm: the port's plain forward (what its wrapper runs on a CPU
    tensor, and what the kernel does in registers) rounds them to x's
    dtype, as ``_ln_fwd`` casts them; held against ``_ln_fwd`` and the
    op against the JAX op on its kernel, at the bfloat16 tolerance (y)
    and 1e-5 (the float32 statistics)."""
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")
    x, gamma, beta = _inputs(shape, seed=11)
    tx, jx = _both(x, "bfloat16")
    tg, jg = _both(gamma, "float32")
    tb, jb = _both(beta, "float32")
    y, mean, rstd = ln.layer_norm_fwd(tx, tg, tb, 1e-5)
    jy, jmean, jrstd = pk._ln_fwd(jx, jg, jb, 1e-5)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **TOL["bfloat16"])
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:shape[0], 0],
                               **STAT_TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:shape[0], 0],
                               **STAT_TOL)
    got = nn_ops.layer_norm(tx, tg, tb, eps=1e-5)
    want = jax_nn_ops.layer_norm(jx, jg, jb, eps=1e-5)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL["bfloat16"])
