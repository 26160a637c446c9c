"""The port's fused 1x1-conv + BatchNorm against the JAX package's, on the
CPU (``incubator_mxnet_tpu_torch/ops/fused_block.py`` against
``incubator_mxnet_tpu/ops/fused_block.py``).

On the CPU the port's wrappers run their plain versions, and
``FusedMatmulBNFunction`` joins them; on the JAX side ``_fmm`` runs the
Pallas kernels in interpret mode (``MXNET_USE_PALLAS=1``) and
``xla_matmul_bn`` is the XLA composition.  Inputs are made with numpy
from a seed and handed to both.

* forward ``(y, s1, s2)`` and the VJP ``(dx, dw, dscale, dbias)`` for
  nonzero cotangents of all three outputs, at the shapes of the JAX
  package's own test (``tests/test_fused_block.py``), with and without
  the prologue, in float32 and bfloat16;
* the ds1/ds2 cotangent chain through ``bn_consts`` (a 1x1, its BN's
  constants, a 1x1 with that prologue), as a bottleneck uses it;
* ``torch.autograd.gradcheck`` of the Function in float64;
* stat cotangents that are None read as zeros;
* kernel 12's bfloat16 arithmetic (``fused_matmul_bn_dw_mma``, which
  runs only on the card) emulated by ``_kernel_dw`` and held to the JAX
  VJP's dw at the shapes above, with the runs :func:`dw_mma_split`
  chooses and with 64-row runs, and the split rule's runs tiling M in
  whole 32-row stages;
* kernel 11's bfloat16 arithmetic (``fused_matmul_bn_dx_mma``, the card
  only) emulated by ``_kernel_fmm_dx`` and held to the JAX VJP's dx,
  dscale and dbias at the shapes above, with and without the prologue;
* kernel 10's bfloat16 arithmetic (``fused_matmul_bn_fwd_mma``, the card
  only) emulated by ``_kernel_fmm_fwd`` and held to the JAX package's
  Pallas forward ``_fwd_impl`` (interpret mode) at the shapes above and
  one whose K is not a multiple of 8, with and without the prologue, and
  its split rule's runs tiling M in whole 128-row blocks;
* kernels 12's and 11's float32 tiles (``fused_matmul_bn_dw_tf32`` and
  ``fused_matmul_bn_dx_tf32``, the card only, three tf32 products a
  float32 product) emulated by ``_kernel_dw_tf32`` and
  ``_kernel_fmm_dx_tf32`` and held to the JAX VJP's dw, and its dx,
  dscale and dbias, within the float32 tolerance, with and without the
  prologue;
* kernel 10's float32 tile (``fused_matmul_bn_fwd_tf32``, the card only)
  emulated by ``_kernel_fmm_fwd_tf32`` and held to the JAX package's
  Pallas forward ``_fwd_impl`` (interpret mode) in float32, with and
  without the prologue, and its split rule's float32 runs tiling M in
  whole 128-row blocks at 64 columns a tile.

Tolerances, each max |port - JAX| against the largest |JAX| value of the
tensor: float32 1e-5 (the same formulas, sums in another order);
bfloat16 2e-2 (one bf16 ulp, 2^-7 of a value, where an f32 sum in
another order rounds to the other neighbour).  The column sums s1, s2,
dscale, dbias and dw are sums over M, held to the same share of their
largest value.  The chain: loss 1e-5 relative, gradients 1e-4 of the
largest (two products and a BN fold in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import fused_block as jfb
from incubator_mxnet_tpu_torch.ops import _fused_common as fc
from incubator_mxnet_tpu_torch.ops import fused_block as fb

SHAPES = [(256, 128, 128),   # whole TPU tiles
          (200, 96, 72),     # ragged in every dimension
          (1024, 256, 64),   # tall and narrow, like a c1
          (512, 64, 256)]    # widening, like a c3
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run faster on one thread than on many that
    other processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=(rng.randn(m, k) * 0.5).astype(np.float32),
                w=(rng.randn(k, n) * k ** -0.5).astype(np.float32),
                scale=(rng.rand(k) + 0.5).astype(np.float32),
                bias=(rng.randn(k) * 0.2).astype(np.float32),
                dy=(rng.randn(m, n) * 0.1).astype(np.float32),
                ds1=(rng.randn(n) * 0.01).astype(np.float32),
                ds2=(rng.randn(n) * 0.001).astype(np.float32))


def _to_jax(a, dtype):
    return {k: jnp.asarray(v, JNP[dtype] if k in ("x", "w", "dy")
                           else jnp.float32) for k, v in a.items()}


def _to_torch(a, dtype):
    return {k: torch.from_numpy(v).to(TORCH[dtype] if k in ("x", "w", "dy")
                                      else torch.float32)
            for k, v in a.items()}


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).float().detach().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}"


def _jax_vjp(fn, j, prologue):
    ones = jnp.ones(j["x"].shape[1], jnp.float32)
    zeros = jnp.zeros(j["x"].shape[1], jnp.float32)

    def f(x, w, scale, bias):
        return fn(x, w, scale, bias)

    sc = j["scale"] if prologue else ones
    bi = j["bias"] if prologue else zeros
    out, vjp = jax.vjp(f, j["x"], j["w"], sc, bi)
    return out, vjp((j["dy"], j["ds1"], j["ds2"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_forward_and_vjp_match_jax(dtype, m, k, n, prologue):
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, dtype), _to_torch(a, dtype)
    tol = TOL[dtype]
    pallas = _jax_vjp(lambda x, w, s, b: jfb._fmm(x, w, s, b, prologue), j,
                      prologue)
    xla = _jax_vjp(lambda x, w, s, b: jfb.xla_matmul_bn(
        x, w, s if prologue else None, b if prologue else None), j, prologue)

    leaves = {k_: t[k_].clone().requires_grad_(True)
              for k_ in ("x", "w", "scale", "bias")}
    sc = leaves["scale"] if prologue else None
    bi = leaves["bias"] if prologue else None
    y, s1, s2 = fb.fused_matmul_bn(leaves["x"], leaves["w"], sc, bi)
    assert y.dtype == TORCH[dtype] and s1.dtype == s2.dtype == torch.float32
    torch.autograd.backward([y, s1, s2], [t["dy"], t["ds1"], t["ds2"]])
    got_out = (y, s1, s2)
    got_grads = [leaves["x"].grad, leaves["w"].grad]
    if prologue:
        got_grads += [leaves["scale"].grad, leaves["bias"].grad]
    else:
        assert leaves["scale"].grad is None and leaves["bias"].grad is None

    # the plain VJP called directly, on the forward's y
    plain = [g for g in fb.matmul_bn_bwd_reference(
        t["x"], t["w"], t["scale"] if prologue else None,
        t["bias"] if prologue else None, y.detach(), t["dy"], t["ds1"],
        t["ds2"]) if g is not None]
    for ref_name, (out, grads) in (("_fmm", pallas), ("xla", xla)):
        for name, g, r in zip(("y", "s1", "s2"), got_out, out):
            _close(g, r.astype(jnp.float32), tol, f"{ref_name} {name}")
        for name, g, p, r in zip(("dx", "dw", "dscale", "dbias"), got_grads,
                                 plain, grads):
            _close(g, r.astype(jnp.float32), tol, f"{ref_name} {name}")
            _close(p, r.astype(jnp.float32), tol, f"plain vs {ref_name} {name}")


def test_bn_consts_chain_matches_jax():
    """fmm → bn_consts → prologue fmm → loss, through the stats
    cotangents, as in ``test_bn_consts_chain_grad`` of the JAX tests."""
    m, k, n1, n2 = 128, 64, 96, 80
    rng = np.random.RandomState(3)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    w1 = (rng.randn(k, n1) * k ** -0.5).astype(np.float32)
    w2 = (rng.randn(n1, n2) * n1 ** -0.5).astype(np.float32)
    gamma = (rng.rand(n1) + 0.5).astype(np.float32)
    beta = rng.randn(n1).astype(np.float32)

    def jax_chain(x, w1, w2, gamma, beta):
        y1, s1, s2 = jfb._fmm(x, w1, jnp.ones((k,), jnp.float32),
                              jnp.zeros((k,), jnp.float32), False)
        sc, bi, _, _ = jfb.bn_consts(s1, s2, m, gamma, beta)
        y2, t1, t2 = jfb._fmm(y1, w2, sc, bi, True)
        return jnp.sum(jnp.square(y2)) + jnp.sum(t1) + jnp.sum(t2)

    want_v, want_g = jax.value_and_grad(jax_chain, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, w1, w2, gamma, beta)))

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w1, w2, gamma, beta)]
    tx, tw1, tw2, tg, tb = leaves
    y1, s1, s2 = fb.fused_matmul_bn(tx, tw1)
    sc, bi, _, _ = fb.bn_consts(s1, s2, m, tg, tb)
    y2, t1, t2 = fb.fused_matmul_bn(y1, tw2, sc, bi)
    v = (y2 * y2).sum() + t1.sum() + t2.sum()
    v.backward()
    assert abs(v.item() - float(want_v)) <= 1e-5 * abs(float(want_v))
    for name, leaf, want in zip(("x", "w1", "w2", "gamma", "beta"), leaves,
                                want_g):
        _close(leaf.grad, want, 1e-4, name)


@pytest.mark.parametrize("prologue", [False, True])
def test_function_gradcheck_float64(prologue):
    rng = np.random.RandomState(7)
    m, k, n = 13, 6, 5
    args = [torch.from_numpy(rng.randn(m, k)), torch.from_numpy(rng.randn(k, n))]
    if prologue:
        args += [torch.from_numpy(rng.rand(k) + 0.5),
                 torch.from_numpy(rng.randn(k) * 0.2)]
    else:
        args += [None, None]
    args = [a.requires_grad_(True) if a is not None else None for a in args]
    assert torch.autograd.gradcheck(fb.FusedMatmulBNFunction.apply,
                                    tuple(args), eps=1e-6, atol=1e-7)


def test_none_stat_cotangents_read_as_zeros():
    a = _inputs(64, 16, 24, seed=5)
    t = _to_torch(a, "float32")

    def grads(use_stats):
        x = t["x"].clone().requires_grad_(True)
        w = t["w"].clone().requires_grad_(True)
        sc = t["scale"].clone().requires_grad_(True)
        y, s1, s2 = fb.fused_matmul_bn(x, w, sc, t["bias"])
        if use_stats:
            torch.autograd.backward([y, s1, s2], [t["dy"], torch.zeros(24),
                                                  torch.zeros(24)])
        else:
            y.backward(t["dy"])
        return x.grad, w.grad, sc.grad

    for got, want in zip(grads(False), grads(True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_take_only_cpu_or_cuda_tensors():
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        fb.fused_matmul_bn_fwd(meta, torch.empty(3, 2, device="meta"))


# kernel 12's bfloat16 tile: 32 rows of M a stage, 16 a tensor-core step
_STAGE, _MMA_DEPTH = 32, 16


def _kernel_dw(x, scale, bias, y, dy, ds1, ds2, split_rows):
    """dw by the arithmetic of kernel 12's bfloat16 tile: the prologue
    and dyt in float32, rounded to bf16; exact products of the bf16
    values; each 16-row m16n8k16 step's sum added to the run's float32
    accumulator, stage after stage; each run of ``split_rows`` rows a
    float32 partial, and the partials summed in order in float32, then
    rounded to bf16.  Rows past M are absent, as the kernel's zeroed
    rows add nothing."""
    a = fc.prologue(x, scale, bias).double()
    b = fc.dyt(y, dy, ds1, ds2).double()
    m = x.shape[0]
    total = None
    for r0 in range(0, m, split_rows):
        acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
        for s0 in range(r0, min(m, r0 + split_rows), _MMA_DEPTH):
            rows = slice(s0, min(m, s0 + _MMA_DEPTH))
            acc = (acc.double() + a[rows].t() @ b[rows]).float()
        total = acc if total is None else total + acc
    return total.to(torch.bfloat16)


@pytest.mark.parametrize("split", ["rule", 64])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_dw_arithmetic_matches_jax(m, k, n, prologue, split):
    """The bfloat16 dw kernel's order of sums and roundings, on the JAX
    forward's own y, within TOL of the JAX VJP's dw (Pallas, interpret
    mode).  Measured at these inputs: 0 to 3.3e-3 of max|dw| (one bf16 ulp
    where an f32 sum in another order rounds to the other neighbour)."""
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, "bfloat16"), _to_torch(a, "bfloat16")
    (y, _, _), (_, dw, _, _) = _jax_vjp(
        lambda x, w, s, b: jfb._fmm(x, w, s, b, prologue), j, prologue)
    y = torch.from_numpy(np.array(y.astype(jnp.float32))).bfloat16()
    split_rows = (fb.dw_mma_split(m, k, n, sms=132)[0] if split == "rule"
                  else split)
    got = _kernel_dw(t["x"], t["scale"] if prologue else None,
                     t["bias"] if prologue else None, y, t["dy"], t["ds1"],
                     t["ds2"], split_rows)
    _close(got, dw.astype(jnp.float32), TOL["bfloat16"], "dw")


@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (31, 64, 256), (33, 2048, 2048), (200, 96, 72),
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
    (100352, 128, 512), (25088, 512, 1024), (6272, 2048, 512),
    (3 * 10 ** 7, 64, 64)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dw_mma_split_tiles_m_in_whole_stages(m, k, n, sms):
    rows, splits = fb.dw_mma_split(m, k, n, sms)
    assert rows > 0 and rows % _STAGE == 0
    assert (splits - 1) * rows < m <= splits * rows
    assert 1 <= splits <= 65535


# kernel 11's bfloat16 tile: 128 rows of M a block, 16 columns of dy a
# tensor-core step
_DX_ROWS = 128


def _kernel_fmm_dx(x, w, scale, bias, y, dy, ds1, ds2):
    """``(dx, dscale, dbias)`` by the arithmetic of kernel 11's bfloat16
    tile: dyt = dy + ds1 + 2*y*ds2 in float32, rounded to bf16; exact
    products of the bf16 values, each 16-column m16n8k16 step's sum
    added to the float32 dxn in order along N; with the prologue z =
    x*scale + bias in float32 (one rounding each), dz = dxn where z > 0,
    dx = dz*scale rounded to bf16, and dscale, dbias as float32 sums of
    dz*x and dz over each block of 128 rows, the blocks' partials then
    added in order; without it dx = dxn rounded to bf16."""
    d = fc.dyt(y, dy, ds1, ds2).double()
    wt = w.double()
    m, n = d.shape
    dxn = torch.zeros(m, w.shape[0], dtype=torch.float32)
    for s0 in range(0, n, 16):
        cols = slice(s0, min(n, s0 + 16))
        dxn = (dxn.double() + d[:, cols] @ wt[:, cols].t()).float()
    if scale is None:
        return dxn.to(torch.bfloat16), None, None
    xf = x.float()
    dz = torch.where(xf * scale + bias > 0, dxn, torch.zeros_like(dxn))
    dsc = torch.zeros(w.shape[0], dtype=torch.float32)
    dbi = torch.zeros(w.shape[0], dtype=torch.float32)
    for r0 in range(0, m, _DX_ROWS):
        rows = slice(r0, min(m, r0 + _DX_ROWS))
        dsc = dsc + (dz[rows] * xf[rows]).sum(dim=0)
        dbi = dbi + dz[rows].sum(dim=0)
    return (dz * scale).to(torch.bfloat16), dsc, dbi


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_dx_arithmetic_matches_jax(m, k, n, prologue):
    """The bfloat16 dx kernel's order of sums and roundings, on the JAX
    forward's own y, within TOL["bfloat16"] (2e-2 of the largest |JAX|
    value) of the JAX VJP's dx, dscale and dbias (Pallas, interpret
    mode).  Both round dxn's float32 sums, taken in another order, so dx
    may land one bf16 ulp (2^-8 of a value) away, and a z at 0 may flip
    one dz: on these inputs 0 to 8.7e-4 of max|dx|, up to 1.6e-7 for
    dscale and dbias."""
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, "bfloat16"), _to_torch(a, "bfloat16")
    (y, _, _), (dx, _, dsc, dbi) = _jax_vjp(
        lambda x, w, s, b: jfb._fmm(x, w, s, b, prologue), j, prologue)
    y = torch.from_numpy(np.array(y.astype(jnp.float32))).bfloat16()
    got = _kernel_fmm_dx(t["x"], t["w"], t["scale"] if prologue else None,
                         t["bias"] if prologue else None, y, t["dy"],
                         t["ds1"], t["ds2"])
    _close(got[0], dx.astype(jnp.float32), TOL["bfloat16"], "dx")
    if prologue:
        _close(got[1], dsc, TOL["bfloat16"], "dscale")
        _close(got[2], dbi, TOL["bfloat16"], "dbias")
    else:
        assert got[1] is None and got[2] is None


# kernel 10's bfloat16 tile: 128 rows of M a row block, 16 of K a
# tensor-core step
_FWD_ROWS = 128


def _kernel_fmm_fwd(x, w, scale, bias, run_rows):
    """``(y, s1, s2)`` by the arithmetic of kernel 10's bfloat16 tile:
    the prologue relu(x*scale + bias) in float32, rounded to bf16; exact
    products of the bf16 values, each 16-deep m16n8k16 step's sum added
    to the float32 y in order along K; y rounded to bf16; s1 and s2 the
    float32 sums of the rounded y and y^2 over each run of ``run_rows``
    rows, the runs' partials then added in order.  Rows past M are
    absent, as the kernel zeroes them after the prologue and stores none
    of them."""
    a = fc.prologue(x, scale, bias).double()
    wt = w.double()
    m, k = a.shape
    acc = torch.zeros(m, w.shape[1], dtype=torch.float32)
    for k0 in range(0, k, 16):
        ks = slice(k0, min(k, k0 + 16))
        acc = (acc.double() + a[:, ks] @ wt[ks]).float()
    y = acc.to(torch.bfloat16)
    yf = y.float()
    s1 = torch.zeros(w.shape[1], dtype=torch.float32)
    s2 = torch.zeros(w.shape[1], dtype=torch.float32)
    for r0 in range(0, m, run_rows):
        rows = yf[r0:r0 + run_rows]
        s1 = s1 + rows.sum(dim=0)
        s2 = s2 + (rows * rows).sum(dim=0)
    return y, s1, s2


@pytest.mark.parametrize("m,k,n", SHAPES + [(300, 60, 100)])
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_fwd_arithmetic_matches_jax(m, k, n, prologue):
    """The bfloat16 forward kernel's order of sums and roundings (the
    split rule's runs, and runs of one row block, so that the partials'
    sum is exercised) within TOL["bfloat16"] (2e-2 of the largest |JAX|
    value) of the JAX package's Pallas forward ``_fwd_impl`` in
    interpret mode: y, s1 and s2.  Both round y's float32 sums, taken in
    another order, to bf16, so a value may land one bf16 ulp (2^-8 of
    it) away."""
    a = _inputs(m, k, n, seed=m + k + n + 1)
    j, t = _to_jax(a, "bfloat16"), _to_torch(a, "bfloat16")
    sc = j["scale"] if prologue else jnp.ones((k,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((k,), jnp.float32)
    want = jfb._fwd_impl(j["x"], j["w"], sc, bi, prologue)
    for run_rows in (fb.fwd_mma_split(m, k, n, 132, torch.bfloat16)[0],
                     _FWD_ROWS):
        got = _kernel_fmm_fwd(t["x"], t["w"], t["scale"] if prologue else None,
                              t["bias"] if prologue else None, run_rows)
        for name, g, r in zip(("y", "s1", "s2"), got, want):
            _close(g, r.astype(jnp.float32), TOL["bfloat16"],
                   f"fwd {name} run_rows={run_rows}")


@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (31, 64, 256), (33, 2048, 2048), (200, 96, 72),
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
    (100352, 128, 512), (25088, 512, 1024), (6272, 2048, 512),
    (6272, 1024, 2048), (3 * 10 ** 7, 64, 64), (2 ** 31 - 1, 8, 8)])
@pytest.mark.parametrize("sms", [1, 132])
def test_fwd_mma_split_tiles_m_in_whole_stages(m, k, n, sms):
    """Runs of whole 128-row blocks tile M exactly within the grid's
    limit, and no other run length leaves the slowest SM less work (runs
    x column tiles blocks, _FWD_BLOCKS_PER_SM of them an SM at a time)
    among the lengths searched."""
    rows, runs = fb.fwd_mma_split(m, k, n, sms, torch.bfloat16)
    assert rows > 0 and rows % _FWD_ROWS == 0
    assert (runs - 1) * rows < m <= runs * rows
    assert 1 <= runs <= 65535
    blocks, tiles = -(-m // _FWD_ROWS), -(-n // (64 if n <= 64 else 128))
    slots = fb._FWD_BLOCKS_PER_SM * sms

    def cost(r):
        return -(-(-(-blocks // r) * tiles) // slots) * r

    least = -(-blocks // 65535)
    for r in range(least, max(least, min(blocks, fb._FWD_MAX_RUN)) + 1):
        assert cost(rows // _FWD_ROWS) <= cost(r)


# ---------------------------------------------------------------------------
# kernel 12's float32 tile (fused_matmul_bn_dw_tf32), by its arithmetic
# ---------------------------------------------------------------------------

# kernel 12's float32 tile: 16 rows of M a stage, 8 a tensor-core step
_TF32_STAGE, _TF32_DEPTH = 16, 8


def _tf32_rna(v):
    """float32 values rounded to tf32 as ``cvt.rna.tf32.f32`` rounds them
    (10 bits of mantissa, to nearest, ties away from zero), as float32:
    the bits of the magnitude plus half a tf32 ulp, the low 13 bits
    cleared.  A value that rounds past the largest float becomes inf; a
    NaN stays NaN."""
    v = np.ascontiguousarray(v, np.float32)
    bits = v.view(np.uint32)
    r = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isnan(v), v, r.view(np.float32))


def _split_tf32(v):
    """``(hi, lo)``: v = hi + lo up to 2^-22 |v|, both tf32, as
    ``split_tf32`` in ``csrc/mma.cuh`` takes them (v - hi is exact in
    float32)."""
    v = np.ascontiguousarray(v, np.float32)
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _products_3xtf32(a, b):
    """The three tf32 products of an (r, i) and an (r, j) operand over
    their depth r, in the kernels' order (lo·hi, hi·lo, hi·hi), each
    summed exactly (float64), as float64 (i, j) arrays."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return [p.T.astype(np.float64) @ q.astype(np.float64)
            for p, q in ((al, bh), (ah, bl), (ah, bh))]


def _add_f32(acc, p):
    """acc + p rounded once to float32 (acc float32, p float64)."""
    return (acc.astype(np.float64) + p).astype(np.float32)


def _kernel_dw_tf32(x, scale, bias, y, dy, ds1, ds2, split_rows):
    """dw by the arithmetic of kernel 12's float32 tile: the prologue and
    dyt in float32, unrounded to any narrower type; each 8-row m16n8k8
    step's three tf32 products (``_products_3xtf32``) added in order to
    the stage's float32 part, which starts at 0 each 16-row stage, one
    rounding each; each part added to the run's float32 sum; each run of
    ``split_rows`` rows a float32 partial, and the partials summed in
    order in float32.  Rows past M are absent, as the kernel's zeroed
    rows add nothing."""
    a = fc.prologue(x, scale, bias).numpy()
    b = fc.dyt(y, dy, ds1, ds2).numpy()
    m = a.shape[0]
    total = None
    for r0 in range(0, m, split_rows):
        acc = np.zeros((a.shape[1], b.shape[1]), np.float32)
        for s0 in range(r0, min(m, r0 + split_rows), _TF32_STAGE):
            part = np.zeros_like(acc)
            for k0 in range(s0, min(m, s0 + _TF32_STAGE), _TF32_DEPTH):
                rows = slice(k0, min(m, k0 + _TF32_DEPTH))
                for p in _products_3xtf32(a[rows], b[rows]):
                    part = _add_f32(part, p)
            acc = acc + part
        total = acc if total is None else total + acc
    return total


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    f32 = np.finfo(np.float32)
    u = 2.0 ** -10                    # a tf32 ulp at 1
    cases = [(1 + u / 2, 1 + u),      # a tie goes away from zero (not to 1,
             (-(1 + u / 2), -(1 + u)),  # which is even)
             (1 + 3 * u / 2, 1 + 2 * u),
             (np.nextafter(np.float32(1 + u / 2), np.float32(0)), 1.0),
             (np.nextafter(np.float32(1 + u / 2), np.float32(2)), 1 + u),
             (1 + u, 1 + u),           # already tf32
             (f32.max, np.inf),        # the largest float rounds past it
             (-f32.max, -np.inf),
             (np.inf, np.inf), (-np.inf, -np.inf), (0.0, 0.0),
             (2.0 ** -149, 0.0),       # the least subnormal
             (2.0 ** -137, 2.0 ** -136),  # a subnormal tie
             (-3.0 * 2.0 ** -136, -3.0 * 2.0 ** -136),  # a tf32 subnormal
             (-3.0 * 2.0 ** -140, -0.0)]
    got = _tf32_rna(np.array([v for v, _ in cases], np.float32))
    want = np.array([w for _, w in cases], np.float32)
    assert np.array_equal(got, want), list(zip(got, want))
    assert np.signbit(_tf32_rna(np.float32(-0.0)))
    assert np.isnan(_tf32_rna(np.array([np.nan], np.float32))).all()
    assert (_tf32_rna(np.random.RandomState(0).randn(1000).astype(
        np.float32)).view(np.uint32) & 0x1FFF == 0).all()


def test_split_tf32_keeps_float32_to_2_pow_minus_22():
    rng = np.random.RandomState(1)
    v = (rng.randn(4096) * np.exp2(rng.randint(-60, 60, 4096))).astype(
        np.float32)
    hi, lo = _split_tf32(v)
    for part in (hi, lo):
        assert (part.view(np.uint32) & 0x1FFF == 0).all()
    err = np.abs(v.astype(np.float64) - hi - lo)
    assert (err <= 2.0 ** -22 * np.abs(v)).all(), err.max()
    assert np.array_equal(_split_tf32(hi)[0], hi)
    assert not _split_tf32(hi)[1].any()


@pytest.mark.parametrize("split", ["rule", _TF32_STAGE])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_dw_tf32_arithmetic_matches_jax(m, k, n, prologue, split):
    """The float32 dw kernel's order of products, sums and roundings, on
    the JAX forward's own y, within TOL["float32"] of the JAX VJP's dw
    (Pallas, interpret mode), with the runs the split rule chooses and
    with one 16-row stage a run.  Measured at these inputs: 1.7e-7 to
    5.8e-7 of max|dw| (float32 sums in another order)."""
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, "float32"), _to_torch(a, "float32")
    (y, _, _), (_, dw, _, _) = _jax_vjp(
        lambda x, w, s, b: jfb._fmm(x, w, s, b, prologue), j, prologue)
    y = torch.from_numpy(np.array(y))
    split_rows = (fb.dw_tf32_split(m, k, n, sms=132)[0] if split == "rule"
                  else split)
    assert split_rows % _TF32_STAGE == 0
    got = _kernel_dw_tf32(t["x"], t["scale"] if prologue else None,
                          t["bias"] if prologue else None, y, t["dy"],
                          t["ds1"], t["ds2"], split_rows)
    _close(got, dw, TOL["float32"], "dw")


@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (31, 64, 256), (33, 2048, 2048), (200, 96, 72),
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
    (100352, 128, 512), (25088, 512, 1024), (6272, 2048, 512),
    (3 * 10 ** 7, 64, 64)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dw_tf32_split_tiles_m_in_whole_stages(m, k, n, sms):
    rows, splits = fb.dw_tf32_split(m, k, n, sms)
    assert rows > 0 and rows % _TF32_STAGE == 0 and rows % 32 == 0
    assert (splits - 1) * rows < m <= splits * rows
    assert 1 <= splits <= 65535
    # no run so short that its float32 partial (written and read back)
    # outweighs a quarter of what the run reads, unless M is shorter
    assert 8 * k * n <= rows * (k + 2 * n) or splits == 1
    # at least as many runs as the bfloat16 tile's rule takes
    assert splits >= fb.dw_mma_split(m, k, n, sms)[1]


def test_one_tf32_pass_misses_the_float32_tolerance():
    """What the split is for: the hi·hi product alone (one TF32 pass, as
    cuBLAS's TF32 mode takes it) misses the JAX VJP's dw by far more than
    TOL["float32"] (measured: 1.6e-4 of max|dw| here, 1.1e-4 to 3.5e-4
    over the file's shapes), where the three products land within it."""
    m, k, n = SHAPES[0]
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, "float32"), _to_torch(a, "float32")
    (y, _, _), (_, dw, _, _) = _jax_vjp(
        lambda x, w, s, b: jfb._fmm(x, w, s, b, True), j, True)
    y = torch.from_numpy(np.array(y))
    xn = fc.prologue(t["x"], t["scale"], t["bias"]).numpy()
    d = fc.dyt(y, t["dy"], t["ds1"], t["ds2"]).numpy()
    one = _tf32_rna(xn).T.astype(np.float64) @ _tf32_rna(d).astype(np.float64)
    with pytest.raises(AssertionError, match="max"):
        _close(one, dw, TOL["float32"], "dw, one tf32 pass")
    three = sum(_products_3xtf32(xn, d))
    _close(three, dw, TOL["float32"], "dw, three tf32 products")


# ---------------------------------------------------------------------------
# kernel 11's float32 tile (fused_matmul_bn_dx_tf32), by its arithmetic
# ---------------------------------------------------------------------------

# kernel 11's float32 tile: 16 columns of dy a stage, 8 a tensor-core step
_TF32_DX_STAGE = 16


def _kernel_fmm_dx_tf32(x, w, scale, bias, y, dy, ds1, ds2):
    """``(dx, dscale, dbias)`` by the arithmetic of kernel 11's float32
    tile: dyt = dy + ds1 + 2*y*ds2 in float32; along N in 16-column
    stages, each 8-column m16n8k8 step's three tf32 products of dyt and
    w (``_products_3xtf32``) added in order to the stage's float32 part,
    which starts at 0 each stage, one rounding each; each part added to
    the float32 dxn; with the prologue z = x*scale + bias in float32 (one
    rounding each), dz = dxn where z > 0, dx = dz*scale, and dscale,
    dbias the float32 sums of dz*x and dz over each block of 128 rows,
    the blocks' partials then added in order; without it dx = dxn.  Rows
    past M are absent, as the kernel's zeroed rows add nothing."""
    d = fc.dyt(y, dy, ds1, ds2).numpy()
    wn = w.numpy()
    m, n = d.shape
    dxn = np.zeros((m, wn.shape[0]), np.float32)
    for s0 in range(0, n, _TF32_DX_STAGE):
        part = np.zeros_like(dxn)
        for k0 in range(s0, min(n, s0 + _TF32_DX_STAGE), _TF32_DEPTH):
            cols = slice(k0, min(n, k0 + _TF32_DEPTH))
            for p in _products_3xtf32(d[:, cols].T, wn[:, cols].T):
                part = _add_f32(part, p)
        dxn = dxn + part
    if scale is None:
        return dxn, None, None
    xf, sc, bi = x.numpy(), scale.numpy(), bias.numpy()
    dz = np.where(xf * sc + bi > 0, dxn, 0).astype(np.float32)
    dsc = np.zeros(wn.shape[0], np.float32)
    dbi = np.zeros(wn.shape[0], np.float32)
    for r0 in range(0, m, _DX_ROWS):
        rows = slice(r0, min(m, r0 + _DX_ROWS))
        dsc = dsc + (dz[rows] * xf[rows]).sum(axis=0, dtype=np.float32)
        dbi = dbi + dz[rows].sum(axis=0, dtype=np.float32)
    return dz * sc, dsc, dbi


@pytest.mark.parametrize("m,k,n", SHAPES + [(300, 60, 100)])
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_dx_tf32_arithmetic_matches_jax(m, k, n, prologue):
    """The float32 dx kernel's order of products, sums and roundings, on
    the JAX forward's own y, within TOL["float32"] of the JAX VJP's dx,
    dscale and dbias (Pallas, interpret mode): column tiles past K = 64,
    ragged M (200, 300), N not a multiple of the 16-column stage (72,
    100) and K not a multiple of 4 (60).  Measured at these inputs: 1.4e-7
    to 6.3e-7 of the largest |JAX| value (float32 sums in another
    order)."""
    a = _inputs(m, k, n, seed=m + k + n)
    j, t = _to_jax(a, "float32"), _to_torch(a, "float32")
    (y, _, _), (dx, _, dsc, dbi) = _jax_vjp(
        lambda x, w, s, b: jfb._fmm(x, w, s, b, prologue), j, prologue)
    y = torch.from_numpy(np.array(y))
    got = _kernel_fmm_dx_tf32(t["x"], t["w"], t["scale"] if prologue else None,
                              t["bias"] if prologue else None, y, t["dy"],
                              t["ds1"], t["ds2"])
    _close(got[0], dx, TOL["float32"], "dx")
    if prologue:
        _close(got[1], dsc, TOL["float32"], "dscale")
        _close(got[2], dbi, TOL["float32"], "dbias")
    else:
        assert got[1] is None and got[2] is None


# ---------------------------------------------------------------------------
# kernel 10's float32 tile (fused_matmul_bn_fwd_tf32), by its arithmetic
# ---------------------------------------------------------------------------

# kernel 10's float32 tile: 16 columns of x a stage
_TF32_FWD_STAGE = 16


def _kernel_fmm_fwd_tf32(x, w, scale, bias, run_rows):
    """``(y, s1, s2)`` by the arithmetic of kernel 10's float32 tile: xn
    = relu(x*scale + bias) in float32 (or x), unrounded to any narrower
    type; along K in 16-column stages, each 8-column m16n8k8 step's three
    tf32 products of xn and w (``_products_3xtf32``) added in order to the
    stage's float32 part, which starts at 0 each stage, one rounding each;
    each part added to the float32 y; s1 and s2 the float32 sums of y and
    y^2 over each run of ``run_rows`` rows, the runs' partials then added
    in order.  Rows past M are absent, as the kernel zeroes them and
    stores none of them."""
    a = fc.prologue(x, scale, bias).numpy()
    wn = w.numpy()
    m, k = a.shape
    y = np.zeros((m, wn.shape[1]), np.float32)
    for s0 in range(0, k, _TF32_FWD_STAGE):
        part = np.zeros_like(y)
        for k0 in range(s0, min(k, s0 + _TF32_FWD_STAGE), _TF32_DEPTH):
            cols = slice(k0, min(k, k0 + _TF32_DEPTH))
            for p in _products_3xtf32(a[:, cols].T, wn[cols]):
                part = _add_f32(part, p)
        y = y + part
    s1 = np.zeros(wn.shape[1], np.float32)
    s2 = np.zeros(wn.shape[1], np.float32)
    for r0 in range(0, m, run_rows):
        rows = y[r0:r0 + run_rows]
        s1 = s1 + rows.sum(axis=0, dtype=np.float32)
        s2 = s2 + (rows * rows).sum(axis=0, dtype=np.float32)
    return y, s1, s2


@pytest.mark.parametrize("m,k,n", SHAPES + [(300, 60, 100)])
@pytest.mark.parametrize("prologue", [False, True])
def test_kernel_fwd_tf32_arithmetic_matches_jax(m, k, n, prologue):
    """The float32 forward kernel's order of products, sums and roundings
    (the split rule's runs, and runs of one row block, so that the
    partials' sum is exercised) within TOL["float32"] (1e-5 of the largest
    |JAX| value) of the JAX package's Pallas forward ``_fwd_impl`` in
    interpret mode, float32: y, s1 and s2, at column tiles past N = 64
    (128, 72, 256, 100: the last ragged at 72 and 100), ragged M (200,
    300), K not a multiple of the 16-column stage (72, 60) and K not a
    multiple of 8 (60).  Measured at these inputs: 7.6e-8 to 5.9e-7 of
    the largest |JAX| value (float32 sums in another order)."""
    a = _inputs(m, k, n, seed=m + k + n + 1)
    j, t = _to_jax(a, "float32"), _to_torch(a, "float32")
    sc = j["scale"] if prologue else jnp.ones((k,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((k,), jnp.float32)
    want = jfb._fwd_impl(j["x"], j["w"], sc, bi, prologue)
    for run_rows in (fb.fwd_mma_split(m, k, n, 132, torch.float32)[0],
                     _FWD_ROWS):
        got = _kernel_fmm_fwd_tf32(t["x"], t["w"],
                                   t["scale"] if prologue else None,
                                   t["bias"] if prologue else None, run_rows)
        for name, g, r in zip(("y", "s1", "s2"), got, want):
            _close(g, np.asarray(r), TOL["float32"],
                   f"fwd_tf32 {name} run_rows={run_rows}")


@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (31, 64, 256), (33, 2048, 2048), (200, 96, 72),
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
    (100352, 128, 512), (25088, 512, 1024), (6272, 2048, 512),
    (6272, 1024, 2048), (3 * 10 ** 7, 64, 64), (2 ** 31 - 1, 8, 8)])
@pytest.mark.parametrize("sms", [1, 132])
def test_fwd_mma_split_float32_tiles_m_in_whole_stages(m, k, n, sms):
    """The float32 tile takes 64 columns of y a block at every N, and its
    runs of whole 128-row blocks tile M exactly within the grid's limit;
    no other run length leaves the slowest SM less work (runs x column
    tiles of 64 blocks, _FWD_BLOCKS_PER_SM of them an SM at a time) among
    the lengths searched."""
    assert fb.fwd_mma_tile(n, torch.float32) == 64
    rows, runs = fb.fwd_mma_split(m, k, n, sms, torch.float32)
    assert rows > 0 and rows % _FWD_ROWS == 0
    assert (runs - 1) * rows < m <= runs * rows
    assert 1 <= runs <= 65535
    blocks, tiles = -(-m // _FWD_ROWS), -(-n // 64)
    slots = fb._FWD_BLOCKS_PER_SM * sms

    def cost(r):
        return -(-(-(-blocks // r) * tiles) // slots) * r

    least = -(-blocks // 65535)
    for r in range(least, max(least, min(blocks, fb._FWD_MAX_RUN)) + 1):
        assert cost(rows // _FWD_ROWS) <= cost(r)
