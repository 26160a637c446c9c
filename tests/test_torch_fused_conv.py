"""The port's fused 3x3-conv + BatchNorm against the JAX package's, on the
CPU (``incubator_mxnet_tpu_torch/ops/fused_conv.py`` against
``incubator_mxnet_tpu/ops/fused_conv.py``).

On the CPU the port's wrappers run their plain versions, and
``FusedConv3BNFunction`` joins them; on the JAX side ``_fc3`` runs the
Pallas kernels 13-16 in interpret mode (``MXNET_USE_PALLAS=1``) and
``xla_conv3_bn`` is the XLA composition.  Inputs are made with numpy
from a seed and handed to both.

* forward ``(y, s1, s2)`` and the VJP ``(dx, dw, dscale, dbias)`` for
  nonzero cotangents of all three outputs, against the Pallas kernels on
  a ragged non-square shape and in the multi-N-block geometry (C_out
  260 in three N blocks, forced by shrinking ``_VMEM_BUDGET`` as the
  JAX package's own test does: kernel 15), and against the XLA
  composition at the JAX test's four shapes, each with and without the
  prologue, in float32 and bfloat16 (the slow interpret-mode kernels
  take each dtype once, with the prologue on one side only);
* the ds1/ds2 cotangent chain through ``bn_consts``, as the JAX
  package's ``test_chain_grad_through_bn_consts``;
* ``torch.autograd.gradcheck`` of the Function in float64;
* stat cotangents that are None read as zeros, and the zero padding is
  of the normalized input.

Tolerances, each max |port - JAX| against the largest |JAX| value of the
tensor: float32 1e-5 (the same formulas, sums in another order);
bfloat16 2e-2 (one bf16 ulp, 2^-7 of a value, where an f32 sum in
another order rounds to the other neighbour).  The sums s1, s2, dscale,
dbias and dw are held to the same share of their largest value.  The
chain: loss 1e-5 relative, gradients 1e-4 of the largest.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu.ops.fused_conv as jfc
from incubator_mxnet_tpu.ops import fused_block as jfb
from incubator_mxnet_tpu_torch.ops import fused_block as fb
from incubator_mxnet_tpu_torch.ops import fused_conv as fc

SHAPES = [(2, 8, 8, 16, 24),    # whole-image blocks
          (3, 6, 6, 16, 16),    # images smaller than a TPU block
          (2, 14, 14, 32, 16),  # ResNet's 14-pixel stage
          (2, 5, 9, 16, 8)]     # non-square, ragged
RAGGED = (2, 5, 9, 16, 8)
MULTI_NBLOCK = (16, 6, 6, 16, 260)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", "1")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU convolutions run faster on one thread than on many that
    other processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, h, w, c, co, seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=(rng.randn(n, h, w, c) * 0.5).astype(np.float32),
                w=(rng.randn(3, 3, c, co) * (9 * c) ** -0.5).astype(
                    np.float32),
                scale=(rng.rand(c) + 0.5).astype(np.float32),
                bias=(rng.randn(c) * 0.2).astype(np.float32),
                dy=(rng.randn(n, h, w, co) * 0.1).astype(np.float32),
                ds1=(rng.randn(co) * 0.01).astype(np.float32),
                ds2=(rng.randn(co) * 0.001).astype(np.float32))


def _to_jax(a, dtype):
    return {k: jnp.asarray(v, JNP[dtype] if k in ("x", "w", "dy")
                           else jnp.float32) for k, v in a.items()}


def _to_torch(a, dtype):
    return {k: torch.from_numpy(v).to(TORCH[dtype] if k in ("x", "w", "dy")
                                      else torch.float32)
            for k, v in a.items()}


def _close(got, want, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (
        f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}")


def _jax_vjp(fn, j, prologue):
    """``fn(x, w, scale, bias)`` and its VJP for ``(dy, ds1, ds2)``;
    without the prologue scale and bias are ones and zeros, as the JAX
    package's ``fused_conv3_bn`` passes them."""
    c = j["x"].shape[-1]
    sc = j["scale"] if prologue else jnp.ones((c,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((c,), jnp.float32)
    out, vjp = jax.vjp(fn, j["x"], j["w"], sc, bi)
    return out, vjp((j["dy"], j["ds1"], j["ds2"]))


def _port(t, prologue):
    """The port's forward and every gradient through the Function, and
    the plain VJP called directly on the forward's y."""
    leaves = {k: t[k].clone().requires_grad_(True)
              for k in ("x", "w", "scale", "bias")}
    sc = leaves["scale"] if prologue else None
    bi = leaves["bias"] if prologue else None
    y, s1, s2 = fc.fused_conv3_bn(leaves["x"], leaves["w"], sc, bi)
    assert y.dtype == t["x"].dtype and s1.dtype == s2.dtype == torch.float32
    torch.autograd.backward([y, s1, s2], [t["dy"], t["ds1"], t["ds2"]])
    grads = [leaves["x"].grad, leaves["w"].grad]
    if prologue:
        grads += [leaves["scale"].grad, leaves["bias"].grad]
    else:
        assert leaves["scale"].grad is None and leaves["bias"].grad is None
    plain = fc.conv3_bn_bwd_reference(
        t["x"], t["w"], t["scale"] if prologue else None,
        t["bias"] if prologue else None, y.detach(), t["dy"], t["ds1"],
        t["ds2"])
    return (y, s1, s2), grads, plain


def _compare(shape, dtype, prologue, ref_name, ref_fn, seed):
    a = _inputs(*shape, seed=seed)
    j, t = _to_jax(a, dtype), _to_torch(a, dtype)
    tol = TOL[dtype]
    out, grads = _jax_vjp(ref_fn, j, prologue)
    got_out, got_grads, plain = _port(t, prologue)
    for name, g, r in zip(("y", "s1", "s2"), got_out, out):
        _close(g, r.astype(jnp.float32), tol, f"{ref_name} {name}")
    names = ("dx", "dw", "dscale", "dbias")
    for name, g, r in zip(names, got_grads, grads):
        _close(g, r.astype(jnp.float32), tol, f"{ref_name} {name}")
    for name, p, r in zip(names, plain, grads):
        _close(p, r.astype(jnp.float32), tol, f"plain vs {ref_name} {name}")


def _pallas(prologue):
    return lambda x, w, s, b: jfc._fc3(x, w, s, b, prologue)


def _xla(prologue):
    return lambda x, w, s, b: jfc.xla_conv3_bn(
        x, w, s if prologue else None, b if prologue else None)


# the Pallas kernels in interpret mode take seconds a case: each dtype
# once here, with the prologue on one side and off on the other (the XLA
# composition below takes every combination)
@pytest.mark.parametrize("dtype,prologue", [("float32", False),
                                            ("bfloat16", True)])
def test_forward_and_vjp_match_the_pallas_kernels(dtype, prologue):
    g = jfc._Geom(jnp.zeros(RAGGED[:4], JNP[dtype]), RAGGED[4])
    assert g.fits() and g.n_blocks == 1     # kernels 13, 14 and 16
    _compare(RAGGED, dtype, prologue, "_fc3", _pallas(prologue), seed=1)


@pytest.mark.parametrize("dtype,prologue", [("float32", True),
                                            ("bfloat16", False)])
def test_multi_nblock_geometry_matches_the_pallas_kernels(dtype, prologue,
                                                          monkeypatch):
    """C_out 260 split into three N blocks of 128 (the JAX package's
    kernel 15, ``_bwd_dx_kernel_nb``), over several M blocks, forced as
    tests/test_fused_conv.py forces it."""
    n, h, w, c, co = MULTI_NBLOCK
    x = jnp.zeros((n, h, w, c), JNP[dtype])
    monkeypatch.setattr(jfc, "_VMEM_BUDGET",
                        jfc._Geom(x, co)._bytes(128) + 1)
    g = jfc._Geom(x, co)
    assert g.bn == 128 and g.n_blocks == 3 and g.grid >= 2 and g.fits()
    _compare(MULTI_NBLOCK, dtype, prologue, "_fc3 nb", _pallas(prologue),
             seed=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_forward_and_vjp_match_the_xla_composition(dtype, shape, prologue):
    _compare(shape, dtype, prologue, "xla", _xla(prologue), seed=sum(shape))


def test_bn_consts_chain_matches_jax():
    """x's own statistics → bn_consts → prologue conv3 → loss on y and
    both stat outputs, so the ds1/ds2 cotangents reach the conv's
    backward and flow on into gamma, beta and x
    (``test_chain_grad_through_bn_consts`` of the JAX tests)."""
    n, h, w, c, co = 2, 8, 8, 16, 24
    a = _inputs(n, h, w, c, co, seed=3)
    rng = np.random.RandomState(4)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    m = n * h * w

    def jax_chain(x, k, gamma, beta):
        s1 = jnp.sum(x.reshape(-1, c), axis=0)
        s2 = jnp.sum(jnp.square(x.reshape(-1, c)), axis=0)
        sc, bi, _, _ = jfb.bn_consts(s1, s2, m, gamma, beta)
        y, t1, t2 = jfc._fc3(x, k, sc, bi, True)
        return jnp.sum(jnp.square(y)) + jnp.sum(t1) + jnp.sum(t2)

    want, jgrads = jax.value_and_grad(jax_chain, argnums=(0, 1, 2, 3))(
        jnp.asarray(a["x"]), jnp.asarray(a["w"]), jnp.asarray(gamma),
        jnp.asarray(beta))

    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (a["x"], a["w"], gamma, beta)]
    x, k, g, b = leaves
    x2 = x.reshape(-1, c)
    sc, bi, _, _ = fb.bn_consts(x2.sum(0), (x2 * x2).sum(0), m, g, b)
    y, t1, t2 = fc.fused_conv3_bn(x, k, sc, bi)
    loss = (y * y).sum() + t1.sum() + t2.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for name, leaf, r in zip(("x", "w", "gamma", "beta"), leaves, jgrads):
        _close(leaf.grad, r, 1e-4, f"chain d{name}")


@pytest.mark.parametrize("prologue", [False, True])
def test_function_passes_gradcheck_in_float64(prologue):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 4, 3)).requires_grad_(True)
    k = torch.from_numpy(rng.randn(3, 3, 3, 2) * 0.3).requires_grad_(True)
    args = [x, k]
    if prologue:
        args += [torch.from_numpy(rng.rand(3) + 0.5).requires_grad_(True),
                 torch.from_numpy(rng.randn(3) * 0.2).requires_grad_(True)]
    else:
        args += [None, None]
    assert torch.autograd.gradcheck(
        lambda *a: fc.FusedConv3BNFunction.apply(*a), tuple(args),
        eps=1e-6, atol=1e-6)


def test_none_stat_cotangents_read_as_zeros():
    a = _to_torch(_inputs(2, 5, 9, 16, 8, seed=2), "float32")
    outs = []
    for with_stats in (False, True):
        x = a["x"].clone().requires_grad_(True)
        y, s1, s2 = fc.fused_conv3_bn(x, a["w"], a["scale"], a["bias"])
        if with_stats:
            loss = (y * a["dy"]).sum() + 0.0 * (s1.sum() + s2.sum())
        else:
            loss = (y * a["dy"]).sum()
        loss.backward()
        outs.append(x.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_zero_padding_is_of_the_normalized_input():
    """With bias 1 a zero input normalizes to 1 inside the image; the
    out-of-image neighbours must read 0, so a 3x3 of ones gives 4 at the
    corners, 6 on the edges and 9 inside, in both packages."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    k = np.ones((3, 3, 1, 1), np.float32)
    one = np.ones(1, np.float32)
    want = np.array([[4, 6, 6, 4], [6, 9, 9, 6], [6, 9, 9, 6], [4, 6, 6, 4]],
                    np.float32)
    y, _, _ = fc.fused_conv3_bn(*(torch.from_numpy(v)
                                  for v in (x, k, one, one)))
    jy, _, _ = jfc._fc3(*(jnp.asarray(v) for v in (x, k, one, one)), True)
    np.testing.assert_array_equal(y[0, :, :, 0].numpy(), want)
    np.testing.assert_array_equal(np.asarray(jy)[0, :, :, 0], want)
