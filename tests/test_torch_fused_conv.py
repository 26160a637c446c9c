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
  of the normalized input;
* kernel 16's bfloat16 tensor-core tile (``fused_conv3_bn_dw_mma``, which
  runs only on the card) by its arithmetic, ``_kernel_conv3_dw``, against
  the JAX VJP's dw at the four shapes with and without the prologue, and
  its split helper, whose runs of whole stages tile every pixel once;
* kernel 13's bfloat16 tensor-core tile (``fused_conv3_bn_fwd_mma``, the
  card only) by its arithmetic, ``_kernel_conv3_fwd``, against the Pallas
  forward ``_fc3`` in interpret mode at the four shapes and two whose
  image rows take several segments (W > 62, one with C > 64, so that its
  channels run in chunks of 32), with and without the prologue, and its
  split helper, whose runs of whole stages tile every pixel once;
* kernel 14's bfloat16 tensor-core tile (``fused_conv3_bn_dx_mma``, the
  card only, which also stands for the TPU's kernel 15) by its
  arithmetic, ``_kernel_conv3_dx``, against the dx, dscale and dbias of
  the Pallas VJP ``_fc3`` in interpret mode at the forward's shapes and in
  the multi-N-block geometry (``_bwd_dx_kernel_nb``), with and without
  the prologue, and its split helper.

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


# ---------------------------------------------------------------------------
# kernel 16's bfloat16 tile, by its arithmetic
# ---------------------------------------------------------------------------

def _bf16(a):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# positions a stage of the bfloat16 tiles holds (kTcPos in the source)
_POS = 64


def _walk(n, h, w):
    """The bfloat16 tiles' walk of the pixels (``fc.dw_mma_geometry``):
    ``(stages, b, hh, px, live, own)``, each array (stages, _POS) over
    every position of every stage: its image b (clipped into range),
    row hh and column px, whether it lies in a real segment (``live``,
    the halo included) and whether it is a segment's own pixel
    (``own``)."""
    seg_w, stage_segs, row_segs = fc.dw_mma_geometry(w)
    pitch = seg_w + 2
    stages = -(-(n * h * row_segs) // stage_segs)
    st, q = np.meshgrid(np.arange(stages), np.arange(_POS), indexing="ij")
    seg = st * stage_segs + q // pitch
    place = q % pitch
    live = (q < stage_segs * pitch) & (seg < n * h * row_segs)
    img_row = seg // row_segs
    px = (seg % row_segs) * seg_w + place - 1
    own = live & (place >= 1) & (place <= seg_w) & (px < w)
    return stages, (img_row // h).clip(0, n - 1), img_row % h, px, live, own


def _kernel_conv3_dw(x, scale, bias, y, dy, ds1, ds2, sms=132,
                     run_stages=None):
    """dw (3, 3, C, C_out) float32 by ``fused_conv3_bn_dw_mma``'s
    arithmetic, on numpy arrays that hold bfloat16 values: xn =
    relu(x*scale + bias) and dyt = dy + ds1 + 2*y*ds2 in float32, rounded
    to bf16; the pixels walked in the kernel's segments and stages
    (``fc.dw_mma_geometry``), dyt 0 at a segment's halo positions and xn
    0 outside the image; per tap and 16-position step the exact product
    summed and rounded once to float32 (one ``mma``), added in float32
    stage after stage; one float32 partial per run (``fc.dw_mma_split``
    unless ``run_stages`` is given), then the runs added in order."""
    n, h, w, c = x.shape
    co = dy.shape[-1]
    xn = x if scale is None else _bf16(np.maximum(x * scale + bias, 0))
    dyt = _bf16((dy + ds1) + (2 * y) * ds2)
    stages, b, hh, px, live, inner = _walk(n, h, w)
    kp = _POS    # all-zero 16-position steps past a stage's segments add 0
    if run_stages is None:
        run_stages, runs = fc.dw_mma_split(n, h, w, c, co, sms)
    else:
        runs = -(-stages // run_stages)
    assert runs == -(-stages // run_stages) and run_stages <= stages
    d_tile = np.where(inner[..., None], dyt[b, hh, px.clip(0, w - 1)],
                      0).astype(np.float32)
    dw = np.zeros((runs, 3, 3, c, co), np.float32)
    for dh in (-1, 0, 1):
        ok = live & (hh + dh >= 0) & (hh + dh < h) & (px >= 0) & (px < w)
        x_tile = np.where(ok[..., None],
                          xn[b, (hh + dh).clip(0, h - 1), px.clip(0, w - 1)],
                          0).astype(np.float32)
        # the tile's rows: a zero guard, the positions, zeros past them
        x_tile = np.pad(x_tile, ((0, 0), (1, 2), (0, 0)))
        for tap in range(3):      # dw = tap - 1: row offset tap
            a = x_tile[:, tap:tap + kp]
            steps = np.einsum("skpc,skpo->skco",
                              a.reshape(stages, kp // 16, 16, c)
                              .astype(np.float64),
                              d_tile.reshape(stages, kp // 16, 16, co)
                              .astype(np.float64)).astype(np.float32)
            steps = steps.reshape(stages * (kp // 16), c, co)
            per_run = run_stages * (kp // 16)
            for r in range(runs):
                acc = np.zeros((c, co), np.float32)
                for s_ in steps[r * per_run:(r + 1) * per_run]:
                    acc = acc + s_
                dw[r, dh + 1, tap] = acc
    out = np.zeros((3, 3, c, co), np.float32)
    for r in range(runs):
        out = out + dw[r]
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_dw_mma_arithmetic_matches_the_jax_vjp(shape, prologue):
    """``_kernel_conv3_dw`` (the plan's runs, and one stage a run, so
    that the partials' sum is exercised) against the dw of the JAX
    package's ``fused_conv3_bn`` VJP (the Pallas kernels in interpret
    mode), bfloat16, within TOL["bfloat16"] of max |dw|.  Both round dw
    to bfloat16; on these inputs they land 0 to 2e-6 of max |dw| apart
    (a value or two a bf16 ulp apart), far inside 2e-2."""
    a = _inputs(*shape, seed=11 + sum(shape))
    j = _to_jax(a, "bfloat16")
    c = j["x"].shape[-1]
    sc = j["scale"] if prologue else jnp.ones((c,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((c,), jnp.float32)
    fn = lambda x, w, s, b: jfc.fused_conv3_bn(  # noqa: E731
        x, w, s if prologue else None, b if prologue else None)
    (y, _, _), vjp = jax.vjp(fn, j["x"], j["w"], sc, bi)
    want = np.asarray(vjp((j["dy"], j["ds1"], j["ds2"]))[1]
                      .astype(jnp.float32))
    f32 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))  # noqa
    args = (f32(j["x"]), a["scale"] if prologue else None,
            a["bias"] if prologue else None, f32(y), f32(j["dy"]), a["ds1"],
            a["ds2"])
    for run_stages in (None, 1):
        got = _bf16(_kernel_conv3_dw(*args, run_stages=run_stages))
        _close(got, want, TOL["bfloat16"], f"dw_mma runs={run_stages}")


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,h,w,c,co", [
    (128, 56, 56, 64, 64), (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
    (128, 7, 7, 512, 512),             # ResNet-50's 3x3 shapes at B=128
    (2, 8, 8, 16, 24), (3, 6, 6, 16, 16), (2, 14, 14, 32, 16),
    (2, 5, 9, 16, 8), (16, 6, 6, 16, 260), (8, 7, 7, 512, 512),
    (1, 1, 1, 3, 5), (3, 2, 62, 8, 8), (2, 3, 63, 8, 8),  # one row a segment
    (1, 4, 200, 8, 8)])                # an image row in several segments
def test_dw_mma_split_tiles_the_pixels_in_whole_stages(sms, n, h, w, c, co):
    seg_w, stage_segs, row_segs = fc.dw_mma_geometry(w)
    # every pixel of an image row lies in exactly one segment, and a
    # stage's segments with their halo fit its 64 positions
    assert 1 <= seg_w <= 62 and (row_segs - 1) * seg_w < w <= row_segs * seg_w
    assert 1 <= stage_segs and stage_segs * (seg_w + 2) <= 64
    assert row_segs == 1 or stage_segs == 1
    segs = n * h * row_segs
    stages = -(-segs // stage_segs)
    run_stages, runs = fc.dw_mma_split(n, h, w, c, co, sms)
    # runs of whole stages cover every stage once
    assert 1 <= run_stages <= stages and runs <= 65535
    assert (runs - 1) * run_stages < stages <= runs * run_stages
    # no run so short that a block's partial outweighs an eighth of its
    # reads, unless the image holds fewer pixels
    pixels = run_stages * stage_segs * seg_w
    assert pixels >= fc._MMA_MIN_RUN_PIXELS or runs == 1


# ---------------------------------------------------------------------------
# kernel 16's float32 tile, by its arithmetic
# ---------------------------------------------------------------------------

def _tf32_rna(v):
    """float32 values rounded to tf32 as ``cvt.rna.tf32.f32`` rounds them
    (to nearest, ties away from zero), as float32; the edge cases are
    tested beside kernel 12's float32 tile in test_torch_fused_block.py."""
    v = np.ascontiguousarray(v, np.float32)
    r = (v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isnan(v), v, r.view(np.float32))


def _split_tf32(v):
    """``(hi, lo)``, both tf32, v = hi + lo up to 2^-22 |v|."""
    v = np.ascontiguousarray(v, np.float32)
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _kernel_conv3_dw_tf32(x, scale, bias, y, dy, ds1, ds2, sms=132,
                          run_stages=None):
    """dw (3, 3, C, C_out) float32 by ``fused_conv3_bn_dw_tf32``'s
    arithmetic, on float32 numpy arrays: xn = relu(x*scale + bias) and
    dyt = dy + ds1 + 2*y*ds2 in float32; the pixels walked as the
    bfloat16 tile walks them (``_walk``), in the runs of
    ``fc.dw_tf32_split`` unless ``run_stages`` is given, dyt 0 at a
    segment's halo positions and xn 0 outside the image; both split into
    tf32 hi + lo; per tap and 8-position step the three products lo·hi,
    hi·lo, hi·hi, each summed exactly and added with one rounding to the
    tap's float32 part, which starts at 0 each stage; each part added to
    the run's float32 sum; one partial per run, then the runs added in
    order."""
    n, h, w, c = x.shape
    co = dy.shape[-1]
    xn = x if scale is None else np.maximum(x * scale + bias, 0)
    dyt = (dy + ds1) + (2 * y) * ds2
    stages, b, hh, px, live, inner = _walk(n, h, w)
    if run_stages is None:
        run_stages, runs = fc.dw_tf32_split(n, h, w, c, co, sms)
    else:
        runs = -(-stages // run_stages)
    steps = _POS // 8
    d_hi, d_lo = _split_tf32(np.where(
        inner[..., None], dyt[b, hh, px.clip(0, w - 1)], 0))
    dw = np.zeros((runs, 3, 3, c, co), np.float32)
    for dh in (-1, 0, 1):
        ok = live & (hh + dh >= 0) & (hh + dh < h) & (px >= 0) & (px < w)
        x_tile = np.where(ok[..., None],
                          xn[b, (hh + dh).clip(0, h - 1), px.clip(0, w - 1)],
                          0)
        # the tile's rows: a zero guard, the positions, zeros past them
        x_hi, x_lo = _split_tf32(np.pad(x_tile, ((0, 0), (1, 2), (0, 0))))
        for tap in range(3):      # dw = tap - 1: row offset tap
            prods = [np.einsum(
                "skpc,skpo->skco",
                p[:, tap:tap + _POS].reshape(stages, steps, 8, c)
                .astype(np.float64),
                q.reshape(stages, steps, 8, co).astype(np.float64))
                for p, q in ((x_lo, d_hi), (x_hi, d_lo), (x_hi, d_hi))]
            for r in range(runs):
                acc = np.zeros((c, co), np.float32)
                for st in range(r * run_stages,
                                min(stages, (r + 1) * run_stages)):
                    part = np.zeros((c, co), np.float32)
                    for k in range(steps):
                        for p in prods:
                            part = (part.astype(np.float64)
                                    + p[st, k]).astype(np.float32)
                    acc = acc + part
                dw[r, dh + 1, tap] = acc
    out = np.zeros((3, 3, c, co), np.float32)
    for r in range(runs):
        out = out + dw[r]
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_dw_tf32_arithmetic_matches_the_jax_vjp(shape, prologue):
    """``_kernel_conv3_dw_tf32`` (the plan's runs, and one stage a run, so
    that the partials' sum is exercised) against the dw of the JAX
    package's ``fused_conv3_bn`` VJP (the Pallas kernels in interpret
    mode), float32, within TOL["float32"] of max |dw|.  On these inputs
    they land 2.0e-7 to 3.4e-7 of max |dw| apart (float32 sums in another
    order)."""
    a = _inputs(*shape, seed=11 + sum(shape))
    j = _to_jax(a, "float32")
    c = j["x"].shape[-1]
    sc = j["scale"] if prologue else jnp.ones((c,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((c,), jnp.float32)
    fn = lambda x, w, s, b: jfc.fused_conv3_bn(  # noqa: E731
        x, w, s if prologue else None, b if prologue else None)
    (y, _, _), vjp = jax.vjp(fn, j["x"], j["w"], sc, bi)
    want = np.asarray(vjp((j["dy"], j["ds1"], j["ds2"]))[1])
    args = (a["x"], a["scale"] if prologue else None,
            a["bias"] if prologue else None, np.asarray(y), a["dy"],
            a["ds1"], a["ds2"])
    for run_stages in (None, 1):
        got = _kernel_conv3_dw_tf32(*args, run_stages=run_stages)
        _close(got, want, TOL["float32"], f"dw_tf32 runs={run_stages}")


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,h,w,c,co", [
    (128, 56, 56, 64, 64), (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
    (128, 7, 7, 512, 512),             # ResNet-50's 3x3 shapes at B=128
    (2, 8, 8, 16, 24), (16, 6, 6, 16, 260), (1, 1, 1, 3, 5),
    (1, 4, 200, 8, 8)])                # an image row in several segments
def test_dw_tf32_split_tiles_the_pixels_in_whole_stages(sms, n, h, w, c, co):
    seg_w, stage_segs, row_segs = fc.dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    run_stages, runs = fc.dw_tf32_split(n, h, w, c, co, sms)
    assert 1 <= run_stages <= stages and runs <= 65535
    assert (runs - 1) * run_stages < stages <= runs * run_stages
    # no run so short that a block's float32 partial outweighs an eighth
    # of its float32 reads, unless the image holds fewer pixels
    pixels = run_stages * stage_segs * seg_w
    assert pixels >= fc._TF32_MIN_RUN_PIXELS or runs == 1
    assert 8 * 2 * 3 * 64 * 64 * 4 <= fc._TF32_MIN_RUN_PIXELS * 3 * 64 * 4
    # no allowed run length leaves the slowest SM less work
    tiles = 3 * -(-c // 64) * -(-co // 64)
    slots = fc._TF32_BLOCKS_PER_SM * sms

    def cost(r):
        return -(-tiles * -(-stages // r) // slots) * r

    least = min(stages, -(-fc._TF32_MIN_RUN_PIXELS // (stage_segs * seg_w)))
    assert all(cost(run_stages) <= cost(r)
               for r in range(least, stages + 1))


# ---------------------------------------------------------------------------
# kernel 13's bfloat16 tile, by its arithmetic
# ---------------------------------------------------------------------------

def _kernel_conv3_fwd(x, w, scale, bias, sms=132, run_stages=None):
    """``(y, s1, s2)`` by ``fused_conv3_bn_fwd_mma``'s arithmetic, on
    numpy arrays that hold bfloat16 values: xn = relu(x*scale + bias) in
    float32, rounded to bf16; the pixels walked in kernel 16's segments
    and stages (``fc.dw_mma_geometry``), 64 positions a stage, a stage's
    xn of image row h + dh a tile with a zero guard row on either side and
    0 outside the image, so that tap dw is the tile at row offset dw + 1;
    per stage the depth in the kernel's order (dh, then chunks of
    ``fc.fwd_mma_tile``'s kc channels, then the three taps, then steps of
    16 channels), each step's exact product summed and rounded once to
    float32 (one ``mma``); y rounded to bf16 and kept at the segments'
    own pixels; s1 and s2 of the rounded y, one float32 partial per run
    (``fc.fwd_mma_split`` unless ``run_stages`` is given), the runs then
    added in order."""
    n, h, wd, c = x.shape
    co = w.shape[-1]
    xn = x if scale is None else _bf16(np.maximum(x * scale + bias, 0))
    stages, b, hh, px, live, keep = _walk(n, h, wd)
    if run_stages is None:
        run_stages, runs = fc.fwd_mma_split(n, h, wd, c, co, sms)
    else:
        runs = -(-stages // run_stages)
    assert runs == -(-stages // run_stages) and run_stages <= stages
    kc = fc.fwd_mma_tile(c, co)[1]
    acc = np.zeros((stages, _POS, co), np.float32)
    for dh in (-1, 0, 1):
        ok = live & (hh + dh >= 0) & (hh + dh < h) & (px >= 0) & (px < wd)
        x_tile = np.where(ok[..., None],
                          xn[b, (hh + dh).clip(0, h - 1), px.clip(0, wd - 1)],
                          0).astype(np.float64)
        x_tile = np.pad(x_tile, ((0, 0), (1, 1), (0, 0)))  # the guard rows
        for c0 in range(0, c, kc):
            for tap in range(3):          # dw = tap - 1: row offset tap
                a = x_tile[:, tap:tap + _POS]
                for k0 in range(c0, min(c, c0 + kc), 16):
                    ks = slice(k0, min(c, k0 + 16))
                    step = np.einsum("spc,co->spo", a[..., ks],
                                     w[dh + 1, tap, ks].astype(np.float64))
                    acc = (acc + step).astype(np.float32)
    yb = _bf16(acc)
    y = np.zeros((n, h, wd, co), np.float32)
    y[b[keep], hh[keep], px[keep]] = yb[keep]
    s1 = np.zeros(co, np.float32)
    s2 = np.zeros(co, np.float32)
    for r in range(runs):
        rows = yb[r * run_stages:(r + 1) * run_stages][
            keep[r * run_stages:(r + 1) * run_stages]]
        s1 = s1 + rows.sum(axis=0, dtype=np.float32)
        s2 = s2 + (rows * rows).sum(axis=0, dtype=np.float32)
    return y, s1, s2


# the JAX tests' shapes, then image rows of three segments (W = 130) and
# of two with C = 72 > 64 (channels in chunks of 32)
FWD_MMA_SHAPES = SHAPES + [(1, 3, 130, 8, 8), (1, 2, 70, 72, 24)]


@pytest.mark.parametrize("shape", FWD_MMA_SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
def test_fwd_mma_arithmetic_matches_the_pallas_forward(shape, prologue):
    """``_kernel_conv3_fwd`` (the plan's runs, and one stage a run, so
    that the partials' sum is exercised) against the JAX package's Pallas
    forward ``_fc3`` in interpret mode, bfloat16: y, s1 and s2 within
    TOL["bfloat16"] (2e-2) of their largest |JAX| value.  Both round y to
    bf16 from float32 sums taken in another order, so a value may land
    one bf16 ulp (2^-8 of it) away: on these inputs 0 to 2.5e-3 of max|y|
    (0 to 3.6e-4 for s1 and s2), against about 1 for mirrored taps."""
    a = _inputs(*shape, seed=17 + sum(shape))
    j = _to_jax(a, "bfloat16")
    g = jfc._Geom(j["x"], shape[4])
    assert g.fits()
    c = shape[3]
    sc = j["scale"] if prologue else jnp.ones((c,), jnp.float32)
    bi = j["bias"] if prologue else jnp.zeros((c,), jnp.float32)
    want = [np.asarray(v.astype(jnp.float32))
            for v in jfc._fc3(j["x"], j["w"], sc, bi, prologue)]
    f32 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))  # noqa
    args = (f32(j["x"]), f32(j["w"]), a["scale"] if prologue else None,
            a["bias"] if prologue else None)
    for run_stages in (None, 1):
        got = _kernel_conv3_fwd(*args, run_stages=run_stages)
        for name, gv, wv in zip(("y", "s1", "s2"), got, want):
            _close(gv, wv, TOL["bfloat16"],
                   f"fwd_mma {name} runs={run_stages}")


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,h,w,c,co", [
    (128, 56, 56, 64, 64), (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
    (128, 7, 7, 512, 512),             # ResNet-50's 3x3 shapes at B=128
    (2, 8, 8, 16, 24), (3, 6, 6, 16, 16), (2, 14, 14, 32, 16),
    (2, 5, 9, 16, 8), (16, 6, 6, 16, 260), (8, 7, 7, 512, 512),
    (1, 1, 1, 3, 5), (3, 2, 62, 8, 8), (2, 3, 63, 8, 8),
    (1, 4, 200, 8, 8), (1, 2, 70, 72, 24)])
def test_fwd_mma_split_tiles_the_pixels_in_whole_stages(sms, n, h, w, c, co):
    _, stage_segs, row_segs = fc.dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    run_stages, runs = fc.fwd_mma_split(n, h, w, c, co, sms)
    # runs of whole stages cover every stage once, within the grid's
    # limit, and enough of them that every SM gets a block where the
    # stages allow
    assert 1 <= run_stages <= stages and runs <= 65535
    assert (runs - 1) * run_stages < stages <= runs * run_stages
    bn, kc = fc.fwd_mma_tile(c, co)
    assert bn in (64, 128) and (bn == 64) == (co <= 64)
    assert kc == (64 if c <= 64 else 32)
    assert runs * -(-co // bn) >= min(sms, stages)


# ---------------------------------------------------------------------------
# kernel 14's bfloat16 tile (and the TPU's kernel 15), by its arithmetic
# ---------------------------------------------------------------------------

def _kernel_conv3_dx(x, w, scale, bias, y, dy, ds1, ds2, sms=132,
                     run_stages=None):
    """``(dx, dscale, dbias)`` by ``fused_conv3_bn_dx_mma``'s arithmetic,
    on numpy arrays that hold bfloat16 values: dyt = dy + ds1 + 2*y*ds2 in
    float32, rounded to bf16; the pixels walked in kernel 16's segments
    and stages (``fc.dw_mma_geometry``), 64 positions a stage, a stage's
    dyt of image row h - dh a tile with a zero guard row on either side
    and 0 outside the image (past M, where it would be ds1, too), so that
    tap dw reads it at row offset 1 - dw; per stage the depth in the
    kernel's order (dh, then chunks of ``fc.dx_mma_tile``'s kc output
    channels, then the three taps, then steps of 16 channels), each
    step's exact product summed and rounded once to float32 (one
    ``mma``); at the segments' own pixels, with the prologue z =
    x*scale + bias in float32, dz = dxn where z > 0, dx = dz*scale
    rounded to bf16, and dscale, dbias the float32 sums of dz*x and dz,
    one partial per run (``fc.dx_mma_split`` unless ``run_stages`` is
    given), the runs then added in order; without it dx = dxn rounded to
    bf16 and dscale, dbias zeros."""
    n, h, wd, c = x.shape
    co = dy.shape[-1]
    dyt = _bf16((dy + ds1) + (2 * y) * ds2)
    stages, b, hh, px, live, keep = _walk(n, h, wd)
    if run_stages is None:
        run_stages, runs = fc.dx_mma_split(n, h, wd, c, co, sms)
    else:
        runs = -(-stages // run_stages)
    assert runs == -(-stages // run_stages) and run_stages <= stages
    kc = fc.dx_mma_tile(c, co)[1]
    acc = np.zeros((stages, _POS, c), np.float32)
    for dh in (-1, 0, 1):
        ok = live & (hh - dh >= 0) & (hh - dh < h) & (px >= 0) & (px < wd)
        d_tile = np.where(ok[..., None],
                          dyt[b, (hh - dh).clip(0, h - 1), px.clip(0, wd - 1)],
                          0).astype(np.float64)
        d_tile = np.pad(d_tile, ((0, 0), (1, 1), (0, 0)))  # the guard rows
        for o0 in range(0, co, kc):
            for tap in range(3):          # dw = tap - 1: row offset 2 - tap
                a = d_tile[:, 2 - tap:2 - tap + _POS]
                for k0 in range(o0, min(co, o0 + kc), 16):
                    ks = slice(k0, min(co, k0 + 16))
                    step = np.einsum("spo,co->spc", a[..., ks],
                                     w[dh + 1, tap, :, ks].astype(np.float64))
                    acc = (acc + step).astype(np.float32)
    zero = np.zeros(c, np.float32)
    if scale is None:
        rows, dsc, dbi = _bf16(acc), zero, zero
    else:
        xk = x[b, hh, px.clip(0, wd - 1)]
        dz = np.where(xk * scale + bias > 0, acc, 0).astype(np.float32)
        rows = _bf16(dz * scale)
        dsc, dbi = zero, zero
        for r in range(runs):
            part = slice(r * run_stages, (r + 1) * run_stages)
            own = keep[part]
            dsc = dsc + (dz[part] * xk[part])[own].sum(axis=0, dtype=np.float32)
            dbi = dbi + dz[part][own].sum(axis=0, dtype=np.float32)
    dx = np.zeros((n, h, wd, c), np.float32)
    dx[b[keep], hh[keep], px[keep]] = rows[keep]
    return dx, dsc, dbi


@pytest.mark.parametrize("shape", FWD_MMA_SHAPES + [MULTI_NBLOCK])
@pytest.mark.parametrize("prologue", [False, True])
def test_dx_mma_arithmetic_matches_the_jax_vjp(shape, prologue, monkeypatch):
    """``_kernel_conv3_dx`` (the plan's runs, and one stage a run, so that
    the partials' sum is exercised) against the dx, dscale and dbias of
    the JAX package's Pallas VJP ``_fc3`` in interpret mode, bfloat16,
    within TOL["bfloat16"] (2e-2) of their largest |JAX| value.  At
    MULTI_NBLOCK the JAX side is forced onto ``_bwd_dx_kernel_nb`` (C_out
    in three N blocks: the TPU's kernel 15), as
    ``test_multi_nblock_geometry_matches_the_pallas_kernels`` forces it.
    Both round dx to bf16 from float32 sums taken in another order, so a
    value may land one bf16 ulp (2^-8 of it) away."""
    a = _inputs(*shape, seed=29 + sum(shape))
    j = _to_jax(a, "bfloat16")
    n, h, w, c, co = shape
    if shape == MULTI_NBLOCK:
        monkeypatch.setattr(jfc, "_VMEM_BUDGET",
                            jfc._Geom(j["x"], co)._bytes(128) + 1)
        g = jfc._Geom(j["x"], co)
        assert g.n_blocks == 3 and g.fits()
    else:
        assert jfc._Geom(j["x"], co).fits()
    (y, _, _), (dx, _, dsc, dbi) = _jax_vjp(_pallas(prologue), j, prologue)
    f32 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))  # noqa
    args = (f32(j["x"]), f32(j["w"]), a["scale"] if prologue else None,
            a["bias"] if prologue else None, f32(y), f32(j["dy"]), a["ds1"],
            a["ds2"])
    for run_stages in (None, 1):
        got = _kernel_conv3_dx(*args, run_stages=run_stages)
        _close(got[0], f32(dx), TOL["bfloat16"], f"dx_mma dx runs={run_stages}")
        if prologue:
            for name, gv, wv in zip(("dscale", "dbias"), got[1:], (dsc, dbi)):
                _close(gv, f32(wv), TOL["bfloat16"],
                       f"dx_mma {name} runs={run_stages}")


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,h,w,c,co", [
    (128, 56, 56, 64, 64), (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
    (128, 7, 7, 512, 512),             # ResNet-50's 3x3 shapes at B=128
    (2, 8, 8, 16, 24), (3, 6, 6, 16, 16), (2, 14, 14, 32, 16),
    (2, 5, 9, 16, 8), (16, 6, 6, 16, 260), (8, 7, 7, 512, 512),
    (1, 1, 1, 3, 5), (3, 2, 62, 8, 8), (2, 3, 63, 8, 8),
    (1, 4, 200, 8, 8), (1, 2, 70, 72, 24), (2, 6, 6, 200, 80)])
def test_dx_mma_split_tiles_the_pixels_in_whole_stages(sms, n, h, w, c, co):
    _, stage_segs, row_segs = fc.dw_mma_geometry(w)
    stages = -(-(n * h * row_segs) // stage_segs)
    run_stages, runs = fc.dx_mma_split(n, h, w, c, co, sms)
    # runs of whole stages cover every stage once, within the grid's
    # limit, and enough of them that every SM gets a block where the
    # stages allow
    assert 1 <= run_stages <= stages and runs <= 65535
    assert (runs - 1) * run_stages < stages <= runs * run_stages
    bn, kc = fc.dx_mma_tile(c, co)
    assert bn in (64, 128) and (bn == 64) == (c <= 64)
    assert kc == (64 if max(c, co) <= 64 else 32)
    assert runs * -(-c // bn) >= min(sms, stages)
