"""Flash attention of the PyTorch port against the JAX package's.

The port's plain versions (what its wrappers run on CPU tensors), by
way of ``flash_attention`` and its autograd Function, are held against
``pk.flash_attention`` run as ``tests/test_pallas.py`` runs it: the
Pallas forward kernel in interpret mode on the CPU, and its custom VJP,
``_attn_bwd_reference``.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``).

Tolerances.  float32: the output within 1e-6 absolute plus 1e-5 of
itself (both sides compute the same float32 products and exps, summed
in another order and, in JAX, over 128-wide blocks with an online
rescale); the lse within 1e-5 absolute of a float64 numpy logsumexp of
the masked, scaled logits (float32 rounding of values about log T);
each gradient within 1e-5 of its tensor's largest value (float32 sums of
up to 96 terms of p·(dp − delta), whose two parts cancel).  bfloat16:
both sides widen the same bf16 values and compute in float32, then round
once, so each value may land one bf16 ulp away (2^-8 of it), plus the
float32 allowance.  The bf16 gradients take the cotangent 2·o from the
JAX side, so both backwards see the same bits (a one-ulp difference in
o would otherwise move the cotangent of ``(o ** 2).sum()``).

The bfloat16 backward kernels' arithmetic, emulated here (they run only
on the card): bf16 q, k, v and dO enter the tensor cores as they are,
so s = q·kᵀ and dp = dO·vᵀ are float32 sums of exact products; p and ds
stay float32 and enter dv = pᵀ·dO, dk = dsᵀ·q and dq = ds·k as two bf16
parts, hi = bf16(x) and lo = bf16(x − hi), each product summed in
float32.  That emulation is held to ``_attn_bwd_reference`` at
``GRAD_TOL``, the share of the largest value that the card holds the
kernels to (with the outputs in float32, before their bf16 rounding);
one bf16 rounding of p and ds instead does not fit it.  The bfloat16
forward kernel is emulated the same way (``_kernel_fwd``: s = (q·kᵀ)·scale
from the bf16 values, the float32 softmax, p as two bf16 parts for p·v)
and held to the Pallas forward kernel at ``O_TOL``; one bf16 rounding
of p does not fit it either.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_kernels as pk

from incubator_mxnet_tpu_torch.ops import flash_attention as fa

# (B, H, Tq, Tk, D, causal): test_pallas.py's shapes, its cross lengths,
# and a 16-wide head
CASES = [(2, 3, 64, 64, 32, False), (2, 3, 64, 64, 32, True),
         (2, 3, 200, 200, 64, False), (2, 3, 200, 200, 64, True),
         (1, 2, 70, 150, 32, False), (1, 2, 50, 50, 16, True)]
F32_ATOL, F32_RTOL = 1e-6, 1e-5
LSE_ATOL = 1e-5
GRAD_TOL = 1e-5


def _inputs(b, h, tq, tk, d, seed=0):
    """q, k ~ 0.5·N(0, 1), v ~ N(0, 1), as test_pallas.py draws them."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, tq, d).astype(np.float32) * 0.5,
            rs.randn(b, h, tk, d).astype(np.float32) * 0.5,
            rs.randn(b, h, tk, d).astype(np.float32))


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors in ``dtype``;
    in bfloat16 both sides get the bf16 rounding JAX makes."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _close(got, want, dtype, atol, rtol=0.0):
    bound = atol + rtol * np.abs(want)
    if dtype == "bfloat16":
        bound = bound + np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    excess = np.abs(got - want) - bound
    assert np.all(excess <= 0), excess.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_matches_pallas_kernel(case, dtype):
    b, h, tq, tk, d, causal = case
    (jq, jk, jv), (tq_, tk_, tv) = _both(_inputs(b, h, tq, tk, d), dtype)
    want = _np(pk.flash_attention(jq, jk, jv, causal=causal))
    got = fa.flash_attention(tq_, tk_, tv, causal=causal)
    assert got.dtype == tq_.dtype and tuple(got.shape) == (b, h, tq, d)
    _close(_np(got), want, dtype, F32_ATOL, F32_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_matches_numpy_logsumexp(case, dtype):
    b, h, tq, tk, d, causal = case
    _, (q, k, v) = _both(_inputs(b, h, tq, tk, d, seed=1), dtype)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, tq)
    s = np.einsum("bhqd,bhkd->bhqk", q.double().numpy(),
                  k.double().numpy()) * d ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((tq, tk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_attn_bwd_reference(causal, dtype):
    """Gradients of ``(o ** 2).sum()`` at test_pallas.py's (1, 2, 96, 32)
    against ``jax.vjp`` of ``pk.flash_attention``, whose backward is
    ``_attn_bwd_reference``."""
    (jq, jk, jv), (tq_, tk_, tv) = _both(_inputs(1, 2, 96, 96, 32, seed=14),
                                         dtype)
    o_j, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=causal), jq, jk, jv)
    want = [_np(g) for g in vjp(2 * o_j)]
    leaves = [t.clone().requires_grad_(True) for t in (tq_, tk_, tv)]
    o = fa.flash_attention(*leaves, causal=causal)
    if dtype == "float32":
        got = torch.autograd.grad((o ** 2).sum(), leaves)
    else:
        ct = torch.from_numpy(_np(2 * o_j)).to(o.dtype)
        got = torch.autograd.grad(o, leaves, ct)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tq_.dtype, name
        _close(_np(g), w, dtype, GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_attn_bwd_reference_cross_lengths(causal, dtype):
    """``flash_bwd`` from the forward's float32 output and lse against
    ``_attn_bwd_reference`` called directly, at Tq = 70, Tk = 150 (causal
    aligned top-left: the last 80 keys get no gradient)."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 2, 70, 150, 32, seed=3),
                                    dtype)
    g = np.random.RandomState(4).randn(1, 2, 70, 32).astype(np.float32)
    (jg,), (tg,) = _both([g], dtype)
    scale = 32 ** -0.5
    want = [_np(a) for a in pk._attn_bwd_reference(jq, jk, jv, scale, causal,
                                                   jg)]
    o, lse = fa.flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)
    got = fa.flash_bwd(q, k, v, o, lse, tg, causal=causal)
    for name, a, w in zip("qkv", got, want):
        _close(_np(a), w, dtype, GRAD_TOL * np.abs(w).max())
    if causal:
        assert not got[1][:, :, 70:].any() and not got[2][:, :, 70:].any()


def test_residual_is_the_float32_output():
    """With a gradient wanted, the forward keeps O in float32 and returns
    its bf16 rounding, which is the output the kernel writes in bf16."""
    _, (q, k, v) = _both(_inputs(1, 2, 40, 40, 16, seed=5), "bfloat16")
    o32, lse32 = fa.flash_fwd(q, k, v, causal=True, out_dtype=torch.float32)
    o16, lse16 = fa.flash_fwd(q, k, v, causal=True)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    assert torch.equal(o32.to(torch.bfloat16), o16)
    assert torch.equal(lse32, lse16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    assert torch.equal(out, o16)
    saved = out.grad_fn.saved_tensors
    assert any(t.dtype == torch.float32 and torch.equal(t, o32)
               for t in saved)


def test_scale_defaults_to_head_dim_and_cpu_launches_nothing():
    _, (q, k, v) = _both(_inputs(1, 1, 20, 30, 8, seed=6), "float32")
    before = (fa.fwd_launches, fa.bwd_dkdv_launches, fa.bwd_dq_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    out.sum().backward()
    explicit = fa.flash_attention(q, k, v, sm_scale=8 ** -0.5)
    assert torch.equal(out.detach(), explicit)
    assert not torch.equal(explicit, fa.flash_attention(q, k, v,
                                                        sm_scale=0.5))
    assert (fa.fwd_launches, fa.bwd_dkdv_launches,
            fa.bwd_dq_launches) == before          # CPU: plain versions


def _split(x):
    """x as hi = bf16(x) and lo = bf16(x − hi), both widened to float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _rounded(x):
    """x as one bf16 rounding and a zero second part."""
    return x.to(torch.bfloat16).float(), torch.zeros_like(x)


def _kernel_bwd(q, k, v, o, lse, g, causal, parts):
    """``(dq, dk, dv)`` in float32 by the bf16 backward kernels'
    arithmetic, with p and ds cut into two bf16 parts by ``parts``."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.unsqueeze(-1))
    if causal:
        p = torch.where(fa._keep(p.shape[-2], p.shape[-1], p.device), p, 0.0)
    delta = (gf * o).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta) * scale
    (p_hi, p_lo), (ds_hi, ds_lo) = parts(p), parts(ds)
    dq = torch.matmul(ds_hi, kf) + torch.matmul(ds_lo, kf)
    dk = (torch.matmul(ds_hi.transpose(-1, -2), qf)
          + torch.matmul(ds_lo.transpose(-1, -2), qf))
    dv = (torch.matmul(p_hi.transpose(-1, -2), gf)
          + torch.matmul(p_lo.transpose(-1, -2), gf))
    return dq, dk, dv


# (B, H, Tq, Tk, D, causal): the TransformerLM's T and head width; cross
# lengths
SPLIT_CASES = [(1, 2, 1025, 1025, 64, True), (1, 2, 70, 150, 32, True)]


def _split_case(case):
    """The JAX reference's float32 and bfloat16 gradients and the
    port's forward residuals for one case."""
    b, h, tq, tk, d, causal = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, h, tq, tk, d, seed=7),
                                    "bfloat16")
    g = np.random.RandomState(8).randn(b, h, tq, d).astype(np.float32)
    (jg,), (tg,) = _both([g], "bfloat16")
    f32 = [a.astype(jnp.float32) for a in (jq, jk, jv, jg)]
    want32 = [_np(a) for a in pk._attn_bwd_reference(
        *f32[:3], d ** -0.5, causal, f32[3])]
    want16 = [_np(a) for a in pk._attn_bwd_reference(
        jq, jk, jv, d ** -0.5, causal, jg)]
    o, lse = fa.flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)
    return (q, k, v, o, lse, tg), want32, want16


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_products_hold_attn_bwd_reference_to_grad_tol(case):
    """hi + lo parts of p and ds: dq, dk and dv within GRAD_TOL of the
    largest value of JAX's float32 backward of the same bf16 values, and
    their bf16 roundings within one bf16 ulp more of JAX's bf16
    backward."""
    args, want32, want16 = _split_case(case)
    got = _kernel_bwd(*args, case[5], _split)
    for name, a, w32, w16 in zip("qkv", got, want32, want16):
        err = np.abs(_np(a) - w32).max() / np.abs(w32).max()
        assert err <= GRAD_TOL, (name, err)
        _close(_np(a.to(torch.bfloat16)), w16, "bfloat16",
               GRAD_TOL * np.abs(w16).max())


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_one_bf16_rounding_of_p_and_ds_misses_grad_tol(case):
    """The control: with p and ds rounded once to bf16 (what a plain bf16
    tensor-core product would take), every gradient misses GRAD_TOL."""
    args, want32, _ = _split_case(case)
    got = _kernel_bwd(*args, case[5], _rounded)
    for name, a, w in zip("qkv", got, want32):
        err = np.abs(_np(a) - w).max() / np.abs(w).max()
        assert err > GRAD_TOL, (name, err)


def test_vec16_takes_the_model_heads_and_refuses_unaligned_rows():
    """The 16-byte copies of the bf16 kernels: taken for the
    TransformerLM's heads (views of one (B, T, 3·H·D) product), refused
    for a head width, a start or a row stride off 8 elements."""
    b, t, h, d = 2, 5, 3, 64
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2)
               for x in qkv.split(h * d, dim=-1))
    assert fa._vec16(q, k, v, q)
    assert not fa._vec16(q[..., :60], k[..., :60], v[..., :60])   # D = 60
    shifted = qkv[..., 1:1 + h * d].reshape(b, t, h, d).transpose(1, 2)
    assert not fa._vec16(shifted, k, v)                           # start
    wide = torch.zeros(b, t, h, d + 4, dtype=torch.bfloat16)[..., :d]
    assert not fa._vec16(q, wide.transpose(1, 2), v)              # strides


# the share of max|o| that the card holds the forward kernel's float32
# output to (chip_smoke.py's FLASH_TOL)
O_TOL = 1e-5


def _kernel_fwd(q, k, v, causal, parts):
    """``(o, lse)`` in float32 by the bf16 forward kernel's arithmetic:
    ``s = (q·kᵀ)·scale`` from the bf16 values in float32 (the products
    are exact), -1e30 where masked, the float32 softmax, and ``p = exp(s
    − m)`` cut into two bf16 parts by ``parts`` for p·v, each product
    summed in float32.  The kernel's online rescale over 64-wide KV tiles
    is left out: it changes only float32 roundings."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~fa._keep(s.shape[-2], s.shape[-1], s.device),
                          fa._NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    hi, lo = parts(p)
    o = (torch.matmul(hi, vf) + torch.matmul(lo, vf)) / den
    return o, (m + torch.log(den)).squeeze(-1)


# (B, H, Tq, Tk, D, causal): the TransformerLM's T and head width; cross
# lengths; D = 32 and 128, whose scales are not powers of two
FWD_SPLIT_CASES = [(1, 2, 1025, 1025, 64, True), (1, 2, 70, 150, 64, False),
                   (1, 2, 300, 300, 32, True), (1, 2, 300, 300, 128, False)]


def _fwd_split_case(case):
    """bf16 q, k, v and the Pallas forward kernel's outputs for them: in
    float32 (from the same bf16 values widened) and in bfloat16."""
    b, h, tq, tk, d, causal = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, h, tq, tk, d, seed=9),
                                    "bfloat16")
    want32 = _np(pk.flash_attention(*(a.astype(jnp.float32)
                                      for a in (jq, jk, jv)), causal=causal))
    want16 = _np(pk.flash_attention(jq, jk, jv, causal=causal))
    return (q, k, v), want32, want16


def _numpy_lse(q, k, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q.double().numpy(),
                  k.double().numpy()) * q.shape[-1] ** -0.5
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", FWD_SPLIT_CASES, ids=str)
def test_split_p_holds_pallas_forward_to_o_tol(case):
    """hi + lo parts of p: the float32 o within O_TOL of the largest value
    of the Pallas kernel's float32 output for the same bf16 values, its
    bf16 rounding within one bf16 ulp more of the kernel's bf16 output,
    and lse within LSE_ATOL of a float64 logsumexp."""
    (q, k, v), want32, want16 = _fwd_split_case(case)
    o, lse = _kernel_fwd(q, k, v, case[5], _split)
    err = np.abs(_np(o) - want32).max() / np.abs(want32).max()
    lse_err = np.abs(lse.numpy() - _numpy_lse(q, k, case[5])).max()
    print(f"{case}: o {err:.3e} of max|o| (O_TOL {O_TOL:g}), lse "
          f"{lse_err:.3e} (LSE_ATOL {LSE_ATOL:g})")
    assert err <= O_TOL, err
    _close(_np(o.to(torch.bfloat16)), want16, "bfloat16",
           O_TOL * np.abs(want16).max())
    assert lse_err <= LSE_ATOL, lse_err


def test_one_bf16_rounding_of_p_misses_o_tol():
    """The control: with p rounded once to bf16 (what a plain bf16
    tensor-core product would take), o misses O_TOL at the TransformerLM's
    T and head width."""
    case = FWD_SPLIT_CASES[0]
    (q, k, v), want32, _ = _fwd_split_case(case)
    o, _ = _kernel_fwd(q, k, v, case[5], _rounded)
    err = np.abs(_np(o) - want32).max() / np.abs(want32).max()
    print(f"{case}: one bf16 rounding of p puts o {err:.3e} of max|o| away")
    assert err > O_TOL, err
