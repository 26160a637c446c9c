"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the sums run in another order); bfloat16 y
rtol=atol=1e-2 (one bf16 ulp at |y| ~ 1); the float32 statistics 1e-5.
LayerNorm backward: dx float32 1e-5, bfloat16 rtol=atol=2e-2 (one
bf16 ulp of dx at |dx| ~ 2); dgamma/dbeta 1e-5 relative to the largest
value (float32 sums of all rows in another order).  Cross-entropy: loss
1e-5 (float32 in both versions); dx float32 rtol=1e-5, atol=1e-6 (one
float32 ulp of a row's logsumexp, about 15 here, moves exp(x - lse) by
about 1e-6 of itself) and bfloat16 rtol=8e-3 (one bf16 ulp of each
element, at most 2^-7 of it), atol=1e-6 (entries near 0).  Fused
matmul + BatchNorm (kernels 10-12), each output's max |kernel - plain|
against the largest |plain| value of that tensor: float32 1e-5 (the
same products summed in another order), bfloat16 2e-2 (y, dx and dw
are rounded to bf16, so an f32 sum in another order can land one bf16
ulp, 2^-8 of a value, away); the float32 column sums s1, s2, dscale and
dbias take the same share of their largest value.  The fused 3x3
conv + BatchNorm kernels take the same tolerances, for the same
reasons; the bfloat16 tensor-core tiles of kernels 10-16 too (both
operands rounded to bf16 before the exact products, float32 sums in
another order), and the float32 3xTF32 tiles of kernels 10-16 (three
tf32 products keep about 2^-21 of each float32 product, and the sums
run in another order).  The small fused ResNet, card step against
CPU step: loss 1e-5 relative, every gradient 1e-3 of its largest value
(50 layers of float32 sums in another order; both TF32 switches off).
Its ``FusedTrainStep`` by CUDA-graph replay against the same step run
eagerly: every loss and state tensor within 1e-6 of the largest value
(the same kernels on the same inputs, cuDNN deterministic: they agree
bit for bit unless a library picks another algorithm under capture).
Softmax and RMSNorm (kernels 3-4 and 8-9), each output against its
plain version: float32 max|d| <= 1e-6 of the largest |plain| value (the
same float32 arithmetic, with sums in another order); bfloat16 within
one bf16 ulp of each value (2^-8 of it: the same float32 value rounded
once may land on a neighbouring bf16 value) plus that float32 allowance.
The small TransformerLM, card step against CPU step in float32 (TF32
off): loss 1e-5 relative, every gradient 1e-4 of its largest value.
Flash attention (kernel 5 and its dk/dv and dq kernels), each output
against its plain version on the same inputs (the backward's from the
kernel's own float32 output and lse): float32 within 1e-5 of the
largest |plain| value (the same float32 products summed in another
order, over up to 1025 keys); dq and dk within 1e-5 of the size of the
two terms whose difference ds is (scale·max|delta|·max|k| or |q|) where
that is larger: with one key they cancel exactly; bfloat16 one bf16 ulp
of each value more.  Run-time-compiled CUDA C (``rtc``) and the LeNet
step state theirs in their own section below.  The fused RNN (cuDNN's,
through ``fused_rnn``) against ``fused_rnn_reference``, float32 with
TF32 off: outputs and states 1e-5 absolute (values in (-1, 1)), every
gradient 1e-4 of its largest value (the same products summed in
another order over the recurrence).  The detection ops (SSD), card
against CPU on the same inputs: floats within 1e-5; class targets,
masks, class ids and kept rows equal (these data have no near-tie at
the mining cut-off or a threshold: ``tests/test_torch_contrib_det.py``
states the rule).  The small SSD step, card against CPU: loss 1e-5
relative, every gradient 1e-4 of its largest value but the convolution
biases in front of a BatchNorm, whose gradient is rounding noise on
both devices (below 1e-4 of their weights' largest).  The optimizers,
card against CPU from the same weight and gradients: every float32
tensor within 1e-6 of its largest value (LAMB and LARS 1e-5, their
norms summed in another order), a bfloat16 weight with a float32 master
within one bf16 ulp of each value, or where its master ends near 0 by
cancellation, within the masters' own tolerance.  A ``.params`` file written from the
card reads back on the CPU equal, and a small bfloat16 BERT trained with
LAMB and saved and resumed on the card equals its uninterrupted run
within the card's own spread between two uninterrupted runs.
"""
import copy

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import amp, autograd
from incubator_mxnet_tpu_torch.convert import grads_to_numpy
from incubator_mxnet_tpu_torch.examples.train_bert import (pretraining_loss,
                                                           synthetic_batch)
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1, ResNetV1)
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import fused_block as fb
from incubator_mxnet_tpu_torch.ops import fused_conv as fc
from incubator_mxnet_tpu_torch.ops import layer_norm as ln
from incubator_mxnet_tpu_torch.ops import rms_norm as rn
from incubator_mxnet_tpu_torch.ops import softmax as sm
from incubator_mxnet_tpu_torch.ops import softmax_xent as sx

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
STAT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(shape, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * torch.randn(shape[-1], generator=g)
    beta = 0.1 * torch.randn(shape[-1], generator=g)
    return tuple(a.to(dev, getattr(torch, dtype)) for a in (x, gamma, beta))


def _offset(a, offset):
    """``a`` copied ``offset`` elements into a buffer: contiguous, but for
    an odd offset no longer on 16 bytes, so the row kernels load it
    element by element."""
    if not offset:
        return a
    buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=a.device)
    return buf[offset:].view(a.shape).copy_(a)


@pytest.mark.parametrize("shape,dtype,pdtype,offset", [
    ((1024, 768), "float32", "float32", 0),   # BERT-base serving, B=8 T=128
    ((1024, 768), "bfloat16", "bfloat16", 0),
    ((1024, 768), "bfloat16", "float32", 0),  # amp: float32 gamma and beta
    ((2048, 768), "float32", "float32", 0),   # BERT-base training, B=16
    ((2048, 768), "bfloat16", "float32", 0),
    ((1000, 100), "float32", "float32", 0),   # one warp a row, ragged block
    ((64, 1000), "float32", "float32", 0),    # part of the last chunks
    ((64, 1000), "bfloat16", "bfloat16", 0),
    ((64, 770), "bfloat16", "bfloat16", 0),   # no multiple of a bf16 chunk
    ((64, 768), "float32", "float32", 1),     # x off 16 bytes: element loads
    ((64, 768), "bfloat16", "float32", 1),
    ((3, 4096), "bfloat16", "bfloat16", 0),   # one block a row
    ((8, 3, 513), "float32", "float32", 0),   # warp path, element loads
    ((8, 3, 1025), "float32", "float32", 0),  # just past the one-warp width
    ((2, 70000), "float32", "float32", 0),    # too wide for shared memory
])
def test_layer_norm_kernel_matches_plain(dev, shape, dtype, pdtype, offset):
    x, _, _ = _inputs(shape, dtype, dev)
    _, g, b = _inputs(shape, pdtype, dev)
    x = _offset(x, offset)
    before = ln.launches
    y, mean, rstd = ln.layer_norm_fwd(x, g, b)
    ry, rmean, rrstd = ln.layer_norm_fwd_reference(x, g, b)
    torch.cuda.synchronize()
    assert ln.launches == before + 1
    assert y.shape == x.shape and y.dtype == x.dtype
    torch.testing.assert_close(y.float(), ry.float(), **TOL[dtype])
    torch.testing.assert_close(mean, rmean, **STAT_TOL)
    torch.testing.assert_close(rstd, rrstd, **STAT_TOL)


def test_layer_norm_kernel_rejects_what_it_does_not_take(dev):
    x, g, b = _inputs((4, 64), "float32", dev)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd(x.t(), g[:4], b[:4])
    with pytest.raises(TypeError, match="dtype"):
        ln.layer_norm_fwd(x.half(), g, b)
    with pytest.raises(ValueError, match="shape"):
        ln.layer_norm_fwd(x, g[:3], b)
    with pytest.raises(ValueError, match="cpu"):
        ln.layer_norm_fwd(x, g.cpu(), b)
    y, mean, rstd = ln.layer_norm_fwd(x[:0], g, b)
    assert y.shape == (0, 64) and mean.shape == (0,)


@pytest.mark.parametrize("shape,dtype", [
    ((2048, 768), "float32"),     # BERT-base training batch, B=16 T=128
    ((2048, 768), "bfloat16"),
    ((1000, 100), "float32"),     # ragged: two warps a row
    ((3, 4096), "bfloat16"),      # one row a block
    ((5, 20000), "float32"),      # too wide for shared memory: re-reads
])
def test_layer_norm_bwd_kernel_matches_plain(dev, shape, dtype):
    x, gamma, beta = _inputs(shape, dtype, dev, seed=1)
    gamma = gamma.float()
    g = (torch.randn(shape, generator=torch.Generator().manual_seed(2))
         .to(dev, x.dtype))
    _, mean, rstd = ln.layer_norm_fwd_reference(x, gamma, beta)
    before = ln.bwd_launches
    dx, dg, db = ln.layer_norm_bwd(x, g, gamma, mean, rstd)
    rdx, rdg, rdb = ln.layer_norm_bwd_reference(x, g, gamma, mean, rstd)
    torch.cuda.synchronize()
    assert ln.bwd_launches == before + 1
    assert dx.dtype == x.dtype and dg.dtype == db.dtype == torch.float32
    tol = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}[dtype]
    torch.testing.assert_close(dx.float(), rdx.float(), **tol)
    for got, want in ((dg, rdg), (db, rdb)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _xent_inputs(shape, dtype, dev, seed=0):
    n, c = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 3).to(dev, getattr(torch, dtype))
    labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
    labels[0] = -1
    labels[-1] = c + 5
    g = torch.randn(n, generator=gen)
    return x, labels.to(dev), g.to(dev)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((2048, 30522), "float32", 0),   # BERT-base MLM head, B=16 T=128
    ((2048, 30522), "bfloat16", 0),
    ((2048, 30522), "float32", 1),   # logits one element off 16 bytes
    ((16, 2), "float32", 0),         # NSP head
    ((1000, 100), "float32", 0),
    ((3, 16385), "float32", 0),      # past the TPU kernel's width limit
    ((1120, 10000), "float32", 0),   # the LSTM LM's logits, T=35 B=32
    ((1120, 10000), "bfloat16", 0),
    ((7, 10001), "bfloat16", 0),     # odd rows start off 16 bytes
])
def test_softmax_xent_kernels_match_plain(dev, shape, dtype, offset):
    x, labels, g = _xent_inputs(shape, dtype, dev)
    x = _offset(x, offset)
    before = (sx.fwd_launches, sx.bwd_launches)
    loss, lse = sx.softmax_xent_fwd(x, labels)
    dx = sx.softmax_xent_bwd(x, labels, lse, g)
    rloss, rlse = sx.softmax_xent_fwd_reference(x, labels)
    rdx = sx.softmax_xent_bwd_reference(x, labels, rlse, g)
    torch.cuda.synchronize()
    assert (sx.fwd_launches, sx.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=8e-3, atol=1e-6))
    torch.testing.assert_close(dx.float(), rdx.float(), **tol)


def _far_below_zero(x, variant):
    """``x - 100``, or ``x`` with the first half of every odd row's
    columns at -1e4 and row 2 at -1e9: logits whose exp underflows."""
    if variant == "x - 100":
        return x - 100
    x = x.clone()
    x[1::2, :x.shape[1] // 2] = -1e4
    x[2] = -1e9
    return x


@pytest.mark.parametrize("variant", ["x - 100", "masked"])
@pytest.mark.parametrize("shape,dtype", [
    ((1120, 10000), "float32"), ((1120, 10000), "bfloat16"),
    ((7, 10001), "float32"), ((7, 10001), "bfloat16")])
def test_softmax_xent_fwd_far_below_zero(dev, shape, dtype, variant):
    """The forward is shift-invariant: logits far below 0, where a
    thread's first values all lie below exp's range, give the plain
    version's loss and lse."""
    x, labels, _ = _xent_inputs(shape, dtype, dev, seed=5)
    x = _far_below_zero(x, variant)
    before = sx.fwd_launches
    loss, lse = sx.softmax_xent_fwd(x, labels)
    rloss, rlse = sx.softmax_xent_fwd_reference(x, labels)
    torch.cuda.synchronize()
    assert sx.fwd_launches == before + 1
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((1120, 10000), "float32"), ((1120, 10000), "bfloat16"),
    ((2048, 30522), "float32"), ((5, 1025), "float32")])
def test_softmax_xent_fwd_is_bit_for_bit_repeatable(dev, shape, dtype):
    """The wide kernel merges its threads' pairs in a fixed order, so two
    calls give the same bits."""
    x, labels, _ = _xent_inputs(shape, dtype, dev, seed=3)
    first, second = (sx.softmax_xent_fwd(x, labels) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_small_bert_gets_every_gradient_on_the_card(dev):
    """On the card, backward reaches every parameter through the
    LayerNorm and cross-entropy Functions (the kernels' outputs have a
    grad_fn), and a Trainer step leaves finite weights."""
    net = BERTModel(vocab_size=100, num_layers=2, units=64, hidden_size=128,
                    num_heads=4, max_length=16).initialize(
        device=dev, generator=torch.Generator().manual_seed(0))
    x, y_mlm, y_nsp = (torch.from_numpy(a).to(dev)
                       for a in synthetic_batch(4, 16, 100))
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    before = (ln.launches, ln.bwd_launches, sx.fwd_launches, sx.bwd_launches)
    with autograd.record():
        loss = pretraining_loss(net, SoftmaxCrossEntropyLoss(), x, y_mlm,
                                y_nsp)
    autograd.backward(loss)
    torch.cuda.synchronize()
    after = (ln.launches, ln.bwd_launches, sx.fwd_launches, sx.bwd_launches)
    assert [a - b for a, b in zip(after, before)] == [5, 5, 2, 2]
    for name, p in net.named_parameters():
        if name == "token_type_embed.weight":   # no token types passed
            assert p.grad is None
            continue
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
    trainer.step(4)
    assert all(torch.isfinite(p).all() for p in net.parameters())


@pytest.fixture
def no_tf32():
    """float32 stays float32 in cuBLAS and cuDNN while a test runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _fmm_inputs(m, k, n, dtype, dev, seed=0):
    """``(x, w, scale, bias, dy, ds1, ds2)`` made on the card from a
    seed: x and dy in ``dtype``, the rest float32 (w in ``dtype``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (rnd(m, k) * 0.5).to(dt)
    w = (rnd(k, n) * k ** -0.5).to(dt)
    scale = torch.rand(k, generator=g, device=dev) + 0.5
    bias = rnd(k) * 0.2
    dy = (rnd(m, n) * 0.1).to(dt)
    return x, w, scale, bias, dy, rnd(n) * 0.01, rnd(n) * 0.001


def _within(got, want, tol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _shift(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements past a
    fresh allocation: a start off 16 bytes, for the element-load paths."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


# the dx tiles' tolerance of the largest value of dx, dscale and dbias:
# float32 runs the 3xTF32 tiles, bfloat16 the bf16 ones
_DX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (200, 96, 72),       # ragged in every dimension
    (1024, 256, 64),     # narrow output: one column tile, half used
    (512, 64, 256),
    (12544, 64, 256),    # ResNet-50 stage 1 c3 at B=4
    (1568, 1024, 512),   # stage 4 c1 at B=32: dw split into many runs
])
def test_fused_matmul_bn_kernels_match_plain(dev, no_tf32, dtype, prologue,
                                             m, k, n):
    x, w, scale, bias, dy, ds1, ds2 = _fmm_inputs(m, k, n, dtype, dev)
    if not prologue:
        scale = bias = None
    tol = 1e-5 if dtype == "float32" else 2e-2
    before = (fb.fwd_launches, fb.dx_launches, fb.dw_launches)
    y, s1, s2 = fb.fused_matmul_bn_fwd(x, w, scale, bias)
    ry, rs1, rs2 = fb.matmul_bn_reference(x, w, scale, bias)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and s1.dtype == torch.float32
    for what, got, want in (("y", y, ry), ("s1", s1, rs1), ("s2", s2, rs2)):
        _within(got, want, tol, what)
    # the backward on the plain forward's y, so both see the same input
    args = (x, w, scale, bias, ry, dy, ds1, ds2)
    dx, dsc, dbi = fb.fused_matmul_bn_dx(*args)
    dw = fb.fused_matmul_bn_dw(*args)
    rdx, rdsc, rdbi = fb.matmul_bn_dx_reference(*args)
    rdw = fb.matmul_bn_dw_reference(*args)
    torch.cuda.synchronize()
    assert (fb.fwd_launches, fb.dx_launches, fb.dw_launches) == tuple(
        b + 1 for b in before)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _within(dx, rdx, tol, "dx")
    _within(dw, rdw, tol, "dw")
    if prologue:
        _within(dsc, rdsc, tol, "dscale")
        _within(dbi, rdbi, tol, "dbias")
    else:
        assert dsc is None and dbi is None


def test_fused_matmul_bn_rejects_what_it_does_not_take(dev):
    x, w, scale, bias, dy, ds1, ds2 = _fmm_inputs(64, 16, 8, "float32", dev)
    with pytest.raises(TypeError, match="dtype"):
        fb.fused_matmul_bn_fwd(x.half(), w.half())
    with pytest.raises(TypeError, match="w is"):
        fb.fused_matmul_bn_fwd(x, w.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        fb.fused_matmul_bn_fwd(x, w.t())
    with pytest.raises(ValueError, match="both"):
        fb.fused_matmul_bn_fwd(x, w, scale, None)
    with pytest.raises(ValueError, match="cpu"):
        fb.fused_matmul_bn_fwd(x, w.cpu())
    with pytest.raises(ValueError, match="shape"):
        fb.fused_matmul_bn_dx(x, w, scale, bias, dy[:3], dy, ds1, ds2)
    y, s1, s2 = fb.fused_matmul_bn_fwd(x[:0], w)
    assert y.shape == (0, 8) and s1.abs().sum() == 0


def _dw_args(m, k, n, dtype, dev, prologue=True, seed=3):
    x, w, scale, bias, dy, ds1, ds2 = _fmm_inputs(m, k, n, dtype, dev, seed)
    if not prologue:
        scale = bias = None
    y = fb.matmul_bn_reference(x, w, scale, bias)[0]
    return x, w, scale, bias, y, dy, ds1, ds2


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_matmul_bn_dw_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 12's 3xTF32 tensor-core tile
    (fused_matmul_bn_dw_tf32); bfloat16 its bf16 tensor-core tile
    (fused_matmul_bn_dw_mma), as the profiler sees."""
    from torch.profiler import ProfilerActivity, profile
    args = _dw_args(200, 96, 72, dtype, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fb.fused_matmul_bn_dw(*args)
        torch.cuda.synchronize()
    hits = {e.name for e in prof.events() if "fused_matmul_bn" in e.name}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_matmul_bn_dw" in name, name
    assert ("fused_matmul_bn_dw_mma" in name) == (route == "tensor-core"), name
    assert ("fused_matmul_bn_dw_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 96, 72), (12544, 64, 256),
                                   (1000, 60, 100)])
def test_fused_matmul_bn_dw_is_bit_for_bit_repeatable(dev, dtype, m, k, n):
    """No atomics: the runs of M write float32 partials that the wrapper
    sums in a fixed order, so two calls give the same bits."""
    args = _dw_args(m, k, n, dtype, dev)
    first, second = (fb.fused_matmul_bn_dw(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n,offset", [
    (1000, 60, 100, 0),   # K and N not multiples of 8
    (77, 9, 130, 0),      # K under one 16-byte chunk
    (640, 64, 256, 1),    # rows of 8 elements, starts off 16 bytes
])
def test_fused_matmul_bn_dw_mma_loads_element_wise(dev, no_tf32, prologue, m,
                                                   k, n, offset):
    """Where a start or a row width does not allow 16-byte loads, the
    bfloat16 tile loads element by element and still matches the plain
    version within the bfloat16 tolerance (2e-2 of max|dw|)."""
    x, w, scale, bias, y, dy, ds1, ds2 = _dw_args(m, k, n, "bfloat16", dev,
                                                  prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert not (fb._vec16(x) and fb._vec16(y, dy))
    got = fb.fused_matmul_bn_dw(x, w, scale, bias, y, dy, ds1, ds2)
    want = fb.matmul_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    _within(got, want, 2e-2, "dw")


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n,offset", [
    (1000, 62, 100, 0),   # K not a multiple of 4
    (77, 3, 130, 0),      # K under one 16-byte chunk
    (200, 96, 70, 0),     # N not a multiple of 4
    (640, 64, 256, 1),    # rows of 4 elements, starts off 16 bytes
    (401408, 64, 256, 0),  # the representative launch: 16-byte loads
])
def test_fused_matmul_bn_dw_tf32_matches_plain(dev, no_tf32, prologue, m, k,
                                               n, offset):
    """The float32 tile, with 16-byte loads and where a start or a row
    width makes it load element by element, matches the plain version
    within the float32 tolerance (1e-5 of max|dw|), two runs bit for
    bit."""
    x, w, scale, bias, y, dy, ds1, ds2 = _dw_args(m, k, n, "float32", dev,
                                                  prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    vec = fb._vec16(x) and fb._vec16(y, dy)
    assert vec == (m == 401408)
    got = fb.fused_matmul_bn_dw(x, w, scale, bias, y, dy, ds1, ds2)
    again = fb.fused_matmul_bn_dw(x, w, scale, bias, y, dy, ds1, ds2)
    want = fb.matmul_bn_dw_reference(x, w, scale, bias, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    _within(got, want, 1e-5, "dw")
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_matmul_bn_dx_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 11's 3xTF32 tensor-core tile
    (fused_matmul_bn_dx_tf32); bfloat16 its bf16 tensor-core tile
    (fused_matmul_bn_dx_mma), as the profiler sees."""
    args = _dw_args(200, 96, 72, dtype, dev)
    hits = {n for n in _kernel_names(fb.fused_matmul_bn_dx, args)
            if "fused_matmul_bn" in n}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_matmul_bn_dx" in name, name
    assert ("fused_matmul_bn_dx_mma" in name) == (route == "tensor-core"), name
    assert ("fused_matmul_bn_dx_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 96, 72), (12544, 64, 256),
                                   (1000, 60, 100), (1568, 1024, 512)])
def test_fused_matmul_bn_dx_is_bit_for_bit_repeatable(dev, dtype, m, k, n):
    """No atomics: each block of 128 rows writes its float32 partial row
    of dscale and dbias, which the wrapper sums in a fixed order, so two
    calls give the same bits."""
    args = _dw_args(m, k, n, dtype, dev)
    first, second = (fb.fused_matmul_bn_dx(*args) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype,m,k,n,offset,vec", [
    ("float32", 1000, 62, 100, 0, False),   # K not a multiple of 4
    ("float32", 77, 3, 130, 0, False),      # K under one 16-byte chunk
    ("float32", 200, 96, 70, 0, False),     # N not a multiple of 4
    ("float32", 640, 64, 256, 1, False),    # starts off 16 bytes
    ("float32", 33, 200, 40, 0, True),      # four column tiles, one ragged
    ("float32", 401408, 64, 256, 0, True),  # the representative launch
    ("bfloat16", 1000, 60, 100, 0, False),  # K and N not multiples of 8
    ("bfloat16", 77, 9, 130, 0, False),     # K under one 16-byte chunk
    ("bfloat16", 640, 64, 256, 1, False),   # starts off 16 bytes
    ("bfloat16", 33, 200, 40, 0, True),     # two column tiles, one ragged
])
def test_fused_matmul_bn_dx_mma_loads_element_wise(dev, no_tf32, prologue,
                                                   dtype, m, k, n, offset,
                                                   vec):
    """Where a start or a row width does not allow 16-byte loads (``vec``
    false), the dx tile of each dtype loads element by element; there
    and with 16-byte loads it matches the plain version within
    ``_DX_TOL``, two runs bit for bit."""
    x, w, scale, bias, y, dy, ds1, ds2 = _dw_args(m, k, n, dtype, dev,
                                                  prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert (fb._vec16(x) and fb._vec16(y, dy) and fb._vec16(w)) == vec
    args = (x, w, scale, bias, y, dy, ds1, ds2)
    got = fb.fused_matmul_bn_dx(*args)
    again = fb.fused_matmul_bn_dx(*args)
    want = fb.matmul_bn_dx_reference(*args)
    torch.cuda.synchronize()
    for what, g, a, r in zip(("dx", "dscale", "dbias"), got, again, want):
        if r is None:
            assert g is None and a is None
        else:
            _within(g, r, _DX_TOL[dtype], what)
            assert torch.equal(g, a), what


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_matmul_bn_fwd_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 10's 3xTF32 tensor-core tile
    (fused_matmul_bn_fwd_tf32); bfloat16 its bf16 tensor-core tile
    (fused_matmul_bn_fwd_mma), as the profiler sees."""
    x, w, scale, bias = _fmm_inputs(200, 96, 72, dtype, dev)[:4]
    hits = {n for n in _kernel_names(fb.fused_matmul_bn_fwd,
                                     (x, w, scale, bias))
            if "fused_matmul_bn" in n}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_matmul_bn_fwd" in name, name
    assert ("fused_matmul_bn_fwd_mma" in name) == (route == "tensor-core"), name
    assert ("fused_matmul_bn_fwd_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 96, 72), (12544, 64, 256),
                                   (1000, 60, 100), (1568, 1024, 512)])
def test_fused_matmul_bn_fwd_is_bit_for_bit_repeatable(dev, dtype, m, k, n):
    """No atomics: the sums of y and y² are float32 partial rows (one a
    run of row blocks in either dtype) that the wrapper sums in a fixed
    order, so two calls give the same bits."""
    args = _fmm_inputs(m, k, n, dtype, dev)[:4]
    first, second = (fb.fused_matmul_bn_fwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype,m,k,n,offset,vec", [
    ("float32", 1000, 62, 100, 0, False),    # K not a multiple of 4
    ("float32", 77, 3, 130, 0, False),       # K under one 16-byte chunk
    ("float32", 200, 96, 70, 0, False),      # N not a multiple of 4
    ("float32", 640, 64, 256, 1, False),     # starts off 16 bytes
    ("float32", 33, 200, 40, 0, True),       # K in 13 stages, the last
                                             # ragged
    ("float32", 1568, 1024, 512, 0, True),   # w streamed, 8 column tiles
    ("float32", 401408, 64, 256, 0, True),   # the representative launch
    ("bfloat16", 1000, 60, 100, 0, False),   # K and N not multiples of 8
    ("bfloat16", 77, 9, 130, 0, False),      # K under one 16-byte chunk
    ("bfloat16", 640, 64, 256, 1, False),    # starts off 16 bytes
    ("bfloat16", 33, 200, 40, 0, True),      # K in seven steps of 32, the
                                             # last ragged
])
def test_fused_matmul_bn_fwd_mma_loads_element_wise(dev, no_tf32, prologue,
                                                    dtype, m, k, n, offset,
                                                    vec):
    """Where a start or a row width does not allow 16-byte loads (``vec``
    false), the forward tile of each dtype loads element by element;
    there, with 16-byte loads, and where K streams in several steps, it
    matches the plain version within ``_DX_TOL`` (float32 1e-5, bfloat16
    2e-2 of the largest value of y, s1, s2), two runs bit for bit."""
    x, w, scale, bias = _fmm_inputs(m, k, n, dtype, dev)[:4]
    if not prologue:
        scale = bias = None
    if offset:
        x = _shift(x, offset)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert (fb._vec16(x) and fb._vec16(w)) == vec
    got = fb.fused_matmul_bn_fwd(x, w, scale, bias)
    again = fb.fused_matmul_bn_fwd(x, w, scale, bias)
    want = fb.matmul_bn_reference(x, w, scale, bias)
    torch.cuda.synchronize()
    for what, g, a, r in zip(("y", "s1", "s2"), got, again, want):
        _within(g, r, _DX_TOL[dtype], what)
        assert torch.equal(g, a), what


def test_small_fused_resnet_step_on_the_card_matches_cpu(dev, no_tf32):
    """A fused ResNet (one bottleneck a stage, each with a projection)
    on the card against the same weights and batch on the CPU: 12 launches
    of each fused kernel (c1, c3 and the projection of each block), the
    loss and every gradient."""
    cpu = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, layout="NHWC", fused=True).initialize(
        device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.int32))
    out = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        before = (fb.fwd_launches, fb.dx_launches, fb.dw_launches)
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(x.to(where)), y.to(where))
        autograd.backward(loss)
        launched = [a - b for a, b in zip(
            (fb.fwd_launches, fb.dx_launches, fb.dw_launches), before)]
        out.append((loss.mean().item(), grads_to_numpy(net), launched))
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = out
    assert n_cpu == [0, 0, 0] and n_card == [12, 12, 12]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), (l_card, l_cpu)
    for name, want in g_cpu.items():
        err = np.abs(g_card[name] - want).max()
        assert err <= 1e-3 * np.abs(want).max(), (name, err)


def _conv_inputs(n, h, w, c, co, dtype, dev, seed=0):
    """``(x, w, scale, bias, dy, ds1, ds2)`` for the fused 3x3, made on the
    card from a seed: x, w and dy in ``dtype``, the rest float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (rnd(n, h, w, c) * 0.5).to(dt)
    k = (rnd(3, 3, c, co) * (9 * c) ** -0.5).to(dt)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = rnd(c) * 0.2
    dy = (rnd(n, h, w, co) * 0.1).to(dt)
    return x, k, scale, bias, dy, rnd(co) * 0.01, rnd(co) * 0.001


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("n,h,w,c,co", [
    (2, 5, 9, 16, 8),       # non-square, ragged in every dimension
    (3, 6, 6, 16, 16),      # images smaller than a block of rows
    (16, 6, 6, 16, 260),    # the JAX package's multi-N-block geometry
    (4, 56, 56, 64, 64),    # ResNet-50 stage 1 at B=4
    (8, 7, 7, 512, 512),    # stage 4 at B=8: dw split into many runs
])
def test_fused_conv3_bn_kernels_match_plain(dev, no_tf32, dtype, prologue,
                                            n, h, w, c, co):
    x, k, scale, bias, dy, ds1, ds2 = _conv_inputs(n, h, w, c, co, dtype, dev)
    if not prologue:
        scale = bias = None
    tol = 1e-5 if dtype == "float32" else 2e-2
    before = (fc.fwd_launches, fc.dx_launches, fc.dw_launches)
    y, s1, s2 = fc.fused_conv3_bn_fwd(x, k, scale, bias)
    ry, rs1, rs2 = fc.conv3_bn_reference(x, k, scale, bias)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and s1.dtype == torch.float32
    for what, got, want in (("y", y, ry), ("s1", s1, rs1), ("s2", s2, rs2)):
        _within(got, want, tol, what)
    # the backward on the plain forward's y, so both see the same input
    args = (x, k, scale, bias, ry, dy, ds1, ds2)
    dx, dsc, dbi = fc.fused_conv3_bn_dx(*args)
    dw = fc.fused_conv3_bn_dw(*args)
    rdx, rdsc, rdbi = fc.conv3_bn_dx_reference(*args)
    rdw = fc.conv3_bn_dw_reference(*args)
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.dx_launches, fc.dw_launches) == tuple(
        b + 1 for b in before)
    assert dx.dtype == x.dtype and dw.dtype == k.dtype
    _within(dx, rdx, tol, "dx")
    _within(dw, rdw, tol, "dw")
    if prologue:
        _within(dsc, rdsc, tol, "dscale")
        _within(dbi, rdbi, tol, "dbias")
    else:
        assert dsc.abs().sum() == 0 and dbi.abs().sum() == 0


def test_fused_conv3_bn_pads_the_normalized_input(dev, no_tf32):
    """With a positive bias an out-of-image neighbour must read 0, not
    relu(bias): a zero input and a prologue of relu(0 * 1 + 1) = 1
    give y = the sum of the in-image taps, smaller at the borders."""
    x = torch.zeros(1, 4, 4, 1, device=dev)
    k = torch.ones(3, 3, 1, 1, device=dev)
    one = torch.ones(1, device=dev)
    y, _, _ = fc.fused_conv3_bn_fwd(x, k, one, one)
    want = torch.tensor([[4., 6, 6, 4], [6, 9, 9, 6], [6, 9, 9, 6],
                         [4, 6, 6, 4]], device=dev)
    assert torch.equal(y[0, :, :, 0], want)


def test_fused_conv3_bn_rejects_what_it_does_not_take(dev):
    x, k, scale, bias, dy, ds1, ds2 = _conv_inputs(2, 4, 4, 8, 8, "float32",
                                                   dev)
    with pytest.raises(TypeError, match="dtype"):
        fc.fused_conv3_bn_fwd(x.half(), k.half())
    with pytest.raises(TypeError, match="w is"):
        fc.fused_conv3_bn_fwd(x, k.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        fc.fused_conv3_bn_fwd(x, k[:, :, :4])
    with pytest.raises(ValueError, match="both"):
        fc.fused_conv3_bn_fwd(x, k, scale, None)
    with pytest.raises(ValueError, match="cpu"):
        fc.fused_conv3_bn_fwd(x, k.cpu())
    with pytest.raises(ValueError, match="shape"):
        fc.fused_conv3_bn_dx(x, k, scale, bias, dy[:1], dy, ds1, ds2)
    y, s1, s2 = fc.fused_conv3_bn_fwd(x[:0], k)
    assert y.shape == (0, 4, 4, 8) and s1.abs().sum() == 0


def _kernel_names(fn, args, tries=4):
    """The device kernels three calls of ``fn`` run, by name, from the
    profiler's trace after one untraced call; a trace with no device
    event at all is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    return set()


def _conv_dw_args(n, h, w, c, co, dtype, dev, prologue=True, seed=3):
    x, k, scale, bias, dy, ds1, ds2 = _conv_inputs(n, h, w, c, co, dtype,
                                                   dev, seed)
    if not prologue:
        scale = bias = None
    y = fc.conv3_bn_reference(x, k, scale, bias)[0]
    return x, k, scale, bias, y, dy, ds1, ds2


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_conv3_bn_dw_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 16's 3xTF32 tensor-core tile
    (fused_conv3_bn_dw_tf32); bfloat16 its bf16 tensor-core tile
    (fused_conv3_bn_dw_mma), as the profiler sees."""
    args = _conv_dw_args(2, 5, 9, 16, 8, dtype, dev)
    hits = {n for n in _kernel_names(fc.fused_conv3_bn_dw, args)
            if "fused_conv3_bn" in n}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_conv3_bn_dw" in name, name
    assert ("fused_conv3_bn_dw_mma" in name) == (route == "tensor-core"), name
    assert ("fused_conv3_bn_dw_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("n,h,w,c,co,offset", [
    (2, 5, 9, 12, 20, 0),     # C and C_out not multiples of 8
    (3, 6, 6, 16, 13, 0),     # C_out under two 16-byte chunks
    (2, 7, 7, 5, 64, 0),      # C under one 16-byte chunk
    (4, 14, 14, 64, 64, 1),   # rows of 8 elements, starts off 16 bytes
    (1, 3, 130, 8, 8, 0),     # an image row in three segments
])
def test_fused_conv3_bn_dw_mma_loads_element_wise(dev, no_tf32, prologue, n,
                                                  h, w, c, co, offset):
    """Where a start or a channel count does not allow 16-byte loads, the
    bfloat16 tile loads element by element and still matches the plain
    version within the bfloat16 tolerance (2e-2 of max|dw|)."""
    x, k, scale, bias, y, dy, ds1, ds2 = _conv_dw_args(n, h, w, c, co,
                                                       "bfloat16", dev,
                                                       prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert w > 62 or not (fb._vec16(x) and fb._vec16(y, dy))
    got = fc.fused_conv3_bn_dw(x, k, scale, bias, y, dy, ds1, ds2)
    want = fc.conv3_bn_dw_reference(x, k, scale, bias, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    _within(got, want, 2e-2, "dw")


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("n,h,w,c,co,offset", [
    (2, 5, 9, 6, 20, 0),      # C not a multiple of 4
    (3, 6, 6, 16, 13, 0),     # C_out not a multiple of 4
    (2, 7, 7, 3, 64, 0),      # C under one 16-byte chunk
    (4, 14, 14, 64, 64, 1),   # rows of 4 elements, starts off 16 bytes
    (1, 3, 130, 8, 8, 0),     # an image row in three segments
    (16, 6, 6, 16, 260, 0),   # C_out in five tiles (the TPU's kernel 15)
    (128, 56, 56, 64, 64, 0),  # the representative launch
])
def test_fused_conv3_bn_dw_tf32_matches_plain(dev, no_tf32, prologue, n, h,
                                              w, c, co, offset):
    """The float32 tile, with 16-byte loads and where a start or a
    channel count makes it load element by element, matches the plain
    version within the float32 tolerance (1e-5 of max|dw|), two runs bit
    for bit."""
    x, k, scale, bias, y, dy, ds1, ds2 = _conv_dw_args(n, h, w, c, co,
                                                       "float32", dev,
                                                       prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = fc.fused_conv3_bn_dw(x, k, scale, bias, y, dy, ds1, ds2)
    again = fc.fused_conv3_bn_dw(x, k, scale, bias, y, dy, ds1, ds2)
    want = fc.conv3_bn_dw_reference(x, k, scale, bias, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    _within(got, want, 1e-5, "dw")
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 5, 9, 16, 8), (16, 6, 6, 16, 260),
                                        (8, 56, 56, 64, 64),
                                        (8, 7, 7, 512, 512)])
def test_fused_conv3_bn_dw_is_bit_for_bit_repeatable(dev, dtype, n, h, w, c,
                                                     co):
    """No atomics: the runs write float32 partials that the wrapper sums
    in a fixed order, so two calls give the same bits."""
    args = _conv_dw_args(n, h, w, c, co, dtype, dev)
    first, second = (fc.fused_conv3_bn_dw(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_conv3_bn_fwd_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 13's 3xTF32 tensor-core tile
    (fused_conv3_bn_fwd_tf32); bfloat16 its bf16 tensor-core tile
    (fused_conv3_bn_fwd_mma), as the profiler sees."""
    x, k, scale, bias = _conv_inputs(2, 5, 9, 16, 8, dtype, dev)[:4]
    hits = {n for n in _kernel_names(fc.fused_conv3_bn_fwd,
                                     (x, k, scale, bias))
            if "fused_conv3_bn" in n}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_conv3_bn_fwd" in name, name
    assert ("fused_conv3_bn_fwd_mma" in name) == (route == "tensor-core"), name
    assert ("fused_conv3_bn_fwd_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype,n,h,w,c,co,offset,vec", [
    ("float32", 2, 5, 9, 6, 20, 0, False),      # C not a multiple of 4
    ("float32", 3, 6, 6, 16, 13, 0, False),     # C_out not a multiple of 4
    ("float32", 2, 7, 7, 3, 64, 0, False),      # C under one 16-byte chunk
    ("float32", 4, 14, 14, 64, 64, 1, False),   # starts off 16 bytes
    ("float32", 1, 3, 130, 8, 8, 0, True),      # a row in three segments
    ("float32", 1, 2, 70, 72, 24, 0, True),     # C > 64: in chunks of 32
    ("float32", 2, 6, 6, 80, 200, 0, True),     # and C_out in four tiles
    ("float32", 16, 6, 6, 16, 260, 0, True),    # C_out in five tiles
    ("float32", 128, 56, 56, 64, 64, 0, True),  # the representative launch
    ("bfloat16", 2, 5, 9, 12, 20, 0, False),    # C and C_out not multiples
                                                # of 8
    ("bfloat16", 3, 6, 6, 16, 13, 0, False),    # C_out under two chunks
    ("bfloat16", 2, 7, 7, 5, 64, 0, False),     # C under one 16-byte chunk
    ("bfloat16", 4, 14, 14, 64, 64, 1, False),  # starts off 16 bytes
    ("bfloat16", 1, 3, 130, 8, 8, 0, True),     # a row in three segments
    ("bfloat16", 1, 2, 70, 72, 24, 0, True),    # C > 64: in chunks of 32
    ("bfloat16", 2, 6, 6, 80, 200, 0, True),    # and C_out in two tiles
])
def test_fused_conv3_bn_fwd_mma_loads_element_wise(dev, no_tf32, prologue,
                                                   dtype, n, h, w, c, co,
                                                   offset, vec):
    """Where a start or a channel count does not allow 16-byte loads
    (``vec`` false), the forward tile of each dtype loads element by
    element; there, with 16-byte loads, and where rows take several
    segments or C and C_out several chunks and tiles, it matches the
    plain version within ``_DX_TOL`` (float32 1e-5, bfloat16 2e-2 of the
    largest value of y, s1, s2), two runs bit for bit."""
    x, k, scale, bias = _conv_inputs(n, h, w, c, co, dtype, dev)[:4]
    if not prologue:
        scale = bias = None
    if offset:
        x = _shift(x, offset)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert (fb._vec16(x) and fb._vec16(k)) == vec
    got = fc.fused_conv3_bn_fwd(x, k, scale, bias)
    again = fc.fused_conv3_bn_fwd(x, k, scale, bias)
    want = fc.conv3_bn_reference(x, k, scale, bias)
    torch.cuda.synchronize()
    for what, g, a, r in zip(("y", "s1", "s2"), got, again, want):
        _within(g, r, _DX_TOL[dtype], what)
        assert torch.equal(g, a), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 5, 9, 16, 8), (16, 6, 6, 16, 260),
                                        (8, 56, 56, 64, 64),
                                        (8, 7, 7, 512, 512)])
def test_fused_conv3_bn_fwd_is_bit_for_bit_repeatable(dev, dtype, n, h, w, c,
                                                      co):
    """No atomics: the sums of y and y² are float32 partial rows (one a
    run of stages in either dtype) that the wrapper sums in a fixed
    order, so two calls give the same bits."""
    args = _conv_inputs(n, h, w, c, co, dtype, dev)[:4]
    first, second = (fc.fused_conv3_bn_fwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,route", [("float32", "3xTF32"),
                                         ("bfloat16", "tensor-core")])
def test_fused_conv3_bn_dx_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run kernel 14's 3xTF32 tensor-core tile
    (fused_conv3_bn_dx_tf32); bfloat16 its bf16 tensor-core tile
    (fused_conv3_bn_dx_mma), as the profiler sees."""
    args = _conv_dw_args(2, 5, 9, 16, 8, dtype, dev)
    hits = {n for n in _kernel_names(fc.fused_conv3_bn_dx, args)
            if "fused_conv3_bn" in n}
    assert len(hits) == 1, hits
    name, = hits
    assert "fused_conv3_bn_dx" in name, name
    assert ("fused_conv3_bn_dx_mma" in name) == (route == "tensor-core"), name
    assert ("fused_conv3_bn_dx_tf32" in name) == (route == "3xTF32"), name


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype,n,h,w,c,co,offset,vec", [
    ("float32", 2, 5, 9, 6, 20, 0, False),      # C not a multiple of 4
    ("float32", 3, 6, 6, 16, 13, 0, False),     # C_out not a multiple of 4
    ("float32", 2, 7, 7, 3, 64, 0, False),      # C under one 16-byte chunk
    ("float32", 4, 14, 14, 64, 64, 1, False),   # starts off 16 bytes
    ("float32", 1, 3, 130, 8, 8, 0, True),      # a row in three segments
    ("float32", 1, 2, 70, 24, 72, 0, True),     # C_out > 64: in chunks
    ("float32", 2, 6, 6, 200, 80, 0, True),     # and C in four tiles of 64
    ("float32", 16, 6, 6, 16, 260, 0, True),    # C_out in nine chunks (the
                                                # TPU's kernel 15)
    ("float32", 128, 56, 56, 64, 64, 0, True),  # the representative launch
    ("bfloat16", 2, 5, 9, 12, 20, 0, False),    # C and C_out not multiples
                                                # of 8
    ("bfloat16", 3, 6, 6, 16, 13, 0, False),    # C_out under two chunks
    ("bfloat16", 2, 7, 7, 5, 64, 0, False),     # C under one 16-byte chunk
    ("bfloat16", 4, 14, 14, 64, 64, 1, False),  # starts off 16 bytes
    ("bfloat16", 1, 3, 130, 8, 8, 0, True),     # a row in three segments
    ("bfloat16", 1, 2, 70, 24, 72, 0, True),    # C_out > 64: in chunks
    ("bfloat16", 2, 6, 6, 200, 80, 0, True),    # and C in two tiles of 128
])
def test_fused_conv3_bn_dx_mma_loads_element_wise(dev, no_tf32, prologue,
                                                  dtype, n, h, w, c, co,
                                                  offset, vec):
    """Where a start or a channel count does not allow 16-byte loads
    (``vec`` false), the dx tile of each dtype loads element by element;
    there, with 16-byte loads, and where rows take several segments or C
    and C_out several tiles and chunks, it matches the plain version
    within ``_DX_TOL``, two runs bit for bit."""
    x, k, scale, bias, y, dy, ds1, ds2 = _conv_dw_args(n, h, w, c, co,
                                                       dtype, dev, prologue)
    if offset:
        x, y, dy = (_shift(t, offset) for t in (x, y, dy))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert (fb._vec16(x) and fb._vec16(y, dy)) == vec
    args = (x, k, scale, bias, y, dy, ds1, ds2)
    got = fc.fused_conv3_bn_dx(*args)
    again = fc.fused_conv3_bn_dx(*args)
    want = fc.conv3_bn_dx_reference(*args)
    torch.cuda.synchronize()
    parts = ("dx", "dscale", "dbias") if prologue else ("dx",)
    for what, g, a, r in zip(parts, got, again, want):
        _within(g, r, _DX_TOL[dtype], what)
        assert torch.equal(g, a), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 5, 9, 16, 8), (16, 6, 6, 16, 260),
                                        (8, 56, 56, 64, 64),
                                        (8, 7, 7, 512, 512)])
def test_fused_conv3_bn_dx_is_bit_for_bit_repeatable(dev, dtype, n, h, w, c,
                                                     co):
    """No atomics: the sums of dz*x and dz are float32 partial rows (one a
    run of stages) that the wrapper sums in a fixed order, so two calls
    give the same bits."""
    args = _conv_dw_args(n, h, w, c, co, dtype, dev)
    first, second = (fc.fused_conv3_bn_dx(*args) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [
    ((2048, 768), "float32"), ((2048, 768), "bfloat16"),
    ((1000, 100), "float32"), ((3, 4096), "bfloat16"),
    ((5, 20000), "float32")])
def test_layer_norm_bwd_is_bit_for_bit_repeatable(dev, shape, dtype):
    """No atomics: the blocks' partial rows of dgamma and dbeta are
    summed by the file's second kernel in a fixed order, so two calls
    give the same bits."""
    x, gamma, beta = _inputs(shape, dtype, dev, seed=4)
    gamma = gamma.float()
    g = (torch.randn(shape, generator=torch.Generator().manual_seed(5))
         .to(dev, x.dtype))
    _, mean, rstd = ln.layer_norm_fwd_reference(x, gamma, beta)
    first, second = (ln.layer_norm_bwd(x, g, gamma, mean, rstd)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_step_replay_matches_eager(dev, no_tf32, dtype):
    """The small fused ResNet's ``FusedTrainStep``: 4 calls (an eager
    warm-up that captures the graph, then 3 replays) against 4 eager
    runs of the same step code from the same weights; the capture holds
    one step's launches (12 of each fused 1x1, 4 of each fused 3x3, one
    of each cross-entropy kernel)."""
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, layout="NHWC", fused=True).initialize(
        device=dev, generator=torch.Generator().manual_seed(0))
    if dtype == "bfloat16":
        amp.convert_block(net, "bfloat16")
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    graph = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                  dict(params), device=dev)
    eager = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                  dict(params), device=dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32)).to(
        dev, getattr(torch, dtype))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.int32)).to(dev)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        by_graph = [graph(x, y) for _ in range(4)]
        by_eager = [eager.step_fn(x, y) for _ in range(4)]
    finally:
        torch.backends.cudnn.deterministic = old
    (captured,) = graph.capture_launches.values()
    assert captured == {"fused_block.fwd_launches": 12,
                        "fused_block.dx_launches": 12,
                        "fused_block.dw_launches": 12,
                        "fused_conv.fwd_launches": 4,
                        "fused_conv.dx_launches": 4,
                        "fused_conv.dw_launches": 4,
                        "softmax_xent.fwd_launches": 1,
                        "softmax_xent.bwd_launches": 1}
    assert not eager._graphs
    for a, b in zip(by_graph, by_eager):
        assert a.dtype == b.dtype and torch.isfinite(a)
        _within(a, b, 1e-6, "loss")
    for name, want in {**eager.params, **eager.aux}.items():
        got = {**graph.params, **graph.aux}[name]
        assert got.dtype == want.dtype, name
        _within(got, want, 1e-6, name)
    for name, want in eager.opt_state["mom"].items():
        _within(graph.opt_state["mom"][name], want, 1e-6, "mom " + name)
    assert (graph.params["output.weight"] != net.output.weight).any()


def test_fused_train_step_refuses_dropout_on_the_card(dev):
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3), nn.Dropout(0.1))
    with pytest.raises(ValueError, match="Dropout"):
        make_fused_train_step(net.initialize(device=dev),
                              SoftmaxCrossEntropyLoss(), device=dev)


def _row_close(got, want, what, tol=1e-6, terms=0.0):
    """Kernels 3-5 and 8-9 against their plain versions: float32 ``tol``
    of the largest |want|, or of ``terms`` where larger; bfloat16 one
    bf16 ulp of each value more."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all() and torch.isfinite(want).all(), what
    scale = max(want.abs().max().item(), terms)
    bound = torch.full_like(want, tol * scale)
    if bf16:
        bound += torch.ldexp(torch.ones_like(want),
                             torch.frexp(want.abs())[1] - 8)
    assert ((got - want).abs() <= bound).all(), (
        what, ((got - want).abs() - bound).max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [
    (4096, 1024),      # the attention rows' width (T = 1024)
    (4096, 21),        # SSD's class axis (20 classes + background)
    (32 * 119276, 21),  # SSD.detections at B=32, ssd_300()'s anchors
    (4099, 21),        # a last tile of 3 rows
    # narrow rows: odd and even widths (skewed reads), 32 (the widest),
    # then 33 (the first one-warp row)
    (1000, 2), (1000, 10), (1000, 16), (1000, 20), (1000, 21), (1000, 31),
    (1000, 32), (1000, 33),
    (1000, 1), (1000, 7), (1000, 300), (100, 1000),   # ragged warp rows
    (8, 1025),         # just past the one-warp width
    (3, 16385),        # past the TPU kernel's width limit
    (2, 70000),        # a wide streamed row
])
def test_softmax_kernels_match_plain(dev, dtype, rows, cols):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 3).to(
        getattr(torch, dtype))
    x[0, max(1, cols // 2):] = float("-inf")  # a row the length mask cut
    gy = torch.randn(rows, cols, generator=g, device=dev).to(x.dtype)
    before = (sm.fwd_launches, sm.bwd_launches)
    y = sm.softmax_fwd(x)
    dx = sm.softmax_bwd(y, gy)
    ry = sm.softmax_fwd_reference(x)
    rdx = sm.softmax_bwd_reference(y, gy)
    torch.cuda.synchronize()
    assert (sm.fwd_launches, sm.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    _row_close(y, ry, "y")
    _row_close(dx, rdx, "dx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols,offset", [
    (4096, 21, 1), (1000, 32, 1), (1000, 21, 3), (5, 3, 1), (1, 2, 1)])
def test_softmax_fwd_narrow_rows_off_16_bytes(dev, dtype, rows, cols,
                                              offset):
    """x ``offset`` elements past 16 bytes (y starts on them): every tile
    starts off its 16-byte pieces, and y is staged at another offset
    than x; down to tiles shorter than one piece."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 3).to(
        getattr(torch, dtype))
    x = _offset(x, offset)
    before = sm.fwd_launches
    y = sm.softmax_fwd(x)
    ry = sm.softmax_fwd_reference(x)
    torch.cuda.synchronize()
    assert sm.fwd_launches == before + 1
    _row_close(y, ry, "y")


@pytest.mark.parametrize("variant", ["", "float32 gamma", "x offset 1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [
    (32768, 512),      # the TransformerLM's rows, B=32 T=1024
    (1000, 7), (10, 300), (6, 129), (100, 1000),
    (64, 768),         # BERT's width: 6 float32 or 3 bf16 chunks a lane
    (64, 1001),        # no multiple of a chunk: single values
    (64, 1025),        # just past the one-warp width
    (3, 16385), (2, 70000),
])
def test_rms_norm_kernels_match_plain(dev, dtype, rows, cols, variant):
    """Kernels 8 and 9 against their plain versions; also with a float32
    gamma (dgamma then comes out in float32) and with x off 16 bytes
    (element loads)."""
    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, dtype)
    gdt = torch.float32 if variant == "float32 gamma" else dt
    x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 0.3).to(dt)
    gamma = (torch.rand(cols, generator=g, device=dev) + 0.5).to(gdt)
    gy = torch.randn(rows, cols, generator=g, device=dev).to(dt)
    x = _offset(x, 1 if variant == "x offset 1" else 0)
    before = (rn.fwd_launches, rn.bwd_launches)
    y, rrms = rn.rms_norm_fwd(x, gamma)
    dx, dgamma = rn.rms_norm_bwd(x, gy, gamma, rrms)
    ry, rrrms = rn.rms_norm_fwd_reference(x, gamma)
    rdx, rdgamma = rn.rms_norm_bwd_reference(x, gy, gamma, rrrms)
    torch.cuda.synchronize()
    assert (rn.fwd_launches, rn.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    _row_close(y, ry, "y")
    _row_close(rrms, rrrms, "rrms")
    _row_close(dx, rdx, "dx")
    _row_close(dgamma, rdgamma, "dgamma")


@pytest.mark.parametrize("rows,cols,dtype", [
    (32768, 512, "bfloat16"), (32768, 512, "float32"), (1000, 1024, "float32"),
    (100, 1001, "bfloat16"), (5, 20000, "float32")])
def test_rms_norm_bwd_is_bit_for_bit_repeatable(dev, rows, cols, dtype):
    """No atomics: the blocks' partial rows of dgamma are summed by the
    file's second kernel in a fixed order, so two calls give the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 0.3).to(dt)
    gamma = (torch.rand(cols, generator=g, device=dev) + 0.5).to(dt)
    gy = torch.randn(rows, cols, generator=g, device=dev).to(dt)
    rrms = rn.rms_norm_fwd_reference(x, gamma)[1]
    first, second = (rn.rms_norm_bwd(x, gy, gamma, rrms) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_small_transformer_step_on_the_card_matches_cpu(dev, no_tf32):
    """The example's --smoke config (2 layers), one SGD step on the card
    against the same step on the CPU, with each new kernel's launches."""
    _small_transformer_step(dev, "gspmd", [2, 2, 5, 5, 1, 1, 0, 0, 0])


def test_small_flash_transformer_step_on_the_card_matches_cpu(dev, no_tf32):
    """The same with ``attention="flash"``: the flash kernels in place of
    the softmax kernels, two of each a step."""
    _small_transformer_step(dev, "flash", [0, 0, 5, 5, 1, 1, 2, 2, 2])


def _small_transformer_step(dev, attention, want_launches):
    from incubator_mxnet_tpu_torch.examples.train_transformer_lm import (
        config)
    cfg, batch, seq = config(smoke=True, attention=attention)
    cpu = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1))
    got = {}
    for where, model in (("cpu", cpu), ("card", card)):
        params = list(model.parameters())
        before = _tf_launches()
        loss = model.loss(tokens.to(params[0].device))
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        got[where] = (loss.item(), [g.cpu() for g in grads],
                      [a - b for a, b in zip(_tf_launches(), before)])
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = got["cpu"], got["card"]
    assert n_cpu == [0] * 9 and n_card == want_launches
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for (name, _), a, b in zip(cpu.named_parameters(), g_card, g_cpu):
        _within(a, b, 1e-4, name)
    step = card.make_train_step()
    losses = [step(tokens.to(dev)).item() for _ in range(3)]
    assert all(abs(v - l_card) < 0.5 for v in losses)


def _tf_launches():
    return (sm.fwd_launches, sm.bwd_launches, rn.fwd_launches,
            rn.bwd_launches, sx.fwd_launches, sx.bwd_launches,
            fa.fwd_launches, fa.bwd_dkdv_launches, fa.bwd_dq_launches)


# kernel 5 and its backward: the same float32 products summed in another
# order over up to 1025 keys
FLASH_TOL = 1e-5


def _bthd(b, h, t, d, dtype, dev, gen, mul=1.0):
    """(B, H, T, D) as the model's heads are: a transposed view of a
    (B, T, H, D) tensor."""
    x = torch.randn(b, t, h, d, generator=gen, device=dev) * mul
    return x.to(dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,tq,tk,d,causal", [
    (1, 1, 1, 1, 64, True), (2, 3, 64, 64, 32, False),
    (1, 2, 70, 150, 32, False), (1, 2, 70, 150, 32, True),
    (1, 2, 150, 70, 32, True), (2, 2, 200, 200, 64, True),
    (1, 1, 1025, 1025, 64, True),          # the TransformerLM's T
    (1, 2, 130, 130, 16, True), (1, 2, 130, 130, 128, False),
    (1, 1, 65, 65, 1, True),
    (1, 2, 130, 130, 40, True),            # D a multiple of 8, not of 16
    (1, 2, 150, 70, 72, False)])
def test_flash_attention_kernels_match_plain(dev, no_tf32, dtype, b, h, tq,
                                             tk, d, causal):
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    q = _bthd(b, h, tq, d, dt, dev, gen, 0.5)
    k = _bthd(b, h, tk, d, dt, dev, gen, 0.5)
    v = _bthd(b, h, tk, d, dt, dev, gen)
    g = _bthd(b, h, tq, d, dt, dev, gen)
    _check_flash(q, k, v, g, causal)


def _check_flash(q, k, v, g, causal):
    """Kernel 5 and its backward kernels against their plain versions."""
    dt, d = q.dtype, q.shape[-1]
    before = (fa.fwd_launches, fa.bwd_dkdv_launches, fa.bwd_dq_launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)
    o_low, lse_low = fa.flash_fwd(q, k, v, causal=causal)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, g, causal=causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal=causal,
                                      out_dtype=torch.float32)
    rdq, rdk, rdv = fa.flash_bwd_reference(q, k, v, o, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_dkdv_launches, fa.bwd_dq_launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    _row_close(o, ro, "o float32", FLASH_TOL)
    _row_close(o_low, ro.to(dt), "o", FLASH_TOL)
    _row_close(lse, rlse, "lse", FLASH_TOL)
    assert torch.equal(lse, lse_low)
    # ds = p·(dp − delta)·scale subtracts two terms that cancel (entirely
    # with one key: p = 1 and dp = delta), so dq and dk are held at the
    # size of those terms, scale·max|delta|·max|k| (|q| for dk)
    delta = (g.float() * o).sum(-1).abs().max().item() * d ** -0.5
    _row_close(dq, rdq, "dq", FLASH_TOL, delta * k.float().abs().max().item())
    _row_close(dk, rdk, "dk", FLASH_TOL, delta * q.float().abs().max().item())
    _row_close(dv, rdv, "dv", FLASH_TOL)


def test_flash_bwd_loads_element_wise_where_rows_are_not_16_byte_aligned(
        dev, no_tf32):
    """A bf16 q sliced from a wider tensor, its rows 134 elements apart,
    sends the forward and both backward kernels to their element-wise
    loads; the model's layout takes the 16-byte copies."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, t, d = 2, 2, 150, 64
    wide = torch.randn(b, t, h, d + 3, generator=gen, device=dev) * 0.5
    q = wide.to(torch.bfloat16)[..., :d].transpose(1, 2)
    k, v, g = (_bthd(b, h, t, d, torch.bfloat16, dev, gen, mul)
               for mul in (0.5, 1.0, 1.0))
    assert q.stride(2) % 8 != 0
    assert not fa._vec16(q, k, v, g) and fa._vec16(k, v, g)
    _check_flash(q, k, v, g, True)


def test_flash_bwd_is_bit_for_bit_repeatable(dev):
    """No atomics: two forward runs (o in float32 and in bf16, lse) and
    two backward runs at the TransformerLM's attention, (32, 8, 1024, 64)
    causal bf16, give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k = (_bthd(32, 8, 1024, 64, torch.bfloat16, dev, gen, 0.5)
            for _ in range(2))
    v, g = (_bthd(32, 8, 1024, 64, torch.bfloat16, dev, gen)
            for _ in range(2))
    o, lse = fa.flash_fwd(q, k, v, causal=True, out_dtype=torch.float32)
    o_again, lse_again = fa.flash_fwd(q, k, v, causal=True,
                                      out_dtype=torch.float32)
    o_low, o_low_again = (fa.flash_fwd(q, k, v, causal=True)[0]
                          for _ in range(2))
    first = fa.flash_bwd(q, k, v, o, lse, g, causal=True)
    second = fa.flash_bwd(q, k, v, o, lse, g, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "o bf16", "dq", "dk", "dv"),
                          (o, lse, o_low, *first),
                          (o_again, lse_again, o_low_again, *second)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,route", [("float32", "FMA"),
                                         ("bfloat16", "tensor-core")])
def test_flash_bwd_runs_the_kernels_of_its_dtype(dev, dtype, route):
    """float32 inputs run the float32-FMA backward kernels; bfloat16 the
    tensor-core kernels (names ending in _mma), as the profiler sees."""
    gen = torch.Generator(device=dev).manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v, g = (_bthd(1, 2, 100, 64, dt, dev, gen) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=True, out_dtype=torch.float32)
    names = {n for n in _kernel_names(
        lambda *a: fa.flash_bwd(*a, causal=True), (q, k, v, o, lse, g))
        if "flash_" in n}
    for part in ("flash_bwd_dkdv", "flash_bwd_dq"):
        hits = [n for n in names if part in n]
        assert len(hits) == 1, (part, names)
        assert ("_mma" in hits[0]) == (route == "tensor-core"), hits


@pytest.mark.parametrize("dtype,route", [("float32", "FMA"),
                                         ("bfloat16", "tensor-core")])
def test_flash_fwd_runs_the_kernel_of_its_dtype(dev, dtype, route):
    """float32 inputs run the float32-FMA forward kernel; bfloat16 the
    tensor-core kernel (flash_fwd_mma), for either output type, as the
    profiler sees."""
    gen = torch.Generator(device=dev).manual_seed(6)
    dt = getattr(torch, dtype)
    q, k, v = (_bthd(1, 2, 100, 64, dt, dev, gen) for _ in range(3))
    for out_dtype in (None, torch.float32):
        hits = {n for n in _kernel_names(
            lambda *a: fa.flash_fwd(*a, causal=True, out_dtype=out_dtype),
            (q, k, v)) if "flash_" in n}
        assert len(hits) == 1, hits
        name, = hits
        assert "flash_fwd" in name, name
        assert ("flash_fwd_mma" in name) == (route == "tensor-core"), name


def test_flash_attention_refuses_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 1, 4, 129, device=dev)
    with pytest.raises(ValueError, match="ROADMAP"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q[..., :64], q[..., :64].bfloat16(), q[..., :64])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q[..., :64].half(), q[..., :64].half(),
                     q[..., :64].half())
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_fwd(q[..., :64], q[..., :64].cpu(), q[..., :64])


# -- run-time-compiled CUDA C (rtc.CudaModule, kernel row 17) -------------
# NVRTC contracts a·x + y into one FMA, so saxpy is held to the plain
# version computed in float64 and rounded once: within one float32 ulp of
# each value.  The __half template may round the product and the sum
# apart: one half ulp of each value plus one of a·x.  Block sums: 1e-5 of
# each block's sum of |x| (float32 sums in another order).

_SAXPY = r"""
extern "C" __global__ void saxpy(const float *x, float *y, float a, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        y[i] = a * x[i] + y[i];
}
"""
_AXPY = r"""
#include <cuda_fp16.h>
template <typename T>
__global__ void axpy(const T *x, T *y, T a, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = a * x[i] + y[i];
}
"""
_BLOCK_SUM = r"""
extern "C" __global__ void block_sum(const float *x, float *out, int n,
                                     int chunk) {
    extern __shared__ float buf[];
    long long base = (long long)blockIdx.x * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x)
        buf[i] = base + i < n ? x[base + i] : 0.0f;
    __syncthreads();
    float s = 0.0f;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) s += buf[i];
    __syncthreads();
    buf[threadIdx.x] = s;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}
"""


def _ulp(v):
    a = v.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _axpy_within(got, x, y0, a, dtype):
    """max |got - (a·x + y0 rounded once)| over the allowance."""
    got, x, y0 = (t.cpu() for t in (got, x, y0))
    a = torch.tensor(a, dtype=dtype).double().item()
    want = (a * x.double() + y0.double()).to(dtype)
    allow = _ulp(want).double()
    if dtype == torch.float16:
        allow = allow + _ulp((a * x.double()).to(dtype)).double()
    return ((got.double() - want.double()).abs() / allow).max().item()


@pytest.mark.parametrize("n", [1, 1000, 100003])
def test_rtc_saxpy_matches_plain_on_the_current_stream(dev, n):
    from incubator_mxnet_tpu_torch import context, rtc
    k = rtc.CudaModule(_SAXPY).get_kernel(
        "saxpy", "const float *x, float *y, float a, int n")
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev)
    y = torch.randn(n, generator=g, device=dev)
    y0 = y.clone()
    before = rtc.launches
    k.launch([x, y, 1.7, n], context.gpu(0), (64,), (128,))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ys = y0.clone()
        k.launch([x, ys, 1.7, n], dev, (3, 1), (32, 2, 1))
        ys = ys * 1.0                   # a torch op on the same stream
    torch.cuda.current_stream(dev).wait_stream(side)
    assert rtc.launches == before + 2
    assert _axpy_within(y, x, y0, 1.7, torch.float32) <= 1.0
    assert torch.equal(ys, y)


@pytest.mark.parametrize("ctype,dtype", [("float", torch.float32),
                                         ("__half", torch.float16)])
def test_rtc_template_through_exports(dev, ctype, dtype):
    from incubator_mxnet_tpu_torch import rtc
    mod = rtc.CudaModule(_AXPY, exports=["axpy<float>", "axpy<__half>"])
    k = mod.get_kernel(f"axpy<{ctype}>",
                       f"const {ctype} *x, {ctype} *y, {ctype} a, int n")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(5000, generator=g, device=dev).to(dtype)
    y = torch.randn(5000, generator=g, device=dev).to(dtype)
    y0 = y.clone()
    k.launch([x, y, -0.3, 5000], dev, (20,), (256,))
    assert _axpy_within(y, x, y0, -0.3, dtype) <= 1.0


def test_rtc_dynamic_shared_memory_above_48k(dev):
    from incubator_mxnet_tpu_torch import rtc
    chunk, n = 16384, 5 * 16384 + 77
    k = rtc.CudaModule(_BLOCK_SUM).get_kernel(
        "block_sum", "const float *x, float *out, int n, int chunk")
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    out = torch.empty(6, device=dev)
    k.launch([x, out, n, chunk], dev, (6,), (256,), shared_mem=chunk * 4)
    blocked = torch.nn.functional.pad(x, (0, 6 * chunk - n)).reshape(6, -1)
    err = (out - blocked.sum(1)).abs() / blocked.abs().sum(1)
    assert err.max().item() <= 1e-5


def test_rtc_int64_scalar_and_typed_pointers(dev):
    from incubator_mxnet_tpu_torch import rtc
    src = r"""
    extern "C" __global__ void fill(long long *out, long long start,
                                    const unsigned char *u, const char *c,
                                    const double *d, int n) {
        int i = threadIdx.x;
        if (i < n) out[i] = start + u[i] + c[i] + (long long)d[i];
    }"""
    k = rtc.CudaModule(src).get_kernel(
        "fill", "int64_t *out, int64_t start, const uint8_t *u, "
        "const int8_t *c, const double *d, int n")
    n, start = 100, 5 * 2 ** 33 + 1
    u = torch.arange(n, dtype=torch.uint8, device=dev)
    c = -torch.arange(n, dtype=torch.int8, device=dev)
    d = torch.full((n,), 7.0, dtype=torch.float64, device=dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    k.launch([out, start, u, c, d, n], dev, 1, 128)
    assert torch.equal(out.cpu(), torch.full((n,), start + 7))


def test_rtc_refuses_what_it_cannot_launch(dev):
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.error import KernelError
    with pytest.raises(KernelError, match="error"):
        rtc.CudaModule('extern "C" __global__ void f(float *x) { x[0] = 1 }')
    k = rtc.CudaModule(_SAXPY).get_kernel(
        "saxpy", "const float *x, float *y, float a, int n")
    x = torch.zeros(64, device=dev)
    y = torch.zeros(64, device=dev)
    before = rtc.launches
    with pytest.raises(ValueError, match="cpu"):
        k.launch([x.cpu(), y, 1.0, 64], dev, 1, 64)
    with pytest.raises(TypeError, match="float64"):
        k.launch([x.double(), y, 1.0, 64], dev, 1, 64)
    with pytest.raises(ValueError, match="4 arguments"):
        k.launch([x, y, 1.0], dev, 1, 64)
    with pytest.raises(ValueError, match="contiguous"):
        k.launch([torch.zeros(128, device=dev)[::2], y, 1.0, 64], dev, 1, 64)
    with pytest.raises(ValueError, match="grid_dims"):
        k.launch([x, y, 1.0, 64], dev, (1, 1, 1, 1), 64)
    with pytest.raises(KernelError, match="extern"):
        rtc.CudaModule("__global__ void g(float *x) { x[0] = 1; }"
                       ).get_kernel("g", "float *x").launch([x], dev, 1, 1)
    assert rtc.launches == before


def test_pallas_module_on_the_card_matches_cpu(dev):
    from incubator_mxnet_tpu_torch import rtc

    def rows(x_ref, y_ref, o_ref, *, alpha):
        i = rtc.program_id(0)
        o_ref[i] = x_ref[i] * alpha + y_ref[i] * rtc.num_programs(0)

    k = rtc.PallasModule(rows, num_inputs=2, static_args=("alpha",)
                         ).get_kernel("rows", alpha=3.0)
    g = torch.Generator().manual_seed(4)
    x, y = torch.randn(6, 40, generator=g), torch.randn(6, 40, generator=g)
    got = k.launch([x.to(dev), y.to(dev)], grid_dims=(6,))
    torch.testing.assert_close(got.cpu(), k.launch([x, y], grid_dims=(6,)),
                               rtol=1e-6, atol=1e-6)


def test_lenet_step_on_the_card_matches_cpu(dev, no_tf32):
    """examples/train_mnist.py's network, deferred on the card and given
    the CPU model's weights: one Adam step, loss 1e-5 relative, every
    gradient 1e-4 of its largest value; the update of every weight whose
    gradient is above 1e-2 of its largest within 1e-2·lr, every weight
    within 2·lr (a first Adam step moves a weight by about lr·sign(g),
    and a gradient near 0 may round to the other sign)."""
    from incubator_mxnet_tpu_torch.convert import (params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.examples.train_mnist import (
        lenet, synthetic_data)
    x, y = (torch.from_numpy(a) for a in synthetic_data(16, seed=3))
    cpu = lenet()
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        cpu(x)
    card = lenet()
    card.initialize(device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    out = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        trainer = Trainer(net.collect_params(), "adam",
                          {"learning_rate": 3e-3})
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(x.to(where)), y.to(where))
        autograd.backward(loss)
        grads = grads_to_numpy(net)
        before = params_to_numpy(net)
        trainer.step(16)
        after = params_to_numpy(net)
        out.append((loss.sum().item(), grads, after,
                    {k: after[k] - before[k] for k in after}))
    (l_cpu, g_cpu, w_cpu, d_cpu), (l_card, g_card, w_card, d_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, g in g_cpu.items():
        scale = np.abs(g).max()
        assert np.abs(g_card[name] - g).max() <= 1e-4 * scale, name
        large = np.abs(g) > 1e-2 * scale
        assert np.abs(d_card[name] - d_cpu[name])[large].max() <= 3e-5, name
        assert np.abs(w_card[name] - w_cpu[name]).max() <= 6e-3, name


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_fused_rnn_cudnn_matches_reference(dev, no_tf32, mode,
                                           bidirectional):
    """``fused_rnn`` on the card (cuDNN's RNN, fed views of the one flat
    parameter) against the plain loop: out, hN, cN and the gradients of
    the data, the flat parameter (one tensor of its shape) and the
    states, two layers."""
    from incubator_mxnet_tpu_torch.ops import sequence_ops as so
    t, b, i, h, layers = 9, 5, 12, 16, 2
    d = 2 if bidirectional else 1
    g = torch.Generator().manual_seed(0)
    n = so.rnn_param_size(i, h, layers, mode, bidirectional)
    args = [torch.randn(t, b, i, generator=g),
            (torch.rand(n, generator=g) * 2 - 1) / h ** 0.5,
            torch.randn(layers * d, b, h, generator=g),
            torch.randn(layers * d, b, h, generator=g)]
    if mode != "lstm":
        args[3] = None
    kw = dict(state_size=h, num_layers=layers, mode=mode,
              bidirectional=bidirectional)
    res = []
    for fn in (so.fused_rnn, so.fused_rnn_reference):
        leaves = [a.to(dev).requires_grad_() if a is not None else None
                  for a in args]
        outs = fn(*leaves, **kw)
        heads = [torch.randn(o.shape, generator=torch.Generator()
                             .manual_seed(k)).to(dev)
                 for k, o in enumerate(outs)]
        torch.autograd.backward(outs, heads)
        res.append(([o.detach() for o in outs],
                    [a.grad for a in leaves if a is not None]))
    (outs, grads), (routs, rgrads) = res
    assert grads[1].shape == (n,)
    for got, want in zip(outs, routs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for got, want in zip(grads, rgrads):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_fused_rnn_refuses_what_cudnn_does_not_take(dev):
    """No fallback on the card: a dtype cuDNN's RNN lacks raises."""
    from incubator_mxnet_tpu_torch.ops import sequence_ops as so
    n = so.rnn_param_size(4, 8, 1, "gru")
    x = torch.zeros(3, 2, 4, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cuDNN"):
        so.fused_rnn(x, torch.zeros(n, device=dev, dtype=torch.bfloat16),
                     torch.zeros(1, 2, 8, device=dev, dtype=torch.bfloat16),
                     state_size=8, mode="gru")


def test_lstm_lm_step_on_the_card_matches_cpu(dev, no_tf32):
    """A small LSTM language model (vocab 50, 24/32 units, 2 layers,
    dropout 0): one SGD step with the state carried in, card against
    CPU from the same weights: loss 1e-5 relative, every gradient 1e-4
    of its largest value, the cross-entropy kernels launched once each."""
    from incubator_mxnet_tpu_torch.convert import (params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.models import LSTMLanguageModel
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 50, (7, 4), generator=g)
    y = torch.randint(0, 50, (28,), generator=g)
    cpu = LSTMLanguageModel(50, 24, 32, 2, dropout=0.0)
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    card = LSTMLanguageModel(50, 24, 32, 2, dropout=0.0).initialize(
        device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    out = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        state = net.begin_state(4, device=where)
        before = sx.fwd_launches, sx.bwd_launches
        with autograd.record():
            logits, _ = net(x.to(where), state)
            loss = SoftmaxCrossEntropyLoss()(logits.reshape(28, -1),
                                             y.to(where)).mean()
        autograd.backward(loss)
        launched = (sx.fwd_launches - before[0], sx.bwd_launches - before[1])
        out.append((loss.item(), grads_to_numpy(net), launched))
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = out
    assert n_cpu == (0, 0) and n_card == (1, 1)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, gr in g_cpu.items():
        assert np.abs(g_card[name] - gr).max() <= 1e-4 * np.abs(gr).max(), \
            name


def _ssd_inputs(bsz, maps, seed):
    """Anchors of an SSD over feature maps ``maps`` (4 a pixel), labels
    (B, 3, 5) with 1-3 boxes an image, class scores (B, 21, N) and box
    offsets (B, N·4), on the CPU."""
    from incubator_mxnet_tpu_torch.ops import contrib_ops as co
    anchors = torch.cat([co.multibox_prior(
        torch.zeros(1, 1, m, m), sizes=(0.2 + 0.17 * i, 0.27 + 0.17 * i),
        ratios=(1, 2, 0.5)) for i, m in enumerate(maps)], dim=1)
    rng = np.random.RandomState(seed)
    labels = np.full((bsz, 3, 5), -1.0, np.float32)
    for b in range(bsz):
        for j in range(1 + b % 3):
            w, h = rng.uniform(0.1, 0.9, 2)
            x0, y0 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            labels[b, j] = [rng.randint(0, 20), x0, y0, x0 + w, y0 + h]
    g = torch.Generator().manual_seed(seed)
    n = anchors.shape[1]
    return (anchors, torch.from_numpy(labels),
            torch.randn(bsz, 21, n, generator=g),
            torch.randn(bsz, n * 4, generator=g) * 0.5)


def test_detection_ops_on_the_card_match_cpu(dev):
    """``multibox_target`` (3:1 mining) and ``multibox_detection`` (SSD's
    settings) at B=8 over 38x38, 19x19, 10x10, 5x5 and 1x1 maps (7,884
    anchors), card against CPU."""
    from incubator_mxnet_tpu_torch.ops import contrib_ops as co
    anchors, labels, cls_preds, loc = _ssd_inputs(8, (38, 19, 10, 5, 1), 0)
    cls_prob = torch.softmax(cls_preds, dim=1)
    det_kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
    want_t = co.multibox_target(anchors, labels, cls_preds,
                                negative_mining_ratio=3.0)
    want_d = co.multibox_detection(cls_prob, loc, anchors, **det_kw)
    got_t = co.multibox_target(anchors.to(dev), labels.to(dev),
                               cls_preds.to(dev), negative_mining_ratio=3.0)
    got_d = co.multibox_detection(cls_prob.to(dev), loc.to(dev),
                                  anchors.to(dev), **det_kw)
    assert all(t.device == dev for t in (*got_t, got_d))
    torch.testing.assert_close(got_t[0].cpu(), want_t[0], rtol=0, atol=1e-5)
    assert torch.equal(got_t[1].cpu(), want_t[1])
    assert torch.equal(got_t[2].cpu(), want_t[2])
    assert (want_t[2] == -1).any() and (want_t[2] > 0).any()
    got_d = got_d.cpu()
    assert torch.equal(got_d[..., :2] == -1, want_d[..., :2] == -1)
    assert torch.equal(got_d[..., 0], want_d[..., 0])
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=1e-5)
    assert (want_d[..., 1] > 0).any()


def test_small_ssd_step_on_the_card_matches_cpu(dev, no_tf32):
    """The JAX suite's small SSD (2 classes, two scales, base width 8) at
    B=2, 64x64: one step card against CPU from the same weights; the
    softmax kernel launches in neither the step nor its backward, and
    once in ``detections``, whose rows match the CPU's."""
    from incubator_mxnet_tpu_torch.convert import (params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.models import SSDLoss
    from incubator_mxnet_tpu_torch.examples.train_ssd import (
        ssd_net, synthetic_labels)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    labels = torch.from_numpy(synthetic_labels(2))
    cpu = ssd_net()
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        cpu(x)
    card = ssd_net()
    card.initialize(device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    out = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        before = (sm.fwd_launches, sm.bwd_launches)
        with autograd.record():
            anchors, cls_preds, box_preds = net(x.to(where))
            loc_t, loc_m, cls_t = net.targets(anchors, labels.to(where),
                                              cls_preds)
            loss = SSDLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
        autograd.backward(loss)
        step = (sm.fwd_launches - before[0], sm.bwd_launches - before[1])
        det = net.detections(cls_preds, box_preds, anchors)
        launched = (sm.fwd_launches - before[0], sm.bwd_launches - before[1])
        out.append((loss.sum().item(), grads_to_numpy(net), cls_t.cpu(),
                    det.cpu(), step, launched))
    (l_cpu, g_cpu, t_cpu, d_cpu, s_cpu, n_cpu), \
        (l_card, g_card, t_card, d_card, s_card, n_card) = out
    assert (s_cpu, n_cpu) == ((0, 0), (0, 0))
    assert s_card == (0, 0) and n_card == (1, 0)
    assert torch.equal(t_card, t_cpu)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, gr in g_cpu.items():
        if name in ("stage0.0.bias", "stage0.3.bias"):
            wscale = np.abs(g_cpu[name.replace("bias", "weight")]).max()
            assert np.abs(gr).max() <= 1e-4 * wscale, name
            assert np.abs(g_card[name]).max() <= 1e-4 * wscale, name
            continue
        assert np.abs(g_card[name] - gr).max() <= 1e-4 * np.abs(gr).max(), \
            name
    assert torch.equal(d_card[..., 0], d_cpu[..., 0])
    torch.testing.assert_close(d_card, d_cpu, rtol=0, atol=1e-5)


OPT_CASES = [("sgd", "sgd", dict(learning_rate=0.1, momentum=0.9)),
             ("sgld", "sgld", dict(learning_rate=0.01)),
             ("signum", "signum", dict(learning_rate=0.01, wd_lh=0.01)),
             ("dcasgd", "dcasgd", dict(learning_rate=0.1, momentum=0.9)),
             ("nag", "nag", dict(learning_rate=0.1, momentum=0.9)),
             ("adagrad", "adagrad", dict(learning_rate=0.1)),
             ("adadelta", "adadelta", dict()),
             ("adam", "adam", dict(learning_rate=0.01)),
             ("adamw", "adamw", dict(learning_rate=0.01)),
             ("adamax", "adamax", dict(learning_rate=0.01)),
             ("nadam", "nadam", dict(learning_rate=0.01)),
             ("ftrl", "ftrl", dict(learning_rate=0.1, lamda1=0.01)),
             ("ftml", "ftml", dict(learning_rate=0.01)),
             ("lars", "lars", dict(learning_rate=0.1, momentum=0.9)),
             ("lamb", "lamb", dict(learning_rate=0.01)),
             ("rmsprop", "rmsprop", dict(learning_rate=0.01)),
             ("rmsprop_centered", "rmsprop",
              dict(learning_rate=0.01, centered=True, clip_weights=2.0)),
             ("lbsgd", "lbsgd", dict(learning_rate=0.1, momentum=0.9)),
             ("test", "test", dict())]


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, np.maximum(e, -125) - 8)


@pytest.mark.parametrize("master", [False, True], ids=["float32",
                                                       "bfloat16_master"])
@pytest.mark.parametrize("case,name,kw", OPT_CASES,
                         ids=[c for c, _, _ in OPT_CASES])
def test_optimizer_on_the_card_matches_cpu(dev, case, name, kw, master):
    """Three updates of a (256, 64) weight, weight decay 0.01, float32 or
    bfloat16 with a float32 master, on the card and on the CPU."""
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(256, 64, generator=gen)
    grads = [0.1 * torch.randn(256, 64, generator=gen) for _ in range(3)]
    dtype = torch.bfloat16 if master else torch.float32
    outs = []
    for where in ("cpu", dev):
        kwargs = dict(kw, wd=0.01, multi_precision=master)
        if name == "sgld":
            kwargs["generator"] = torch.Generator().manual_seed(1)
        up = opt_mod.get_updater(opt_mod.create(name, **kwargs))
        w = w0.to(where, dtype).clone()
        for g in grads:
            up(0, g.to(where, dtype), w)
        assert w.dtype == dtype
        outs.append([t.float().cpu().numpy() for t in
                     [w] + _flat(up.states[0])])
    tol = 1e-5 if name in ("lamb", "lars") else 1e-6
    for i, (a, b) in enumerate(zip(*reversed(outs))):
        if master and i == 0:   # each device's master rounded to bf16
            near = tol * np.abs(outs[0][1]).max()
            assert (np.abs(a - b) <= np.maximum(_bf16_ulp(b), near)).all()
        else:
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), i


def test_params_file_from_the_card_reads_back_on_the_cpu(dev, tmp_path):
    from incubator_mxnet_tpu_torch import ndarray as nd
    gen = torch.Generator().manual_seed(0)
    arrays = {"w": torch.randn(33, 7, generator=gen).to(dev),
              "h": torch.randn(5, generator=gen).to(dev, torch.bfloat16),
              "i": torch.arange(9, device=dev, dtype=torch.int32)}
    f = str(tmp_path / "a.params")
    nd.save(f, arrays)
    back = nd.load(f)
    for k, v in arrays.items():
        assert back[k].device.type == "cpu" and back[k].dtype == v.dtype
        assert torch.equal(back[k], v.cpu())


def test_bert_lamb_resume_on_the_card_equals_the_uninterrupted_run(
        dev, tmp_path):
    """A small bfloat16 BERT (2 layers), LAMB with ``multi_precision``, a
    PolyScheduler with warm-up, wd 0.01 but none on LayerNorm parameters
    and biases, B=4, T=32: 2 steps, save, a fresh model and trainer
    (``begin_num_update=2``) load both files, 2 more steps; equal to the
    uninterrupted 4 steps within the spread of two uninterrupted runs,
    with 5 LayerNorm forward and backward launches a step."""
    from incubator_mxnet_tpu_torch.optimizer.lr_scheduler import (
        PolyScheduler)
    cfg = dict(vocab_size=300, num_layers=2, units=64, hidden_size=256,
               num_heads=4, max_length=32, dropout=0.0)
    batch = [torch.from_numpy(a).to(dev) for a in synthetic_batch(4, 32, 300)]
    ce = SoftmaxCrossEntropyLoss()

    def build(seed):
        net = BERTModel(**cfg).initialize(
            device=dev, generator=torch.Generator().manual_seed(seed))
        amp.convert_block(net, "bfloat16")
        for k, p in net.collect_params().items():
            if k.endswith(("gamma", "beta", "bias")):
                p.wd_mult = 0.0
        return net

    def lamb(net, begin=0):
        return Trainer(net.collect_params(), "lamb", {
            "learning_rate": 1e-2, "multi_precision": True, "wd": 0.01,
            "begin_num_update": begin,
            "lr_scheduler": PolyScheduler(max_update=5, base_lr=1e-2, pwr=1,
                                          warmup_steps=2)})

    def steps(net, trainer, n):
        out = []
        for _ in range(n):
            with autograd.record():
                loss = pretraining_loss(net, ce, *batch)
            autograd.backward(loss)
            trainer.step(4)
            out.append(loss.float().item())
        return out

    runs = []
    for _ in range(2):
        net = build(1)
        runs.append((steps(net, lamb(net), 4),
                     [p.detach().float() for p in net.parameters()]))

    def spread(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b))

    repeat = spread(runs[1][1], runs[0][1])
    net = build(1)
    trainer = lamb(net)
    before = ln.launches
    first = steps(net, trainer, 2)
    assert ln.launches - before == 2 * 5
    net.save_parameters(str(tmp_path / "b.params"))
    trainer.save_states(str(tmp_path / "b.states"))
    fresh = build(2)
    fresh.load_parameters(str(tmp_path / "b.params"))
    resumed = lamb(fresh, begin=2)
    resumed.load_states(str(tmp_path / "b.states"))
    rest = steps(fresh, resumed, 2)
    assert spread([p.detach().float() for p in fresh.parameters()],
                  runs[0][1]) <= repeat
    if repeat == 0:
        assert first + rest == runs[0][0]
