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
reasons.  The small fused ResNet, card step against CPU step: loss 1e-5
relative, every gradient 1e-3 of its largest value (50 layers of
float32 sums in another order; both TF32 switches off).  Its
``FusedTrainStep`` by CUDA-graph replay against the same step run
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


@pytest.mark.parametrize("shape,dtype", [
    ((1024, 768), "float32"),     # BERT-base serving batch, B=8 T=128
    ((1024, 768), "bfloat16"),
    ((2048, 768), "float32"),     # BERT-base training batch, B=16 T=128
    ((1000, 100), "float32"),     # one warp per row, ragged last block
    ((3, 4096), "bfloat16"),      # one block per row
    ((8, 3, 513), "float32"),     # just past the one-warp width
    ((2, 70000), "float32"),      # too wide for shared memory: re-reads x
])
def test_layer_norm_kernel_matches_plain(dev, shape, dtype):
    x, g, b = _inputs(shape, dtype, dev)
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


@pytest.mark.parametrize("shape,dtype", [
    ((2048, 30522), "float32"),   # BERT-base MLM head, B=16 T=128
    ((2048, 30522), "bfloat16"),
    ((16, 2), "float32"),         # NSP head
    ((1000, 100), "float32"),
    ((3, 16385), "float32"),      # past the TPU kernel's width limit
])
def test_softmax_xent_kernels_match_plain(dev, shape, dtype):
    x, labels, g = _xent_inputs(shape, dtype, dev)
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


def _row_close(got, want, what):
    """Kernels 3-4 and 8-9 against their plain versions: float32 1e-6 of
    the largest |want|; bfloat16 one bf16 ulp of each value more."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all() and torch.isfinite(want).all(), what
    bound = torch.full_like(want, 1e-6 * want.abs().max().item())
    if bf16:
        bound += torch.ldexp(torch.ones_like(want),
                             torch.frexp(want.abs())[1] - 8)
    assert ((got - want).abs() <= bound).all(), (
        what, ((got - want).abs() - bound).max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [
    (4096, 1024),      # the attention rows' width (T = 1024)
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
@pytest.mark.parametrize("rows,cols", [
    (32768, 512),      # the TransformerLM's rows, B=32 T=1024
    (1000, 7), (10, 300), (6, 129), (100, 1000),
    (64, 1025),        # just past the one-warp width
    (3, 16385), (2, 70000),
])
def test_rms_norm_kernels_match_plain(dev, dtype, rows, cols):
    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, dtype)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 0.3).to(dt)
    gamma = (torch.rand(cols, generator=g, device=dev) + 0.5).to(dt)
    gy = torch.randn(rows, cols, generator=g, device=dev).to(dt)
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


def test_small_transformer_step_on_the_card_matches_cpu(dev, no_tf32):
    """The example's --smoke config (2 layers), one SGD step on the card
    against the same step on the CPU, with each new kernel's launches."""
    from incubator_mxnet_tpu_torch.examples.train_transformer_lm import (
        config)
    cfg, batch, seq = config(smoke=True)
    cpu = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1))
    got = {}
    for where, model in (("cpu", cpu), ("card", card)):
        params = list(model.parameters())
        before = (sm.fwd_launches, sm.bwd_launches, rn.fwd_launches,
                  rn.bwd_launches, sx.fwd_launches, sx.bwd_launches)
        loss = model.loss(tokens.to(params[0].device))
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        after = (sm.fwd_launches, sm.bwd_launches, rn.fwd_launches,
                 rn.bwd_launches, sx.fwd_launches, sx.bwd_launches)
        got[where] = (loss.item(), [g.cpu() for g in grads],
                      [a - b for a, b in zip(after, before)])
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = got["cpu"], got["card"]
    assert n_cpu == [0] * 6 and n_card == [2, 2, 5, 5, 1, 1]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for (name, _), a, b in zip(cpu.named_parameters(), g_card, g_cpu):
        _within(a, b, 1e-4, name)
    step = card.make_train_step()
    losses = [step(tokens.to(dev)).item() for _ in range(3)]
    assert all(abs(v - l_card) < 0.5 for v in losses)
