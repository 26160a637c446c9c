"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the sums run in another order); bfloat16 y
rtol=atol=1e-2 (one bf16 ulp at |y| ~ 1); the float32 statistics 1e-5.
"""
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import layer_norm as ln

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
