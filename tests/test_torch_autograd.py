"""The port's autograd (``incubator_mxnet_tpu_torch/autograd.py``) and the
second derivatives of its kernel Functions, against the JAX package, on
the CPU.

- Higher-order gradients: the cases of the JAX package's
  ``tests/test_op_tail.py`` (x³ to the third order, sin / log / sigmoid,
  ``backward(create_graph=True)`` then ``grad`` of the ``.grad``), run in
  both packages, float32, within 1e-6 relative.
- ``grad`` with and without ``create_graph``, ``Function``,
  ``mark_variables``, ``set_recording`` and ``grad_req`` write / add /
  null through ``backward`` (an unreached leaf keeps its gradient),
  against the JAX package: float32 values that both packages compute
  with the same operations in the same order, compared exactly.  The
  port's leaves stand for the JAX package's ``attach_grad()`` arrays:
  parameters with a request; a plain tensor accumulates, as in PyTorch.
- The seven kernel Functions: each one's second derivative on the CPU
  (the gradient of the summed squares of the first gradients, with
  respect to every differentiable input) against ``jax.grad`` of
  ``jax.grad`` of the JAX op on its CPU path, within 1e-4 of the
  largest |JAX| value of each tensor (float32, the same formulas summed
  in other orders); the first gradients under ``create_graph`` equal
  those without it bit for bit.  Flash attention raises in both
  packages.  The cross-entropy case that gave Σ|h| = 4.5689 against the
  exact 3.4888 before the repair is kept as a regression test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import fused_block as jfb
from incubator_mxnet_tpu.ops import fused_conv as jfc
from incubator_mxnet_tpu.ops import nn_ops as jnn
from incubator_mxnet_tpu.ops import pallas_kernels as jpk

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import fused_block as fb
from incubator_mxnet_tpu_torch.ops import fused_conv as fc
from incubator_mxnet_tpu_torch.ops import nn_ops
from incubator_mxnet_tpu_torch.ops._higher_order import \
    HigherOrderGradientError

SECOND_TOL = 1e-4


def _leaf(a, requires_grad=True):
    """A leaf with the request ``"write"``: the port's counterpart of the
    JAX package's ``attach_grad()``.  A tensor that PyTorch code made to
    require a gradient has no request and accumulates
    (``test_a_plain_tensor_accumulates_as_in_pytorch``)."""
    x = torch.tensor(np.asarray(a, np.float32))
    if not requires_grad:
        return x
    x = torch.nn.Parameter(x)
    x.grad_req = "write"
    return x


def _jax_x(a, grad_req="write"):
    x = jnd.array(np.asarray(a, np.float32))
    x.attach_grad(grad_req=grad_req)
    return x


# ---------------------------------------------------------------------------
# higher order
# ---------------------------------------------------------------------------

def test_second_and_third_order_of_a_cube():
    v = [1.5, -2.0, 0.7]
    x = _leaf(v)
    with autograd.record():
        y = x * x * x
        g1 = autograd.grad([y], [x], head_grads=[torch.ones(3)],
                           create_graph=True)[0]
        g2 = autograd.grad([g1], [x], head_grads=[torch.ones(3)],
                           create_graph=True)[0]
    autograd.backward(g1, torch.ones(3), retain_graph=True)
    second = x.grad.clone()
    autograd.backward(g2, torch.ones(3))
    third = x.grad.clone()

    jx = _jax_x(v)
    with jag.record():
        jy = jx * jx * jx
        (jg1,) = jag.grad([jy], [jx], head_grads=[jnd.ones((3,))],
                          create_graph=True)
        (jg2,) = jag.grad([jg1], [jx], head_grads=[jnd.ones((3,))],
                          create_graph=True)
    jg1.backward(jnd.ones((3,)), retain_graph=True)
    jsecond = jx.grad.asnumpy().copy()
    jg2.backward(jnd.ones((3,)))
    np.testing.assert_allclose(g1.detach().numpy(), jg1.asnumpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(second.numpy(), jsecond, rtol=1e-6)
    np.testing.assert_allclose(second.numpy(), 6 * np.float32(v), rtol=1e-6)
    assert third.tolist() == jx.grad.asnumpy().tolist() == [6.0] * 3


@pytest.mark.parametrize("name", ["sin", "log", "sigmoid"])
def test_second_derivative_of_ops(name):
    v = [0.4, 1.1, 2.3]
    x = _leaf(v)
    with autograd.record():
        y = getattr(torch, name)(x)
        (g1,) = autograd.grad([y], [x], create_graph=True)
    autograd.backward(g1)
    jx = _jax_x(v)
    with jag.record():
        jy = getattr(jnd, name)(jx)
        (jg1,) = jag.grad([jy], [jx], head_grads=[jnd.ones((3,))],
                          create_graph=True)
    jg1.backward(jnd.ones((3,)))
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.asnumpy(), rtol=1e-6)


def test_backward_create_graph_then_grad_of_the_grad():
    v = [1.5, -2.0]
    x = _leaf(v)
    with autograd.record():
        y = torch.pow(x, 3)
        autograd.backward([y], create_graph=True)
        (g2,) = autograd.grad([x.grad], [x], head_grads=[torch.ones(2)])
    jx = _jax_x(v)
    with jag.record():
        jy = jx * jx * jx
        jag.backward([jy], create_graph=True)
        (jg2,) = jag.grad([jx.grad], [jx], head_grads=[jnd.ones((2,))])
    np.testing.assert_allclose(g2.numpy(), jg2.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), 6 * np.float32(v), rtol=1e-6)


# ---------------------------------------------------------------------------
# grad, Function, mark_variables, set_recording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("create_graph", [False, True])
def test_grad_leaves_grad_attributes_alone(create_graph):
    """``grad`` returns the gradients, zeros for a variable the heads do
    not reach, and leaves every ``.grad`` as it was."""
    a, b, c = _leaf([3.0, -1.0]), _leaf([0.5, 2.0]), _leaf([1.0, 1.0])
    a.grad = torch.full((2,), 7.0)
    with autograd.record():
        y = a * a * b
    ga, gb, gc = autograd.grad(y, [a, b, c], create_graph=create_graph,
                               retain_graph=True)
    assert a.grad.tolist() == [7.0, 7.0] and b.grad is None
    assert gc.tolist() == [0.0, 0.0]
    assert ga.requires_grad == create_graph
    single = autograd.grad(y, a, head_grads=torch.tensor([1.0, 10.0]))
    assert isinstance(single, torch.Tensor)

    ja, jb = _jax_x([3.0, -1.0]), _jax_x([0.5, 2.0])
    with jag.record():
        jy = ja * ja * jb
    jga, jgb = jag.grad(jy, [ja, jb], create_graph=create_graph,
                        head_grads=jnd.ones((2,)))
    assert ga.tolist() == jga.asnumpy().tolist()
    assert gb.tolist() == jgb.asnumpy().tolist()
    with jag.record():
        jy = ja * ja * jb
    (jsingle,) = jag.grad(jy, [ja], head_grads=jnd.array([1.0, 10.0]))
    assert single.tolist() == jsingle.asnumpy().tolist()


def test_function_like_the_jax_package():
    class Square(autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    class JSquare(jag.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    x = _leaf([3.0, -0.5])
    with autograd.record():
        y = Square()(x)
    autograd.backward(y)
    jx = _jax_x([3.0, -0.5])
    with jag.record():
        jy = JSquare()(jx)
    jy.backward()
    assert x.grad.tolist() == jx.grad.asnumpy().tolist() == [6.0, -1.0]
    assert y.tolist() == jy.asnumpy().tolist()


def test_function_with_two_outputs_and_a_python_argument():
    """``forward`` runs in predict mode with nothing recorded; the
    backward gets one gradient per output and returns one per tensor
    input."""
    seen = {}

    class ScaleBoth(autograd.Function):
        def forward(self, a, k, b):
            seen["fwd"] = (autograd.is_recording(), autograd.is_training(),
                           torch.is_grad_enabled())
            self.save_for_backward(a, b)
            return a * k, a * b

        def backward(self, da, dab):
            seen["bwd"] = autograd.is_recording()
            a, b = self.saved_tensors
            return da * 3.0 + dab * b, dab * a

    a, b = _leaf([1.0, 2.0]), _leaf([5.0, -1.0])
    with autograd.record():
        u, v = ScaleBoth()(a, 3.0, b)
        loss = (u * torch.tensor([1.0, 10.0])).sum() + v.sum()
    autograd.backward(loss)
    assert seen == {"fwd": (False, False, False), "bwd": False}
    assert a.grad.tolist() == [3.0 + 5.0, 30.0 - 1.0]
    assert b.grad.tolist() == [1.0, 2.0]
    u2, _ = ScaleBoth()(a.detach(), 3.0, b.detach())     # not recording
    assert u2.grad_fn is None


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables_writes_the_callers_buffer(req):
    x, g = torch.tensor([5.0]), torch.zeros(1)
    autograd.mark_variables([x], [g], req)
    for _ in range(2):
        with autograd.record():
            y = x * 4
        autograd.backward(y)
    jx, jg = jnd.array([5.0]), jnd.zeros((1,))
    jag.mark_variables([jx], [jg], req)
    for _ in range(2):
        with jag.record():
            jy = jx * 4
        jy.backward()
    assert x.grad is g
    assert g.tolist() == jg.asnumpy().tolist() == (
        [4.0] if req == "write" else [8.0])


def test_mark_variables_null_gets_nothing():
    x, g = torch.tensor([5.0]), torch.zeros(1)
    autograd.mark_variables(x, g, "null")
    assert not x.requires_grad and x.grad is None
    with pytest.raises(ValueError):
        autograd.mark_variables(x, g, "sum")


def test_set_recording():
    assert torch.is_grad_enabled()
    assert autograd.set_recording(True) is False
    assert autograd.is_recording() and torch.is_grad_enabled()
    x = _leaf([2.0])
    y = x * x
    assert autograd.set_recording(False) is True
    assert not autograd.is_recording() and torch.is_grad_enabled()
    autograd.backward(y)
    assert x.grad.tolist() == [4.0]
    with autograd.record():
        assert autograd.set_recording(False) is True
        assert not torch.is_grad_enabled()
        assert (x * x).grad_fn is None
        assert autograd.set_recording(True) is False
    assert torch.is_grad_enabled() and not autograd.is_recording()
    assert jag.set_recording(True) is False
    assert jag.set_recording(False) is True


# ---------------------------------------------------------------------------
# grad_req through backward
# ---------------------------------------------------------------------------

def _port_req(v, req):
    x = _leaf(v, requires_grad=req != "null")
    if req != "null":
        x.grad_req = req
    return x


def test_grad_req_write_add_null_and_an_unreached_leaf():
    """Two backwards: ``a`` (write) and ``b`` (add) are reached by both,
    ``c`` (write) only by the first (it keeps that gradient), ``d``
    (null) gets nothing."""
    vals = {"a": [1.0, 2.0], "b": [-3.0, 0.5], "c": [4.0, 4.0],
            "d": [2.0, 1.0]}
    reqs = {"a": "write", "b": "add", "c": "write", "d": "null"}
    p = {k: _port_req(v, reqs[k]) for k, v in vals.items()}
    j = {k: _jax_x(v, reqs[k]) for k, v in vals.items()}
    with autograd.record():
        y1 = p["a"] * p["b"] * p["c"] + p["d"]
    autograd.backward(y1)
    with autograd.record():
        y2 = p["a"] * p["a"] * p["b"] * p["d"]
    autograd.backward(y2, torch.tensor([1.0, -2.0]))
    with jag.record():
        jy1 = j["a"] * j["b"] * j["c"] + j["d"]
    jy1.backward()
    with jag.record():
        jy2 = j["a"] * j["a"] * j["b"] * j["d"]
    jy2.backward(jnd.array([1.0, -2.0]))
    for k in "abc":
        assert p[k].grad.tolist() == j[k].grad.asnumpy().tolist(), k
    assert p["d"].grad is None


def test_a_plain_tensor_accumulates_as_in_pytorch():
    """Two backwards: a tensor that PyTorch code made to require a
    gradient adds the second gradient to the first, as PyTorch's own
    backward does; a leaf with the request "write" keeps the second."""
    plain = torch.tensor([1.0, 2.0], requires_grad=True)
    write = _leaf([1.0, 2.0])
    for k in (3.0, 5.0):
        with autograd.record():
            y = plain * k + write * k
        autograd.backward(y)
    assert plain.grad.tolist() == [8.0, 8.0]
    assert write.grad.tolist() == [5.0, 5.0]


# ---------------------------------------------------------------------------
# the seven kernel Functions
# ---------------------------------------------------------------------------

def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]


def _port_second(fn, arrays, diff):
    """First gradients of sum(sin(out)) (``create_graph``), then the
    gradient of their summed squares, for the inputs ``diff`` names."""
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    wrt = [ts[i] for i in diff]
    with autograd.record():
        loss = _head(fn(*ts), torch)
        first = autograd.grad(loss, wrt, create_graph=True)
        plain = torch.autograd.grad(_head(fn(*ts), torch), wrt)
        second = autograd.grad(sum((g * g).sum() for g in first), wrt)
    for a, b in zip(first, plain):
        assert torch.equal(a.detach(), b)   # first order bit for bit
    return [g.numpy() for g in second]


def _head(out, lib):
    """sum(sin(y)) plus small multiples of the other outputs' sums: a
    head whose second derivative reaches every output."""
    outs = out if isinstance(out, tuple) else (out,)
    total = lib.sum(lib.sin(outs[0].astype("float32")
                            if lib is jnp else outs[0].float()))
    for k, o in enumerate(outs[1:]):
        total = total + (0.01 / (k + 1)) * lib.sum(
            lib.square(o) if lib is jnp else torch.square(o))
    return total


def _jax_second(fn, arrays, diff):
    def loss(*d):
        args = list(map(jnp.asarray, arrays))
        for i, v in zip(diff, d):
            args[i] = v
        return _head(fn(*args), jnp)

    def sq(*d):
        return sum(jnp.sum(g * g) for g in
                   jax.grad(loss, argnums=tuple(range(len(diff))))(*d))

    d0 = [jnp.asarray(arrays[i]) for i in diff]
    return [np.asarray(g) for g in
            jax.grad(sq, argnums=tuple(range(len(diff))))(*d0)]


def _hold(port, want):
    for i, (a, b) in enumerate(zip(port, want)):
        assert a.shape == b.shape, i
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= SECOND_TOL * scale, (
            i, np.abs(a - b).max() / scale)


LABELS = np.arange(8) % 10


CASES = {
    "layer_norm": (
        lambda x, g, b: nn_ops.layer_norm(x, g, b),
        lambda x, g, b: jnn.layer_norm.fn(x, g, b),
        lambda: _rng_arrays(0, (6, 16), (16,), (16,)), (0, 1, 2)),
    "softmax_last_axis": (
        lambda x: nn_ops.softmax(x),
        lambda x: jnn.softmax.fn(x), lambda: _rng_arrays(1, (6, 12)), (0,)),
    "softmax_axis_1": (
        lambda x: nn_ops.softmax(x, axis=1),
        lambda x: jnn.softmax.fn(x, axis=1),
        lambda: _rng_arrays(2, (2, 5, 3)), (0,)),
    "rms_norm": (
        lambda x, g: nn_ops.rms_norm(x, g),
        lambda x, g: jnn.rms_norm.fn(x, g),
        lambda: _rng_arrays(3, (6, 16), (16,)), (0, 1)),
    "softmax_xent": (
        lambda x: nn_ops.softmax_xent(x, torch.tensor(LABELS)),
        lambda x: jnn.softmax_xent.fn(x, jnp.asarray(LABELS)),
        lambda: _rng_arrays(4, (8, 10)), (0,)),
    "fused_matmul_bn": (
        lambda x, w: fb.fused_matmul_bn(x, w),
        lambda x, w: jfb.fused_matmul_bn(x, w),
        lambda: _rng_arrays(5, (12, 8), (8, 6), scale=0.5), (0, 1)),
    "fused_matmul_bn_prologue": (
        lambda x, w, s, b: fb.fused_matmul_bn(x, w, s, b),
        lambda x, w, s, b: jfb.fused_matmul_bn(x, w, s, b),
        lambda: _rng_arrays(6, (12, 8), (8, 6), (8,), (8,), scale=0.5),
        (0, 1, 2, 3)),
    "fused_conv3_bn": (
        lambda x, w: fc.fused_conv3_bn(x, w),
        lambda x, w: jfc.fused_conv3_bn(x, w),
        lambda: _rng_arrays(7, (2, 4, 5, 3), (3, 3, 3, 4), scale=0.5),
        (0, 1)),
    "fused_conv3_bn_prologue": (
        lambda x, w, s, b: fc.fused_conv3_bn(x, w, s, b),
        lambda x, w, s, b: jfc.fused_conv3_bn(x, w, s, b),
        lambda: _rng_arrays(8, (2, 4, 5, 3), (3, 3, 3, 4), (3,), (3,),
                            scale=0.5), (0, 1, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_function_second_derivative_matches_jax(case):
    port_fn, jax_fn, make, diff = CASES[case]
    arrays = make()
    _hold(_port_second(port_fn, arrays, diff),
          _jax_second(jax_fn, arrays, diff))


def test_softmax_xent_second_derivative_regression():
    """Before the repair the port's loss gave Σ|h| = 4.5689 here; the
    exact value, ``F.cross_entropy``'s, is 3.4888."""
    torch.manual_seed(0)
    x = torch.randn(8, 10, requires_grad=True)
    labels = torch.arange(8) % 10
    loss = SoftmaxCrossEntropyLoss()(x, labels).sum()
    (g,) = autograd.grad(loss, [x], create_graph=True)
    (h,) = autograd.grad((g ** 2).sum(), [x])
    x2 = x.detach().clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(F.cross_entropy(x2, labels, reduction="sum"),
                                x2, create_graph=True)
    (h2,) = torch.autograd.grad((g2 ** 2).sum(), x2)
    assert abs(h.abs().sum().item() - 3.4888) < 1e-3
    torch.testing.assert_close(h, h2, rtol=1e-5, atol=1e-6)
    lbl = jnp.asarray(labels.numpy())

    def first(a):
        return jax.grad(lambda b: jnp.sum(jnn.softmax_xent.fn(b, lbl)))(a)

    want = jax.grad(lambda a: jnp.sum(first(a) ** 2))(
        jnp.asarray(x.detach().numpy()))
    _hold([h.numpy()], [np.asarray(want)])


def test_flash_attention_second_derivative_raises_in_both_packages():
    q, k, v = _rng_arrays(9, (1, 2, 8, 8), (1, 2, 8, 8), (1, 2, 8, 8))
    tq = torch.tensor(q, requires_grad=True)
    with autograd.record():
        out = fa.flash_attention(tq, torch.tensor(k), torch.tensor(v),
                                 causal=True)
        (g,) = autograd.grad(out.sin().sum(), [tq], create_graph=True)
    (plain,) = torch.autograd.grad(
        fa.flash_attention(tq, torch.tensor(k), torch.tensor(v),
                           causal=True).sin().sum(), tq)
    assert torch.equal(g.detach(), plain)
    with pytest.raises(HigherOrderGradientError, match="flash_attention"):
        autograd.grad((g * g).sum(), [tq])
    with pytest.raises(Exception):
        _jax_second(lambda a, b, c: jpk.flash_attention(a, b, c, causal=True),
                    [q, k, v], (0,))
