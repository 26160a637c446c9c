"""The port's parameter API (``incubator_mxnet_tpu_torch/gluon/
parameter.py``), ``grad_req`` through the trainer and ``FusedTrainStep``,
and the block's hooks, ``summary`` and ``apply``, against the JAX
package, on the CPU.

A small float32 net (Dense 3→4 with ReLU, LayerNorm, Dense 4→2) is built
in JAX and its weights carried over with ``params_from_jax``.  With the
first layer at ``grad_req "add"`` (two micro-batches a step, then
``zero_grad``), the LayerNorm frozen (``"null"``) and the last layer at
``"write"``, three SGD steps with momentum and weight decay must give
the JAX package's gradients and weights within 1e-6 of the largest value
of each tensor (the same formulas; the port's matmuls sum in another
order); the fused steps within 1e-5 (``FUSED_TOL``).  The hooks'
calls, ``summary``'s printed table and ``apply``'s order must equal the
JAX package's exactly.
"""
import copy
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.fuse import make_fused_train_step as jax_fused
from incubator_mxnet_tpu.gluon import nn as jnn

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.parameter import (Constant,
                                                       ParameterDict)

TOL = 1e-6
# the fused step, as tests/test_torch_fuse.py holds it: the JAX step is
# one XLA program, whose fusions round the small bias updates otherwise
FUSED_TOL = 1e-5


def _jax_net(seed=0):
    mx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(4, in_units=3, activation="relu"),
            jnn.LayerNorm(in_channels=4), jnn.Dense(2, in_units=4))
    net.initialize()
    return net


def _port_net(jnet=None):
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3, activation="relu"),
            nn.LayerNorm(in_channels=4), nn.Dense(2, in_units=4))
    if jnet is not None:
        params_from_jax({k: p.data().asnumpy()
                         for k, p in jnet.collect_params().items()}, net)
    return net


def _batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(5, 3).astype(np.float32),
             rng.randint(0, 2, (5,)).astype(np.int32)) for _ in range(n)]


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, what


def test_grad_req_add_null_write_through_the_trainer():
    jnet = _jax_net()
    net = _port_net(jnet)
    jparams, params = jnet.collect_params(), net.collect_params()
    for name in jparams:
        if name.startswith("0."):
            jparams[name].grad_req = "add"
            params[name].grad_req = "add"
    jnet.collect_params("1\\..*").setattr("grad_req", "null")
    net.collect_params("1\\..*").setattr("grad_req", "null")
    assert [params[n].grad_req for n in params] == [
        jparams[n].grad_req for n in jparams]
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}
    jtrainer = jgluon.Trainer(jparams, "sgd", dict(opt), kvstore=None)
    trainer = Trainer(params, "sgd", dict(opt), kvstore=None)
    jloss, loss_fn = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                      SoftmaxCrossEntropyLoss())
    frozen = {n: params[n].detach().clone() for n in params
              if n.startswith("1.")}
    batches = _batches(6)
    for step in range(3):
        for x, y in batches[2 * step:2 * step + 2]:
            with jag.record():
                jl = jloss(jnet(jnd.array(x)), jnd.array(y)).mean()
            jl.backward()
            with autograd.record():
                pl = loss_fn(net(torch.tensor(x)), torch.tensor(y)).mean()
            autograd.backward(pl)
        for name, p in params.items():
            if name.startswith("1."):
                assert p.grad is None and not p.requires_grad
                continue
            _close(p.grad.numpy(), jparams[name].grad().asnumpy(),
                   f"grad {name} step {step}")
        jtrainer.step(2)
        trainer.step(2)
        jparams.zero_grad()
        params.zero_grad()
        for name, p in params.items():
            _close(p.detach().numpy(), jparams[name].data().asnumpy(),
                   f"{name} step {step}")
            if name.startswith("0."):
                assert p.grad.abs().sum() == 0     # zeroed in place
            elif name.startswith("2."):
                assert p.grad is None              # write: cleared
    for name, before in frozen.items():
        assert torch.equal(params[name], before)
    idx = [i for i, n in enumerate(params) if n.startswith("1.")]
    assert not set(idx) & set(trainer._updater.states)


def test_fused_train_step_does_not_train_null_parameters():
    jnet = _jax_net(1)
    net = _port_net(jnet)
    jnet.collect_params("1\\..*").setattr("grad_req", "null")
    net.collect_params("1\\..*").setattr("grad_req", "null")
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jstep = jax_fused(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(opt))
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(opt), device="cpu")
    assert sorted(step.aux) == ["1.beta", "1.gamma"]
    for x, y in _batches(3, seed=4):
        want = float(jstep(jnd.array(x), jnd.array(y)))
        got = step(torch.tensor(x), torch.tensor(y)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.write_back()
    step.write_back()
    for name, p in net.collect_params().items():
        _close(p.detach().numpy(),
               jnet.collect_params()[name].data().asnumpy(), name, FUSED_TOL)


def test_lr_mult_wd_mult_through_setattr():
    """``setattr("wd_mult", 0.0)`` on the LayerNorm parameters and an
    ``lr_mult`` on the first layer, Adam with weight decay, 2 steps."""
    jnet = _jax_net(2)
    net = _port_net(jnet)
    for params in (jnet.collect_params("1\\..*"),
                   net.collect_params("1\\..*")):
        params.setattr("wd_mult", 0.0)
    for params in (jnet.collect_params("0\\..*"),
                   net.collect_params("0\\..*")):
        params.setattr("lr_mult", 0.5)
    opt = {"learning_rate": 0.05, "wd": 0.1}
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam", dict(opt),
                              kvstore=None)
    trainer = Trainer(net.collect_params(), "adam", dict(opt))
    for x, y in _batches(2, seed=5):
        with jag.record():
            jl = jgluon.loss.SoftmaxCrossEntropyLoss()(
                jnet(jnd.array(x)), jnd.array(y)).mean()
        jl.backward()
        jtrainer.step(1)
        with autograd.record():
            pl = SoftmaxCrossEntropyLoss()(net(torch.tensor(x)),
                                           torch.tensor(y)).mean()
        autograd.backward(pl)
        trainer.step(1)
    for name, p in net.collect_params().items():
        np.testing.assert_allclose(
            p.detach().numpy(), jnet.collect_params()[name].data().asnumpy(),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_second_update_without_backward_applies_zeros():
    """The deliberate difference from the JAX package: its stale
    ``"write"`` gradient is reapplied, the port's was cleared."""
    w = torch.nn.Parameter(torch.ones(3))
    trainer = Trainer([w], "sgd", {"learning_rate": 1.0})
    with autograd.record():
        loss = (w * torch.tensor([1.0, 2.0, 3.0])).sum()
    autograd.backward(loss)
    trainer.update(1)
    assert w.tolist() == [0.0, -1.0, -2.0] and w.grad is None
    trainer.update(1)
    assert w.tolist() == [0.0, -1.0, -2.0]
    trainer.allreduce_grads()


def test_grad_req_setter_and_deferred_parameters():
    p = torch.nn.Parameter(torch.ones(2))
    assert (p.grad_req, p.lr_mult, p.wd_mult) == ("write", 1.0, 1.0)
    p.grad = torch.ones(2)
    p.grad_req = "null"
    assert not p.requires_grad and p.grad is None and p.grad_req == "null"
    p.grad_req = "add"
    assert p.requires_grad and p.grad_req == "add"
    with pytest.raises(ValueError):
        p.grad_req = "sum"
    jp = jgluon.Parameter("w", shape=(2,))
    jp.initialize()
    jp.grad_req = "null"
    assert jp.grad_req == "null"

    net = nn.Dense(3)                       # in_units from the first batch
    net.initialize(device="cpu")
    params = net.collect_params()
    params.setattr("grad_req", "add")
    params.setattr("lr_mult", 0.25)
    net(torch.ones(2, 5))
    w = params["weight"]
    assert w.shape == (3, 5)
    assert (w.grad_req, w.lr_mult, w.requires_grad) == ("add", 0.25, True)


def _made(how):
    """A port parameter made one way: a Dense layer's weight, or a
    ``ParameterDict``'s own."""
    if how == "ParameterDict.get":
        params = ParameterDict()
        w = params.get("w", shape=(2, 3))
        params.initialize(ctx="cpu")
        return w
    if how == "deferred":
        net = nn.Dense(2).initialize(device="cpu")
        net(torch.ones(1, 3))
    else:
        net = nn.Dense(2, in_units=3).initialize(device="cpu")
        if how == "deepcopy":
            net = copy.deepcopy(net)
            net.collect_params()
    return net.weight


@pytest.mark.parametrize("how", ["initialize", "deferred", "deepcopy",
                                 "ParameterDict.get"])
def test_write_overwrites_however_the_parameter_was_made(how):
    """Two backwards leave the second's gradient in a "write" parameter
    from each place the port makes or collects one."""
    w = _made(how)
    for k in (3.0, 5.0):
        with autograd.record():
            y = (w * k).sum()
        autograd.backward(y)
    assert w.grad_req == "write"
    assert w.grad.tolist() == torch.full((2, 3), 5.0).tolist()


def test_parameter_dict_methods(tmp_path):
    jnet = _jax_net(3)
    net = _port_net(jnet)
    params = net.collect_params()
    assert isinstance(params, ParameterDict) and isinstance(params, dict)
    assert list(params) == list(jnet.collect_params().keys())
    assert params.get("2.bias") is params["2.bias"]
    assert params.get("nope") is None
    extra = params.get("extra", shape=(2, 3), init="ones", wd_mult=0.0)
    assert params["extra"] is extra and extra.wd_mult == 0.0
    del params["extra"]
    # save here, load into the JAX package, and back
    f = str(tmp_path / "p.params")
    params.save(f)
    jnet2 = _jax_net(4)
    jnet2.collect_params().load(f)
    for name, p in jnet2.collect_params().items():
        assert np.array_equal(p.data().asnumpy(), params[name].detach())
    g = str(tmp_path / "j.params")
    jnet2.collect_params().save(g)
    net2 = _port_net()
    net2.collect_params().load(g)
    for name, p in net2.collect_params().items():
        assert torch.equal(p, params[name])
    with pytest.raises(KeyError):
        _port_net().collect_params("2\\..*").load(f)
    _port_net().collect_params("2\\..*").load(f, ignore_extra=True)
    # initialize, reset_ctx, zero_grad
    fresh = _port_net()
    fresh.collect_params().initialize(ctx="cpu",
                                      generator=torch.Generator())
    same = _port_net().initialize(device="cpu", generator=torch.Generator())
    for (name, a), b in zip(fresh.collect_params().items(),
                            same.collect_params().values()):
        assert torch.equal(a, b), name
    fresh.collect_params().reset_ctx("cpu")
    with autograd.record():
        out = fresh(torch.ones(2, 3)).sum()
    autograd.backward(out)
    fresh.collect_params().zero_grad()
    assert all(p.grad.abs().sum() == 0 for p in fresh.parameters())


class _WithConstant(nn.HybridSequential):
    def __init__(self):
        super().__init__()
        self.add(nn.Dense(2, in_units=2))
        self.scale = Constant("scale", [[1.0, 2.0]])

    def forward(self, x):
        return super().forward(x) * self.scale


def test_constant():
    c = Constant("c", np.array([1.5, -2.0]))
    assert isinstance(c, Constant) and isinstance(c, torch.nn.Parameter)
    assert c.grad_req == "null" and c.dtype == torch.float32
    assert not isinstance(torch.nn.Parameter(torch.ones(1)), Constant)
    twin = copy.deepcopy(c)
    assert isinstance(twin, Constant) and twin.grad_req == "null"
    assert twin.tolist() == c.tolist() and twin is not c
    jc = jgluon.Constant("c", jnd.array([1.5, -2.0]))
    jc.initialize()
    assert jc.grad_req == "null"
    assert jc.data().asnumpy().tolist() == c.tolist()
    with pytest.raises(ValueError):
        c.grad_req = "write"
    net = _WithConstant().initialize(device="cpu")
    assert net.scale.tolist() == [[1.0, 2.0]]
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    with autograd.record():
        out = net(torch.ones(3, 2)).sum()
    autograd.backward(out)
    trainer.step(1)
    assert net.scale.tolist() == [[1.0, 2.0]] and net.scale.grad is None


def test_hooks_like_the_jax_package():
    """Pre-hooks then forward hooks, each in the order registered; what a
    hook returns is ignored; ``detach()`` removes one."""
    logs = []
    for lib, mod, x in ((jnn, "jax", jnd.ones((1, 2))),
                        (nn, "port", torch.ones(1, 2))):
        calls = []
        net = lib.Dense(2, in_units=2)
        if mod == "jax":
            net.initialize()
        else:
            net.initialize(device="cpu")
        h1 = net.register_forward_hook(
            lambda b, a, o: calls.append(("post1", len(a))) or 0.0)
        net.register_forward_hook(
            lambda b, a, o: calls.append(("post2", tuple(o.shape))))
        net.register_forward_pre_hook(
            lambda b, a: calls.append(("pre", len(a))) or (a[0] * 0,))
        out = net(x)
        h1.detach()
        net(x)
        logs.append(calls)
        want = np.asarray(out.asnumpy() if mod == "jax" else out.detach())
        assert want.shape == (1, 2) and want.any()   # the forward ran as is
    assert logs[0] == logs[1] == [("pre", 1), ("post1", 1), ("post2", (1, 2)),
                                  ("pre", 1), ("post2", (1, 2))]


def test_summary_prints_the_jax_table():
    jnet = _jax_net(5)
    net = _port_net(jnet)
    jout, out = io.StringIO(), io.StringIO()
    with redirect_stdout(jout):
        jnet.summary(jnd.ones((1, 3)))
    with redirect_stdout(out):
        net.summary(torch.ones(1, 3))
    assert out.getvalue() == jout.getvalue()
    assert "Total params: 34" in out.getvalue()
    deferred = nn.HybridSequential()
    deferred.add(nn.Dense(4), nn.Dense(2))
    deferred.initialize(device="cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        deferred.summary(torch.ones(1, 3))
    assert "Total params: 26" in buf.getvalue()


def test_apply_visits_children_first_and_returns_the_block():
    seen, jseen = [], []
    net, jnet = _port_net(), _jax_net()
    assert net.apply(lambda b: seen.append(type(b).__name__)) is net
    assert jnet.apply(lambda b: jseen.append(type(b).__name__)) is jnet
    assert seen == jseen == ["Dense", "LayerNorm", "Dense",
                             "HybridSequential"]


def test_trainer_accepts_a_parameter_dict_of_fresh_names():
    """A ``ParameterDict`` built by hand trains like a block's."""
    params = ParameterDict()
    w = params.get("w", shape=(3,), init="zeros")
    params.initialize(ctx="cpu")
    assert w.tolist() == [0.0, 0.0, 0.0]
    trainer = Trainer(params, "sgd", {"learning_rate": 0.5})
    with autograd.record():
        loss = (w * torch.tensor([1.0, 2.0, 3.0])).sum()
    autograd.backward(loss)
    trainer.step(1)
    assert w.tolist() == [-0.5, -1.0, -1.5]
