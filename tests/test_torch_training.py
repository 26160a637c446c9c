"""Training through the PyTorch port against the JAX package, on the CPU.

* ``SGD`` and ``Adam`` through ``Trainer`` on one parameter, 3 steps,
  against the JAX package's trainer on the same gradients.
* The slice as a whole: a small BERT (2 layers, 64 units, vocab 100,
  dropout 0) built in JAX and hybridized, its weights carried over with
  ``params_from_jax``, and 3 Adam steps of the MLM + NSP loss of
  ``examples/train_bert.py`` in both packages.  Compared: the loss at
  each step, every gradient at each step (steps 2 and 3 would catch
  gradients that pile up across steps), the update each step makes to
  each weight, and every weight after step 3.
  Run with the JAX package on its Pallas kernels (interpret mode) and on
  its plain formulation (``MXNET_USE_PALLAS`` 1 and 0); the port always
  runs its Functions, here with their plain versions.  The JAX model is
  hybridized because its eager tape does not record ``NDArray``
  indexing (``ndarray/ndarray.py`` ``__getitem__``), so eagerly the
  packed ``qkv[0]``/``qkv[1]``/``qkv[2]`` split, ``pos_embed[:T]`` and
  the pooler's ``x[:, 0]`` pass no gradient; the whole-graph path
  differentiates them.

Tolerances (float32): one parameter rtol=atol=1e-6 (the same formulas
on the same numbers).  BERT: loss rtol 1e-5; each gradient max|Δ| <=
1e-4 · max|g| of that tensor (two layers of sums taken in another
order); each weight after 3 steps atol 2·lr = 2e-3 — an Adam step moves
a weight by about lr·sign(m), so a gradient near 0 whose sign the two
packages round differently moves it by up to 2·lr.  That bound alone
would pass a skipped or halved update, so the update itself, w_after -
w_before, is held to atol UPDATE_TOL · lr = 1e-5 on every element whose
gradient was above 1e-2 · max|g| of its tensor at every step so far:
there the gradients agree to a small fraction of themselves, and so do
Adam's moments.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.examples.train_bert import (pretraining_loss,
                                                           synthetic_batch)
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.optimizer import create

CFG = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
           num_heads=4, max_length=16, dropout=0.0)
B, T, LR = 4, 16, 1e-3
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-2


def _jax_param_steps(name, opt_params, grads, batch):
    p = jax_gluon.Parameter("w", shape=grads[0].shape)
    p.initialize(init=mx.init.Constant(0.5))
    trainer = jax_gluon.Trainer({"w": p}, name, dict(opt_params),
                                kvstore=None)
    out = []
    for g in grads:
        with jax_autograd.record():
            loss = (p.data() * nd.array(g)).sum()
        loss.backward()
        trainer.step(batch)
        out.append(p.data().asnumpy())
    return out


def _port_param_steps(name, opt_params, grads, batch):
    w = torch.nn.Parameter(torch.full(grads[0].shape, 0.5))
    trainer = Trainer({"w": w}, name, dict(opt_params), kvstore=None)
    out = []
    for g in grads:
        with autograd.record():
            loss = (w * torch.from_numpy(g)).sum()
        autograd.backward(loss)
        trainer.step(batch)
        assert w.grad is None        # the next backward writes afresh
        out.append(w.detach().numpy().copy())
    return out


@pytest.mark.parametrize("name,opt_params", [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.1, clip_gradient=0.3)),
])
def test_trainer_matches_jax_on_one_parameter(name, opt_params):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    want = _jax_param_steps(name, opt_params, grads, batch=2)
    got = _port_param_steps(name, opt_params, grads, batch=2)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {step + 1}")


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_lr_mult_and_wd_mult_match_jax(name):
    """A parameter's ``lr_mult``/``wd_mult`` attributes scale its
    learning rate and weight decay, as the JAX ``Parameter``'s do;
    rtol=atol=1e-6 as above."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(5).astype(np.float32) for _ in range(2)]
    opt = {"learning_rate": 0.1, "wd": 0.2}
    p = jax_gluon.Parameter("w", shape=(5,), lr_mult=0.5, wd_mult=3.0)
    p.initialize(init=mx.init.Constant(0.5))
    jtrainer = jax_gluon.Trainer({"w": p}, name, dict(opt), kvstore=None)
    w = torch.nn.Parameter(torch.full((5,), 0.5))
    w.lr_mult, w.wd_mult = 0.5, 3.0
    trainer = Trainer({"w": w}, name, dict(opt), kvstore=None)
    for g in grads:
        with jax_autograd.record():
            loss = (p.data() * nd.array(g)).sum()
        loss.backward()
        jtrainer.step(1)
        with autograd.record():
            loss = (w * torch.from_numpy(g)).sum()
        autograd.backward(loss)
        trainer.step(1)
        np.testing.assert_allclose(w.detach().numpy(), p.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    plain = _port_param_steps(name, opt, grads, batch=1)[-1]
    assert not np.allclose(w.detach().numpy(), plain)


def test_trainer_rejects_what_is_not_ported():
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer([w], "sgd", kvstore="dist_sync")
    with pytest.raises(ValueError, match="unknown optimizer"):
        Trainer([w], "nope")
    with pytest.raises(ValueError, match="optimizer_params"):
        Trainer([w], create("adam"), {"learning_rate": 1.0})
    t = Trainer([w], "adam", {"learning_rate": 0.5})
    assert t.learning_rate == 0.5
    t.set_learning_rate(0.25)
    assert t.optimizer.learning_rate == 0.25


def test_unreached_parameter_gets_a_zero_gradient():
    """A parameter backward did not reach is updated with zeros, as the
    JAX package's zero-initialised gradient buffer gives it: weight
    decay still applies."""
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    t = Trainer([a, b], "sgd", {"learning_rate": 0.1, "wd": 0.5})
    with autograd.record():
        loss = (a * 2).sum()
    autograd.backward(loss)
    t.step(1)
    torch.testing.assert_close(a.detach(), torch.full((3,), 1 - 0.1 * 2.5))
    torch.testing.assert_close(b.detach(), torch.full((3,), 1 - 0.1 * 0.5))


def _named(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _close_scaled(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_bert_three_adam_steps_match_jax(pallas, monkeypatch):
    monkeypatch.setenv("MXNET_USE_PALLAS", pallas)
    mx.random.seed(0)
    jnet = JaxBERT(**CFG)
    jnet.initialize()
    jnet.hybridize()
    port = BERTModel(**CFG)
    params_from_jax(_named(jnet), port)
    masked, y_mlm, y_nsp = synthetic_batch(B, T, CFG["vocab_size"])

    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": LR})
    jce = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    jx, jy_mlm, jy_nsp = (nd.array(a, dtype="int32")
                          for a in (masked, y_mlm, y_nsp))
    trainer = Trainer(port.collect_params(), "adam", {"learning_rate": LR})
    ce = SoftmaxCrossEntropyLoss()
    x, t_mlm, t_nsp = (torch.from_numpy(a) for a in (masked, y_mlm, y_nsp))

    steady = None        # elements whose gradient was large at every step
    worst_update = 0.0
    for step in range(3):
        with jax_autograd.record():
            jmlm, jnsp = jnet(jx)
            jloss = (jce(jmlm.reshape(B * T, -1), jy_mlm).mean()
                     + jce(jnsp, jy_nsp).mean())
        jloss.backward()
        with autograd.record():
            loss = pretraining_loss(port, ce, x, t_mlm, t_nsp)
        autograd.backward(loss)
        np.testing.assert_allclose(loss.item(), float(jloss.asnumpy()),
                                   rtol=1e-5, err_msg=f"loss, step {step}")
        jgrads = {k: p.grad().asnumpy()
                  for k, p in jnet.collect_params().items()}
        grads = grads_to_numpy(port)
        assert list(grads) == list(jgrads)
        for k, g in grads.items():
            _close_scaled(g, jgrads[k], GRAD_TOL, f"grad {k}, step {step}")
        large = {k: np.abs(g) > 1e-2 * np.abs(g).max()
                 for k, g in jgrads.items()}
        steady = large if steady is None else {
            k: steady[k] & large[k] for k in large}
        jbefore, before = _named(jnet), params_to_numpy(port)
        jtrainer.step(B)
        trainer.step(B)
        jafter, after = _named(jnet), params_to_numpy(port)
        for k, mask in steady.items():
            if not mask.any():
                continue
            d = np.abs((after[k] - before[k]) - (jafter[k] - jbefore[k]))[mask]
            assert d.max() <= UPDATE_TOL * LR, (k, step, d.max())
            worst_update = max(worst_update, d.max() / LR)
    assert sum(int(m.sum()) for m in steady.values()) > 1000
    print(f"worst update difference {worst_update:.3e} * lr")

    want = _named(jnet)
    got = params_to_numpy(port)
    for k, w in got.items():
        np.testing.assert_allclose(w, want[k], rtol=0, atol=2 * LR,
                                   err_msg=f"weight {k} after 3 steps")


def test_train_mode_follows_record_as_in_jax():
    """Dropout is on only in train mode, which ``record()`` turns on, as
    in the JAX package; ``nn.Module.train()`` does not switch it."""
    from incubator_mxnet_tpu_torch.gluon import nn

    drop = nn.Dropout(0.5).train()
    x = torch.ones(1000)
    states = []
    for mod in (autograd, jax_autograd):
        states.append([mod.is_recording(), mod.is_training()])
        with mod.record():
            states[-1] += [mod.is_recording(), mod.is_training()]
            with mod.pause():
                states[-1] += [mod.is_recording(), mod.is_training()]
        with mod.record(train_mode=False):
            states[-1] += [mod.is_recording(), mod.is_training()]
        with mod.train_mode():
            states[-1] += [mod.is_recording(), mod.is_training()]
    assert states[0] == states[1]
    assert torch.equal(drop(x), x)
    with autograd.record():
        assert (drop(x) == 0).any()
        with autograd.pause():
            assert torch.equal(drop(x), x) and not torch.is_grad_enabled()
    with autograd.record(train_mode=False):
        assert torch.equal(drop(x), x)
    prev = autograd.set_training(True)
    try:
        assert (drop(x) == 0).any()
    finally:
        autograd.set_training(prev)
    assert not autograd.is_training()


def test_backward_of_a_non_scalar_head_uses_ones():
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0, 3.0]))
    with autograd.record():
        y = w * w
    autograd.backward(y)
    torch.testing.assert_close(w.grad, 2 * w.detach())
    w.grad = None
    with autograd.record():
        y = w * w
    autograd.backward([y], [torch.tensor([1.0, 0.0, 2.0])])
    torch.testing.assert_close(w.grad, torch.tensor([2.0, 0.0, 12.0]))


def test_example_runs_on_the_cpu_and_learns(capsys):
    from incubator_mxnet_tpu_torch.examples import train_bert

    first, last = train_bert.main(["--smoke", "--device", "cpu",
                                   "--steps", "12"])
    assert np.isfinite([first, last]).all() and last < first
    assert "done" in capsys.readouterr().out
    first, last = train_bert.main(["--smoke", "--device", "cpu", "--amp",
                                   "--steps", "12"])
    assert np.isfinite([first, last]).all() and last < first
    assert "done" in capsys.readouterr().out
