"""The port's whole-step trainer (``incubator_mxnet_tpu_torch/fuse.py``)
against the JAX package's ``FusedTrainStep``, and against the port's
own eager ``Trainer``, on the CPU (where the step runs eagerly; the
CUDA-graph replay is held against the eager step on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

* ``test_fuse.py:_net`` of the JAX package (conv, BatchNorm, ReLU,
  global pooling, Flatten, Dense), its weights carried across, 3 steps
  of sgd (with wd), nag, adam and adamw: each step's loss, then every
  parameter and moving statistic after ``write_back``, against JAX's
  ``FusedTrainStep``;
* the same net, 3 fused steps against 3 eager ``Trainer`` steps (sgd,
  adam: the port's optimizers) on the batch-mean loss, as
  ``test_fuse.py``'s ``test_fused_step_matches_eager_trainer``;
* the block unchanged until ``write_back``, the moving statistics
  updated, the loss falling, an unknown optimizer refused;
* the small fused ResNet of ``tests/test_torch_resnet_train.py``, 3 SGD
  steps (momentum, wd) against JAX's ``FusedTrainStep``;
* ``python -m incubator_mxnet_tpu_torch.bench --device cpu`` at a tiny
  size: one JSON line, tagged ``_cpu``, with no device metric;
* the four update functions alone on a (256, 64) weight, gradient and
  state, 3 steps: in bfloat16 bit for bit against the JAX package's
  ``_sgd_update`` ... ``_adamw_update`` called op by op (each Python
  hyper-parameter rounded to bfloat16 first, as JAX rounds a weak-typed
  scalar); in float32 bit for bit against the formulas with unrounded
  scalars (nothing moved there) and within 1e-6 of JAX's.  The JAX
  functions run un-jitted: under ``jit`` XLA's CPU backend keeps excess
  precision across fused bfloat16 ops and contracts float32 ones into
  FMAs, which is not the op-by-op arithmetic either package defines.

Tolerances, float32: losses 1e-5 relative; parameters and moving
statistics STEP_TOL = 1e-5 of the largest |JAX| value of each tensor
for the small net (the same formulas, sums in another order), except
Adam's and AdamW's (ADAM_TOL = 1e-4: a first Adam step is lr * g / |g|,
which turns a gradient entry near zero, and its rounding, into a
full-size step).  The ResNet: MODEL_TOL = 2e-4, the bound
``tests/test_torch_resnet_train.py`` holds the same model's gradients
to, set above its measured response to rounding (about 1.1e-5).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import fuse as jax_fuse
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.fuse import make_fused_train_step as jax_fused
from incubator_mxnet_tpu.gluon import nn as jax_nn
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet

from incubator_mxnet_tpu_torch import autograd, bench
from incubator_mxnet_tpu_torch import fuse as port_fuse
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.fuse import (FusedTrainStep,
                                            make_fused_train_step)
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1, ResNetV1)

STEP_TOL, ADAM_TOL, MODEL_TOL = 1e-5, 1e-4, 2e-4
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    for k, v in {"MXNET_USE_PALLAS": "0", "MXNET_FUSED_CONV3": "0"}.items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net(seed=0):
    """``tests/test_fuse.py:_net``."""
    mx.random.seed(seed)
    net = jax_nn.HybridSequential()
    net.add(jax_nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            jax_nn.BatchNorm(in_channels=4), jax_nn.Activation("relu"),
            jax_nn.GlobalAvgPool2D(), jax_nn.Flatten(),
            jax_nn.Dense(5, in_units=4))
    net.initialize()
    net(nd.random.uniform(shape=(1, 3, 8, 8)))  # materialize shapes
    return net


def _port_net(weights):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5, in_units=4))
    params_from_jax(weights, net)
    return net


def _weights(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _data(bs=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(bs, 3, 8, 8).astype("f"),
            rng.randint(0, 5, (bs,)).astype("i4"))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, (
        f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}")


def _params(net):
    return {k: p.detach().numpy().copy()
            for k, p in net.collect_params().items()}


@pytest.mark.parametrize("opt,params", OPTIMIZERS)
def test_fused_step_matches_jax_fused_step(opt, params):
    x, y = _data()
    jnet = _jax_net()
    net = _port_net(_weights(jnet))
    jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(), opt,
                      dict(params))
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), opt,
                                 dict(params), device="cpu")
    for i in range(3):
        want = float(jstep(nd.array(x), nd.array(y)))
        got = step(torch.from_numpy(x), torch.from_numpy(y))
        assert got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-5,
                                   err_msg=f"{opt} step {i}")
    jstep.write_back()
    step.write_back()
    tol = ADAM_TOL if opt.startswith("adam") else STEP_TOL
    want = _weights(jnet)
    for name, v in _params(net).items():
        _close(v, want[name], tol, f"{opt} {name}")


@pytest.mark.parametrize("opt,params", [OPTIMIZERS[0], OPTIMIZERS[2]])
def test_fused_step_matches_the_eager_trainer(opt, params):
    """3 fused steps == 3 eager record / backward / ``Trainer.step(1)``
    steps on the batch-mean loss (the fused gradients are of the mean)."""
    x, y = (torch.from_numpy(a) for a in _data())
    weights = _weights(_jax_net())
    eager = _port_net(weights)
    trainer = Trainer(eager.collect_params(), opt, dict(params))
    loss_fn = SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = loss_fn(eager(x), y).mean()
        autograd.backward(loss)
        trainer.step(1)
        losses.append(loss.item())
    net = _port_net(weights)
    step = make_fused_train_step(net, loss_fn, opt, dict(params),
                                 device="cpu")
    fused = [step(x, y).item() for _ in range(3)]
    step.write_back()
    np.testing.assert_allclose(fused, losses, rtol=1e-5)
    want = _params(eager)
    tol = ADAM_TOL if opt == "adam" else STEP_TOL
    for name, v in _params(net).items():
        _close(v, want[name], tol, f"{opt} {name}")


def test_block_is_untouched_until_write_back_and_bn_stats_move():
    x, y = (torch.from_numpy(a) for a in _data())
    net = _port_net(_weights(_jax_net()))
    before = _params(net)
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.1}, device="cpu")
    assert sorted(step.aux) == ["1.running_mean", "1.running_var"]
    assert sorted(step.params) == ["0.weight", "1.beta", "1.gamma",
                                   "5.bias", "5.weight"]
    aux0 = {k: v.clone() for k, v in step.aux.items()}
    for _ in range(2):
        step(x, y)
    for name, v in _params(net).items():
        np.testing.assert_array_equal(v, before[name], err_msg=name)
    for k, v0 in aux0.items():
        assert (step.aux[k] - v0).abs().sum() > 0, k
    step.write_back()
    after = _params(net)
    for name, v in {**step.params, **step.aux}.items():
        np.testing.assert_array_equal(after[name], v.detach().numpy())


def test_fused_step_loss_decreases():
    x, y = (torch.from_numpy(a) for a in _data(bs=8))
    net = _port_net(_weights(_jax_net()))
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "adam",
                                 {"learning_rate": 1e-2}, device="cpu")
    first = last = step(x, y).item()
    for _ in range(80):
        last = step(x, y).item()
        if last < first * 0.7:
            break
    assert last < first * 0.7, (first, last)


def test_fused_step_refuses_unknown_optimizer_and_missing_card(monkeypatch):
    net = _port_net(_weights(_jax_net()))
    with pytest.raises(ValueError, match="fused step supports"):
        make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "ftrl", {},
                              device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        FusedTrainStep(net, SoftmaxCrossEntropyLoss())


def test_small_resnet_fused_step_matches_jax():
    layers, channels = [1, 1, 1, 1], [16, 32, 64, 128, 256]
    rng = np.random.RandomState(4)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    params = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    mx.random.seed(0)
    jnet = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, layers, channels,
                               classes=10, layout="NHWC", fused=True)
    jnet.initialize(ctx=mx.cpu())
    jnet.hybridize()
    jnet(nd.array(x))                       # resolve shapes
    net = ResNetV1(BottleneckV1, layers, channels, classes=10, layout="NHWC",
                   fused=True)
    params_from_jax(_weights(jnet), net)
    jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(params))
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(params), device="cpu")
    for i in range(3):
        want = float(jstep(nd.array(x), nd.array(y)))
        got = step(torch.from_numpy(x), torch.from_numpy(y)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"step {i}")
    jstep.write_back()
    step.write_back()
    want = _weights(jnet)
    got = _params(net)
    assert len(got) == len(want) == 87
    for name, v in got.items():
        _close(v, want[name], MODEL_TOL, name)


def test_bench_runs_tagged_on_the_cpu(capsys):
    bench.main(["--device", "cpu", "--batch", "2", "--image-size", "32",
                "--classes", "10", "--steps", "1", "--warmup", "1",
                "--dtype", "float32"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    res = json.loads(line)
    assert res["metric"] == (
        "resnet50_train_img_per_sec_bs2_float32_fusedblk_cpu")
    assert res["platform"] == "cpu" and res["value"] > 0
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert "mfu_pct" not in res and "peak_memory_bytes" not in res


# bench.py's SGD scalars; Adam at lr 1e-3, wd 1e-4
UPDATES = [
    ("sgd", {"lr": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"lr": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "wd": 1e-4}),
    ("adamw", {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "wd": 1e-4}),
]


def _update_inputs(opt, seed=3, shape=(256, 64)):
    """A weight, 3 gradients and a state, float32 numpy."""
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    grads = [(0.1 * rng.randn(*shape)).astype(np.float32) for _ in range(3)]
    if opt in ("sgd", "nag"):
        state = {"mom": (0.01 * rng.randn(*shape)).astype(np.float32)}
    else:
        state = {"m": (0.01 * rng.randn(*shape)).astype(np.float32),
                 "v": np.abs(1e-4 * rng.randn(*shape)).astype(np.float32)}
    return w, grads, state


def _run_port(fn, opt, hp, w, grads, state, dtype):
    p = {"w": torch.tensor(w, dtype=dtype)}
    st = {k: {"w": torch.tensor(v, dtype=dtype)} for k, v in state.items()}
    if opt.startswith("adam"):
        st["t"] = torch.zeros((), dtype=torch.int32)
    for g in grads:
        fn({"w": torch.tensor(g, dtype=dtype)}, st, p, **hp)
    out = {"w": p["w"]}
    out.update((k, st[k]["w"]) for k in state)
    return {k: v.float().numpy() for k, v in out.items()}


def _run_jax(opt, hp, w, grads, state, dtype):
    fn = getattr(jax_fuse, f"_{opt}_update")
    p = {"w": jnp.asarray(w).astype(dtype)}
    st = {k: {"w": jnp.asarray(v).astype(dtype)} for k, v in state.items()}
    if opt.startswith("adam"):
        st["t"] = jnp.zeros((), jnp.int32)
    for g in grads:
        p, st = fn({"w": jnp.asarray(g).astype(dtype)}, st, p, **hp)
    out = {"w": p["w"]}
    out.update((k, st[k]["w"]) for k in state)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _unrounded_update(opt):
    """The update formulas with every Python scalar used as PyTorch
    takes it, unrounded: what the port computed before its scalars were
    rounded as JAX's weak types are."""
    wide = port_fuse._wide

    def sgd(grads, state, params, lr, momentum, wd):
        for k, p in params.items():
            m = state["mom"][k]
            m.copy_(momentum * m - lr * (grads[k] + wd * p))
            p.copy_(p + m)

    def nag(grads, state, params, lr, momentum, wd):
        for k, p in params.items():
            m, g = state["mom"][k], grads[k]
            m.copy_(momentum * m + g + wd * p)
            p.copy_(p - lr * (g + wd * p + momentum * m))

    def adam(grads, state, params, lr, b1, b2, eps, wd, decoupled=False):
        corr = port_fuse._adam_corr(state, b1, b2)
        for k, p in params.items():
            m, v, g = state["m"][k], state["v"][k], grads[k]
            g = g if decoupled else g + wd * p
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            new = p - lr * corr * wide(m) / (torch.sqrt(v) + eps)
            p.copy_(new - lr * wd * p if decoupled else new)

    def adamw(*args, **kw):
        adam(*args, decoupled=True, **kw)

    return {"sgd": sgd, "nag": nag, "adam": adam, "adamw": adamw}[opt]


def _mismatches(got, want):
    return {k: int((got[k] != want[k]).sum()) for k in want}


@pytest.mark.parametrize("opt,hp", UPDATES, ids=[u[0] for u in UPDATES])
def test_bfloat16_update_matches_jax_bit_for_bit(opt, hp):
    w, grads, state = _update_inputs(opt)
    fn = getattr(port_fuse, f"_{opt}_update")
    got = _run_port(fn, opt, hp, w, grads, state, torch.bfloat16)
    want = _run_jax(opt, hp, w, grads, state, jnp.bfloat16)
    assert _mismatches(got, want) == {k: 0 for k in want}
    # the unrounded scalars do not give JAX's numbers: the check can fail
    old = _run_port(_unrounded_update(opt), opt, hp, w, grads, state,
                    torch.bfloat16)
    assert sum(_mismatches(old, want).values()) > 0


@pytest.mark.parametrize("opt,hp", UPDATES, ids=[u[0] for u in UPDATES])
def test_float32_update_is_unchanged(opt, hp):
    w, grads, state = _update_inputs(opt)
    fn = getattr(port_fuse, f"_{opt}_update")
    got = _run_port(fn, opt, hp, w, grads, state, torch.float32)
    old = _run_port(_unrounded_update(opt), opt, hp, w, grads, state,
                    torch.float32)
    assert _mismatches(got, old) == {k: 0 for k in old}
    want = _run_jax(opt, hp, w, grads, state, jnp.float32)
    for k in want:
        _close(got[k], want[k], 1e-6, f"{opt} {k}")
