"""The port's eager optimizers (``incubator_mxnet_tpu_torch/optimizer``)
against the JAX package's, on a (256, 64) weight over 3 updates, on the
CPU.

In bfloat16 each Python hyper-parameter (learning rate, momentum, weight
decay, the betas and their complements, epsilon, Adam's coefficient,
``rescale_grad``) meets a tensor as JAX's weak-typed scalar does: it is
rounded to bfloat16 first (0.9 -> 0.8984375).  The port's ``SGD`` and
``Adam`` then equal the JAX package's bit for bit, weight and state.  In
float32 the port's results are those of the formulas with unrounded
scalars, bit for bit (nothing moved there), and within 1e-6 of the
largest |JAX| value of each tensor (a few of Adam's weights differ from
JAX's by a float32 ulp, before this rounding and after).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import optimizer as jax_opt
from incubator_mxnet_tpu.ndarray import NDArray

from incubator_mxnet_tpu_torch import optimizer as port_opt

CASES = [
    ("SGD", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("SGD", {"learning_rate": 0.1, "wd": 1e-4, "rescale_grad": 1 / 3}),
    ("Adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("Adam", {"learning_rate": 1e-3, "wd": 1e-4, "rescale_grad": 0.3}),
]
IDS = ["sgd_momentum", "sgd_rescaled", "adam", "adam_rescaled"]


def _inputs(seed=5, shape=(256, 64)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    return w, [(0.1 * rng.randn(*shape)).astype(np.float32)
               for _ in range(3)]


def _states(state):
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


def _run_port(opt, w, grads, dtype):
    weight = torch.tensor(w, dtype=dtype)
    state = opt.create_state(0, weight)
    for g in grads:
        opt.update(0, weight, torch.tensor(g, dtype=dtype), state)
    return [t.float().numpy() for t in [weight] + _states(state)]


def _run_jax(name, kw, w, grads, dtype):
    opt = getattr(jax_opt, name)(**kw)
    weight = NDArray(jnp.asarray(w).astype(dtype))
    state = opt.create_state(0, weight)
    for g in grads:
        opt.update(0, weight, NDArray(jnp.asarray(g).astype(dtype)), state)
    return [np.asarray(t.data.astype(jnp.float32))
            for t in [weight] + _states(state)]


def _old_prep(opt, index, grad):
    opt._update_count(index)
    return opt._get_lr(index), opt._get_wd(index), grad * opt.rescale_grad


def _old_sgd(opt, index, weight, grad, state):
    lr, wd, g = _old_prep(opt, index, grad)
    g = g.to(weight.dtype) + wd * weight
    if state is not None:
        state.mul_(opt.momentum).sub_(lr * g)
        weight.add_(state)
    else:
        weight.sub_(lr * g)


def _old_adam(opt, index, weight, grad, state):
    lr, wd, g = _old_prep(opt, index, grad)
    t = opt._index_update_count[index]
    m, v = state
    if wd:
        g = g + wd * weight
    m.mul_(opt.beta1).add_((1 - opt.beta1) * g)
    v.mul_(opt.beta2).add_((1 - opt.beta2) * g * g)
    coef = lr * math.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t)
    weight.sub_(coef * m / (v.sqrt() + opt.epsilon))


def _unrounded(name, kw):
    """The port's optimizer with its update formulas as they were before
    it rounded its scalars as JAX does: every Python scalar unrounded."""
    opt = getattr(port_opt, name)(**kw)
    rule = _old_sgd if name == "SGD" else _old_adam
    opt.update = torch.no_grad()(
        lambda index, weight, grad, state: rule(opt, index, weight, grad,
                                                state))
    return opt


def _mismatches(got, want):
    assert len(got) == len(want)
    return [int((a != b).sum()) for a, b in zip(got, want)]


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_bfloat16_optimizer_matches_jax_bit_for_bit(name, kw):
    w, grads = _inputs()
    got = _run_port(getattr(port_opt, name)(**kw), w, grads, torch.bfloat16)
    want = _run_jax(name, kw, w, grads, jnp.bfloat16)
    assert _mismatches(got, want) == [0] * len(want)
    old = _run_port(_unrounded(name, kw), w, grads, torch.bfloat16)
    assert sum(_mismatches(old, want)) > 0


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_float32_optimizer_is_unchanged(name, kw):
    w, grads = _inputs()
    got = _run_port(getattr(port_opt, name)(**kw), w, grads, torch.float32)
    old = _run_port(_unrounded(name, kw), w, grads, torch.float32)
    assert _mismatches(got, old) == [0] * len(old)
    want = _run_jax(name, kw, w, grads, jnp.float32)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
