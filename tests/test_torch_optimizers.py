"""The port's 18 optimizers against the JAX package's, on the CPU.

One test is parametrised over every optimizer (RMSProp in both
``centered`` modes) × three precisions × five options.  Each case runs 5
updates of a (12, 7) weight through each package's ``Updater`` from the
same numpy weight and gradients, and compares the weight and every
state tensor after each update:

* precisions: float32; bfloat16 with ``multi_precision`` (a float32
  master copy); bfloat16 without, where LAMB and LARS must raise in the
  port (the JAX ones return a float32 weight);
* options: weight decay; ``clip_gradient``; ``rescale_grad``; lr and wd
  multipliers by name (``param_idx2name`` with ``set_lr_mult`` and
  ``set_wd_mult``); a learning-rate schedule with a warm-up.

Tolerances.  float32: each tensor within 1e-6 of its largest |JAX|
value; LAMB and LARS 1e-5, since their norms are float32 sums in another
order than ``jnp.linalg.norm``.  bfloat16: the same bits, except where
the order of arithmetic differs (LAMB's and LARS's norms, which reach
the weight through its float32 master), and there each element within
one bfloat16 ulp of the JAX value.  SGLD's noise is the port's
generator's: the JAX run is fed the same draws (``jax.random.normal``
patched), so the rest of its update is compared as the others are; the
draws themselves are held by their properties below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import optimizer as jax_opt
from incubator_mxnet_tpu.base import registry as jax_registry
from incubator_mxnet_tpu.ndarray import NDArray
from incubator_mxnet_tpu.optimizer import lr_scheduler as jax_sched

from incubator_mxnet_tpu_torch import optimizer as port_opt
from incubator_mxnet_tpu_torch.optimizer import lr_scheduler as port_sched

SHAPE = (12, 7)
STEPS = 5
SEED = 0

# (case id, registry name, hyper-parameters)
OPTIMIZERS = [
    ("sgd", "sgd", dict(learning_rate=0.1, momentum=0.9)),
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
    ("test", "test", dict()),
]
PRECISIONS = ["float32", "bfloat16_master", "bfloat16"]
OPTIONS = ["wd", "clip_gradient", "rescale_grad", "mult", "scheduler"]
NORMS = ("lars", "lamb")        # norms summed in another order


def _options(option, sched_mod):
    if option == "wd":
        return dict(wd=0.05)
    if option == "clip_gradient":
        return dict(clip_gradient=0.05)
    if option == "rescale_grad":
        return dict(rescale_grad=1 / 3)
    if option == "mult":
        return dict(wd=0.05, param_idx2name={0: "w"})
    return dict(lr_scheduler=sched_mod.FactorScheduler(
        step=1, factor=0.7, warmup_steps=2, warmup_begin_lr=0.001))


def _make(mod, sched_mod, name, kw, option, precision):
    kw = dict(kw, **_options(option, sched_mod))
    kw["multi_precision"] = precision == "bfloat16_master"
    opt = mod.create(name, **kw)
    if option == "mult":
        opt.set_lr_mult({"w": 0.5})
        opt.set_wd_mult({"w": 2.0})
    return opt


def _inputs():
    rng = np.random.RandomState(SEED)
    w = rng.randn(*SHAPE).astype(np.float32)
    grads = [(0.1 * rng.randn(*SHAPE)).astype(np.float32)
             for _ in range(STEPS)]
    return w, grads


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _sgld_draws():
    gen = torch.Generator().manual_seed(SEED)
    return [torch.randn(SHAPE, generator=gen).numpy() for _ in range(STEPS)]


def _run_port(opt, w, grads, dtype):
    updater = port_opt.get_updater(opt)
    weight = torch.tensor(w).to(dtype)
    out = []
    for g in grads:
        updater(0, torch.tensor(g).to(dtype), weight)
        out.append([t.float().numpy().copy()
                    for t in [weight] + _flat(updater.states[0])])
    return out, weight.dtype


def _run_jax(opt, w, grads, dtype, monkeypatch):
    draws = _sgld_draws()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(draws.pop(0)))
    updater = jax_opt.get_updater(opt)
    weight = NDArray(jnp.asarray(w).astype(dtype))
    out = []
    for g in grads:
        updater(0, NDArray(jnp.asarray(g).astype(dtype)), weight)
        out.append([np.asarray(t.data.astype(jnp.float32))
                    for t in [weight] + _flat(updater.states[0])])
    return out, weight.data.dtype


def _bf16_ulp(x):
    """One bfloat16 ulp at each value of ``x`` (its 8 significant
    bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, np.maximum(e, -125) - 8)


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case,name,kw", OPTIMIZERS,
                         ids=[c for c, _, _ in OPTIMIZERS])
def test_optimizer_matches_jax(case, name, kw, precision, option,
                               monkeypatch):
    w, grads = _inputs()
    if name == "sgld":
        kw = dict(kw, generator=torch.Generator().manual_seed(SEED))
    port = _make(port_opt, port_sched, name, kw, option, precision)
    jkw = {k: v for k, v in kw.items() if k != "generator"}
    jopt = _make(jax_opt, jax_sched, name, jkw, option, precision)
    low = precision != "float32"
    jdtype = jnp.bfloat16 if low else jnp.float32
    if precision == "bfloat16" and name in NORMS:
        with pytest.raises(ValueError, match="multi_precision=True"):
            _run_port(port, w, grads, torch.bfloat16)
        _, got_dtype = _run_jax(jopt, w, grads, jdtype, monkeypatch)
        assert got_dtype == jnp.float32      # the JAX package's weight
        return
    got, dtype = _run_port(port, w, grads,
                           torch.bfloat16 if low else torch.float32)
    want, jax_dtype = _run_jax(jopt, w, grads, jdtype, monkeypatch)
    assert str(dtype).replace("torch.", "") == str(jax_dtype)
    assert port.num_update == jopt.num_update
    assert port.learning_rate == jopt.learning_rate
    for step, (g_step, w_step) in enumerate(zip(got, want)):
        assert len(g_step) == len(w_step)
        for i, (a, b) in enumerate(zip(g_step, w_step)):
            where = f"step {step + 1}, tensor {i}"
            # a float32 master (tensor 1 under multi_precision) and its
            # state are float32 tensors: held as float32
            is_low = low and (precision == "bfloat16" or i == 0)
            if not is_low:
                tol = 1e-5 if name in NORMS else 1e-6
                err = np.abs(a - b).max()
                assert err <= tol * max(np.abs(b).max(), 1e-30), (where, err)
            elif name in NORMS:
                assert (np.abs(a - b) <= _bf16_ulp(b)).all(), where
            else:
                np.testing.assert_array_equal(a, b, err_msg=where)


def test_registry_names_match_jax():
    jax_names = {k for k, v in jax_registry("optimizer")._entries.items()
                 if isinstance(v, type)}
    assert set(port_opt.optimizer._registry) == jax_names
    assert len(jax_names) == 18
    for n in jax_names:
        assert type(port_opt.create(n)).__name__ == \
            type(jax_opt.create(n)).__name__


@pytest.mark.parametrize("begin", [0, 4])
def test_begin_num_update_and_scheduler_match_jax(begin):
    """The count starts at ``begin_num_update`` and moves before the
    scheduler reads it, per index, in both packages."""
    w, grads = _inputs()
    runs = []
    for mod, sched in ((port_opt, port_sched), (jax_opt, jax_sched)):
        opt = mod.create("adam", learning_rate=0.02, begin_num_update=begin,
                         lr_scheduler=sched.PolyScheduler(
                             max_update=12, base_lr=1.0, pwr=2,
                             warmup_steps=3))
        lrs = []
        for g in grads[:3]:
            for index in (0, 1):
                opt._update_count(index)
                lrs.append((opt.num_update, opt._get_lr(index)))
        runs.append((lrs, dict(opt._index_update_count)))
    assert runs[0] == runs[1]
    assert runs[0][1] == {0: begin + 3, 1: begin + 3}


def test_set_learning_rate_under_a_scheduler_raises_as_in_jax():
    for mod, sched in ((port_opt, port_sched), (jax_opt, jax_sched)):
        opt = mod.create("sgd", lr_scheduler=sched.FactorScheduler(step=2))
        with pytest.raises(UserWarning, match="LRScheduler"):
            opt.set_learning_rate(0.5)
        plain = mod.create("sgd", learning_rate=0.1)
        plain.set_learning_rate(0.5)
        assert plain.learning_rate == 0.5


@pytest.mark.parametrize("name,which", [("lamb", "weight"), ("lamb", "step"),
                                        ("lars", "weight"),
                                        ("lars", "grad")])
def test_trust_ratio_is_one_where_a_norm_is_zero(name, which):
    """LAMB's |w|/|r| and LARS's trust fall back to 1 where a norm is 0
    (``jnp.where`` in the JAX package): a zero weight, or a zero
    gradient (LAMB's step r is 0 at a zero gradient without weight
    decay).  float32 against JAX at 1e-6, and the update is finite."""
    w, grads = _inputs()
    if which == "weight":
        w = np.zeros_like(w)
    else:
        grads = [np.zeros_like(g) for g in grads]
    kw = dict(learning_rate=0.1)
    got = port_opt.create(name, **kw)
    want = jax_opt.create(name, **kw)
    a, _ = _run_port(got, w, grads[:2], torch.float32)
    b = []
    updater = jax_opt.get_updater(want)
    weight = NDArray(jnp.asarray(w))
    for g in grads[:2]:
        updater(0, NDArray(jnp.asarray(g)), weight)
        b.append(np.asarray(weight.data))
    for x, y in zip(a, b):
        assert np.isfinite(x[0]).all()
        np.testing.assert_allclose(x[0], y, rtol=1e-6, atol=1e-6)
    if which != "weight":
        np.testing.assert_array_equal(a[-1][0], w)   # ratio 1 times r = 0


def test_sgld_noise_is_normal_with_variance_lr_and_repeats_by_seed():
    """SGLD's noise: N(0, lr) from the given generator, so the same seed
    gives the same update; with zero gradient and no weight decay the
    update is the noise alone: mean ~0, variance ~lr over 40000 draws
    (5 standard errors)."""
    lr, n = 0.04, 40000

    def run(seed):
        opt = port_opt.create("sgld", learning_rate=lr,
                              generator=torch.Generator().manual_seed(seed))
        w = torch.zeros(n)
        port_opt.get_updater(opt)(0, torch.zeros(n), w)
        return w

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    mean, var = a.mean().item(), a.var().item()
    assert abs(mean) < 5 * (lr / n) ** 0.5, mean
    assert abs(var - lr) < 5 * lr * (2 / n) ** 0.5, var


def test_multi_precision_keeps_the_weight_bfloat16_and_its_master():
    """Under ``multi_precision`` the state of a bfloat16 weight is
    ``(float32 master, state of the master)``; the weight stays bfloat16
    and is the master rounded; a float32 weight gets the plain state."""
    opt = port_opt.create("lamb", learning_rate=0.01, multi_precision=True)
    up = port_opt.get_updater(opt)
    w16 = torch.randn(8, 3).bfloat16()
    w32 = torch.randn(8, 3)
    for _ in range(2):
        up(0, torch.randn(8, 3).bfloat16(), w16)
        up(1, torch.randn(8, 3), w32)
    master, (m, v) = up.states[0]
    assert w16.dtype == torch.bfloat16
    assert master.dtype == m.dtype == v.dtype == torch.float32
    assert torch.equal(w16, master.bfloat16())
    assert len(up.states[1]) == 2 and up.states[1][0].dtype == torch.float32


def test_trainer_takes_ignore_stale_grad_and_ignores_it():
    """``Trainer.step``/``update`` take ``ignore_stale_grad`` and do not
    read it, as the JAX trainer does: the steps equal those without."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon import Trainer

    out = []
    for flag in (False, True):
        w = torch.nn.Parameter(torch.ones(4))
        t = Trainer([w], "sgd", {"learning_rate": 0.1, "wd": 0.1})
        with autograd.record():
            loss = (w * torch.arange(4.0)).sum()
        autograd.backward(loss)
        t.step(2, ignore_stale_grad=flag)
        t.update(2, ignore_stale_grad=flag)      # no gradient: zeros
        out.append(w.detach().clone())
    assert torch.equal(out[0], out[1])


def test_float16_amp_refusal_says_why():
    """float16 AMP stays refused, and the message names the missing loss
    scaler and why the JAX package is no oracle for it."""
    from incubator_mxnet_tpu_torch import amp

    with pytest.raises(NotImplementedError,
                       match="LossScaler.*cannot train in float16"):
        amp.init("float16")
