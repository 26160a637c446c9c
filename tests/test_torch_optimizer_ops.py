"""The port's optimizer update ops (``incubator_mxnet_tpu_torch/ops/
optimizer_ops.py``, under ``ndarray``) against the JAX package's, on the
CPU.

Every op and alias runs in float32 and in bfloat16 (the ``mp_*`` ops
with a bfloat16 weight and gradient and float32 states and master) on
(6, 5) tensors made from numpy seeds, against the JAX op's function run
op by op, un-jitted (under ``jit`` XLA's CPU backend keeps excess
precision across fused bfloat16 ops).  Each result of an op that takes
no square root and sums nothing must equal JAX's bit for bit.  XLA's CPU
square root is not correctly rounded (it differs from the IEEE one
PyTorch takes in about 0.7 % of float32 values, by one ulp), and a sum
(``multi_sum_sq``, group AdaGrad's row means, the LAMB norms) adds the
same values in another order: the results of those ops are held within
1e-6 of the largest |JAX| value of each tensor in float32, and within
one bfloat16 ulp of each value plus that in bfloat16.

The ``multi_*`` and ``preloaded_multi_*`` ops must equal the loop of the
port's single-tensor ops bit for bit; ``out=`` writes in place;
``clip_gradient=0`` zeroes the gradient; the name list equals the JAX
registry's for its ``optimizer_ops`` module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import optimizer_ops as jo
from incubator_mxnet_tpu.ops import registry as jax_registry

from incubator_mxnet_tpu_torch import ndarray as nd
from incubator_mxnet_tpu_torch.ops import optimizer_ops as po

import torch_update_op_cases as cases

DTYPES = ["float32", "bfloat16"]


def _canonical(name):
    return jax_registry.get_op(name).name


def _inputs(name, dtype, seed=0):
    """(port tensors, JAX arrays, keyword arguments) for op ``name``."""
    specs, kw = cases.case(name, seed)
    port = cases.to_torch(torch, specs, getattr(torch, dtype))
    jdt = getattr(jnp, dtype)
    jax_in = [jnp.asarray(a) if wide else jnp.asarray(a).astype(jdt)
              for a, wide in specs]
    return port, jax_in, kw


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _compare(name, dtype, got, want):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want), name
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (name, i)
        if _canonical(name) in cases.EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{name} output {i}")
            continue
        scale = np.abs(b).max()
        if dtype == "bfloat16":
            ulp = np.ldexp(1.0, np.frexp(np.abs(b))[1] - 8)
            assert (np.abs(a - b) <= ulp + 1e-6 * scale).all(), (name, i)
        else:
            assert np.abs(a - b).max() <= 1e-6 * scale, (name, i)


def test_names_equal_the_jax_registry():
    """Every op and alias of the JAX module is reachable under the
    port's ``ndarray`` by its name, and nothing else is added."""
    jax_names = sorted(n for n in jax_registry.list_ops()
                       if jax_registry.get_op(n).fn.__module__ == jo.__name__)
    assert sorted(po.OPS) == jax_names
    assert len({jax_registry.get_op(n).name for n in jax_names}) == 35
    for name in jax_names:
        assert callable(getattr(nd, name)), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(po.OPS))
def test_op_matches_jax(name, dtype):
    """Each op and alias, in float32 and bfloat16, against the JAX op."""
    port, jax_in, kw = _inputs(name, dtype)
    got = getattr(nd, name)(*port, **kw)
    want = jax_registry.get_op(name).fn(*jax_in, **kw)
    _compare(name, dtype, got, want)


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("name", ["sgd_update", "sgd_mom_update",
                                  "adam_update", "adamw_update",
                                  "rmsprop_update", "ftrl_update",
                                  "signum_update", "lamb_update_phase1",
                                  "group_adagrad_update",
                                  "sparse_adagrad_update", "mp_sgd_update"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rescale_and_clip_match_jax(name, clip, dtype):
    """``rescale_grad`` and ``clip_gradient``, clipping whenever it is
    >= 0: 0 zeroes the gradient."""
    port, jax_in, kw = _inputs(name, dtype, seed=3)
    kw = dict(kw, rescale_grad=0.5, clip_gradient=clip)
    got = getattr(nd, name)(*port, **kw)
    want = jax_registry.get_op(name).fn(*jax_in, **kw)
    _compare(name, dtype, got, want)
    if clip == 0.0 and name in ("sgd_update", "mp_sgd_update"):
        w = port[2] if name.startswith("mp") else port[0]
        # a zero gradient leaves w·(1 - lr·wd)
        want_w = po.OPS["sgd_update"](w, torch.zeros_like(w), kw["lr"],
                                      kw["wd"])
        assert torch.equal(_as_list(got)[-1].to(want_w.dtype), want_w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ftml_clips_the_gradient_with_weight_decay(dtype):
    port, jax_in, kw = _inputs("ftml_update", dtype, seed=4)
    kw = dict(kw, rescale_grad=2.0, clip_grad=0.1)
    _compare("ftml_update", dtype, nd.ftml_update(*port, **kw),
             jo.ftml_update.fn(*jax_in, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(cases.MULTI))
def test_multi_ops_equal_the_loop_of_single_ops(name, dtype):
    """A multi-tensor op equals its single op over each group, bit for
    bit, outputs gathered by position (all weights, then all states)."""
    port, _, kw = _inputs(name, dtype, seed=7)
    got = getattr(nd, name)(*port, **kw)
    roles, _ = cases.MULTI[name]
    k = len(roles)
    single = {"multi_sgd_update": "sgd_update",
              "multi_sgd_mom_update": "sgd_mom_update",
              "multi_mp_sgd_update": "mp_sgd_update",
              "multi_mp_sgd_mom_update": "mp_sgd_mom_update",
              "multi_adamw_update": "adamw_update",
              "multi_mp_adamw_update": "mp_adamw_update"}
    outs = []
    for i in range(cases.GROUPS):
        group = port[k * i:k * i + k]
        if name.startswith("preloaded"):
            lrs, wds = port[-2], port[-1]
            base = name[len("preloaded_"):]
            one = po.OPS[single[base]]
            extra = dict(kw)
            if "momentum" in extra:
                outs.append(one(*group, lrs[i], extra.pop("momentum"),
                                wds[i]))
            else:
                outs.append(one(*group, lrs[i], wds[i]))
        elif name in single:
            extra = {k2: (v[i] if isinstance(v, tuple) else v)
                     for k2, v in kw.items()}
            lr, wd = extra.pop("lrs"), extra.pop("wds")
            if "etas" in extra:
                extra["eta"] = extra.pop("etas")
            outs.append(po.OPS[single[name]](*group, lr=lr, wd=wd, **extra))
        else:                                   # the LAMB ones
            w, g, m, v = group[:4]
            mp = name == "multi_mp_lamb_update"
            base = group[4] if mp else w
            upd, nm, nv = po.OPS["lamb_update_phase1"](
                base, g.float() if mp else g, m, v,
                t=kw["step_count"][i], wd=kw["wds"][i])
            r1 = torch.sqrt(torch.sum(torch.square(base.float())))
            r2 = torch.sqrt(torch.sum(torch.square(upd.float())))
            nw = po.OPS["lamb_update_phase2"](base, upd, r1, r2,
                                              kw["learning_rates"][i])
            outs.append((nw.to(w.dtype), nm, nv, nw) if mp else (nw, nm, nv))
    if not isinstance(outs[0], tuple):
        outs = [(o,) for o in outs]
    want = [o[j] for j in range(len(outs[0])) for o in outs]
    got = _as_list(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_out_writes_in_place():
    """``out=`` (a tensor, or a tuple for several results) receives the
    results, which the op returns; a single tensor given to an op with
    several results receives the new weight."""
    port, jax_in, kw = _inputs("sgd_update", "float32")
    w = port[0]
    want = nd.sgd_update(*port, **kw)
    res = nd.sgd_update(w, port[1], out=w, **kw)
    assert res is w and torch.equal(w, want)
    port, _, kw = _inputs("adam_update", "bfloat16")
    w, g, m, v = port
    want = nd.adam_update(w.clone(), g, m.clone(), v.clone(), **kw)
    res = nd.adam_update(w, g, m, v, out=(w, m, v), **kw)
    assert res[0] is w and res[1] is m and res[2] is v
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    port, _, kw = _inputs("mp_sgd_mom_update", "bfloat16")
    w, g, mom, w32 = port
    want = nd.mp_sgd_mom_update(w.clone(), g, mom.clone(), w32.clone(),
                                **kw)
    res = nd.mp_sgd_mom_update(w, g, mom, w32, out=w, **kw)
    assert res[0] is w and torch.equal(w, want[0])
    assert all(torch.equal(a, b) for a, b in zip(res[1:], want[1:]))
    port, _, kw = _inputs("adam_update", "float32")
    with pytest.raises(ValueError):
        nd.adam_update(*port, out=tuple(port[:2]), **kw)


def test_update_ops_are_differentiable_but_the_lars_ops_not():
    w = torch.randn(4, requires_grad=True)
    g = torch.randn(4)
    nd.sgd_update(w, g, lr=0.1, wd=0.5).sum().backward()
    assert torch.allclose(w.grad, torch.full((4,), 1 - 0.1 * 0.5))
    s = nd.multi_sum_sq(w, w)
    assert not s.requires_grad and s.shape == (2,)
    lars = nd.multi_lars(torch.ones(2, requires_grad=True), s, s,
                         torch.zeros(2))
    assert not lars.requires_grad


@pytest.mark.parametrize("seed,shape", [(2, (64, 48)), (21, (1024, 1024))])
def test_ftrl_square_root_ulp_bound(monkeypatch, seed, shape):
    """The card's tolerance for FTRL: with every square root one float32
    ulp off (up or down at random), FTRL's outputs move by at most
    ``FTRL_TOL`` of their largest values at the inputs the card tests
    and ``chip_smoke.py`` use: its sigma = (sqrt(n + g²) - sqrt(n)) / lr
    cancels where g² << n."""
    specs, kw = cases.case("ftrl_update", seed=seed, shape=shape)
    args = cases.to_torch(torch, specs, torch.float32)
    want = po.OPS["ftrl_update"](*args, **kw)
    plain_sqrt = torch.sqrt
    gen = torch.Generator().manual_seed(0)

    def one_ulp_off(x):
        y = plain_sqrt(x)
        up = torch.nextafter(y, torch.full_like(y, float("inf")))
        down = torch.nextafter(y, torch.zeros_like(y))
        return torch.where(torch.rand(y.shape, generator=gen) < 0.5, up,
                           down)

    monkeypatch.setattr(torch, "sqrt", one_ulp_off)
    got = po.OPS["ftrl_update"](*args, **kw)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= cases.FTRL_TOL * scale
