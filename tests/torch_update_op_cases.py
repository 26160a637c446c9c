"""Inputs for the optimizer update ops (``ops/optimizer_ops.py``), shared
by ``tests/test_torch_optimizer_ops.py`` (port against the JAX package),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (card against CPU).
Imports neither JAX nor pytest: not a test module.

:func:`case` gives, for an op name (or alias) and a seed, the inputs as
numpy arrays with, for each, whether it stays float32 in a bfloat16 run
(a master weight or an ``mp_*`` state), and the keyword arguments.
"""
import numpy as np

# canonical op names whose results take no square root and sum nothing:
# two correct implementations agree bit for bit there
EXACT = {"sgd_update", "sgd_mom_update", "nag_mom_update", "mp_sgd_update",
         "mp_sgd_mom_update", "mp_nag_mom_update", "signsgd_update",
         "signum_update", "lamb_update_phase2", "mp_lamb_update_phase2",
         "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
         "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
         "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
         "preloaded_multi_mp_sgd_mom_update"}

# card against CPU, ops outside EXACT: within TOL of each float32
# tensor's largest value (the card's sqrt differs from the CPU's by one
# ulp in about 0.6 % of values; sums run in another order).  FTRL's
# sigma = (sqrt(n + g²) - sqrt(n)) / lr cancels where g² << n, so a
# one-ulp square root moves z and the weight by more:
# tests/test_torch_optimizer_ops.py's test_ftrl_square_root_ulp_bound
# holds FTRL_TOL against square roots all one ulp off
TOL, FTRL_TOL = 5e-7, 5e-6


def card_tolerance(name):
    """The float32 share of the largest value that card and CPU may
    differ by, for an op outside EXACT."""
    return FTRL_TOL if canonical(name) == "ftrl_update" else TOL


# op -> (roles of the positional inputs, keyword arguments); a role
# ending in "32" stays float32 in the bfloat16 runs
SINGLE = {
    "sgd_update": (["w", "g"], dict(lr=0.1, wd=0.01)),
    "sgd_mom_update": (["w", "g", "m"], dict(lr=0.1, momentum=0.9,
                                              wd=0.01)),
    "nag_mom_update": (["w", "g", "m"], dict(lr=0.1, momentum=0.9,
                                              wd=0.01)),
    "mp_sgd_update": (["w", "g", "w32"], dict(lr=0.1, wd=0.01)),
    "mp_sgd_mom_update": (["w", "g", "m32", "w32"],
                          dict(lr=0.1, momentum=0.9, wd=0.01)),
    "mp_nag_mom_update": (["w", "g", "m32", "w32"],
                          dict(lr=0.1, momentum=0.9, wd=0.01)),
    "signsgd_update": (["w", "g"], dict(lr=0.1, wd=0.01)),
    "signum_update": (["w", "g", "m"], dict(lr=0.1, momentum=0.9, wd=0.01,
                                            wd_lh=0.01)),
    "adam_update": (["w", "g", "m", "pos"], dict(lr=0.01, wd=0.01)),
    "adamw_update": (["w", "g", "m", "pos"], dict(lr=0.01, wd=0.01,
                                                  eta=0.5)),
    "mp_adamw_update": (["w", "g", "m32", "pos32", "w32"],
                        dict(lr=0.01, wd=0.01, eta=0.5)),
    "rmsprop_update": (["w", "g", "pos"], dict(lr=0.01, wd=0.01,
                                               clip_weights=0.8)),
    "rmspropalex_update": (["w", "g", "pos", "g", "m"],
                           dict(lr=0.01, wd=0.01, clip_weights=0.8)),
    "ftrl_update": (["w", "g", "m", "pos"], dict(lr=0.1, lamda1=0.2,
                                                 wd=0.01)),
    "lamb_update_phase1": (["w", "g", "m", "pos"], dict(t=3, wd=0.01)),
    "lamb_update_phase2": (["w", "g", "norm32", "norm32"],
                           dict(lr=0.01, lower_bound=0.5,
                                upper_bound=1.5)),
    "mp_lamb_update_phase1": (["w", "g", "m32", "pos32", "w32"],
                              dict(t=3, wd=0.01)),
    "mp_lamb_update_phase2": (["w", "g32", "norm32", "norm32", "w32"],
                              dict(lr=0.01)),
    "group_adagrad_update": (["w", "g", "rows"], dict(lr=0.1)),
    "sparse_adagrad_update": (["w", "gvals", "idx", "pos"], dict(lr=0.1)),
    "ftml_update": (["w", "g", "pos", "pos", "m"], dict(lr=0.01, t=2,
                                                        wd=0.01)),
}
# the multi-tensor ops: roles of one group, keyword arguments; GROUPS
# groups, interleaved
GROUPS = 3
MULTI = {
    "multi_sgd_update": (["w", "g"], dict(lrs=(0.1, 0.2, 0.05),
                                          wds=(0.0, 0.01, 0.02))),
    "multi_sgd_mom_update": (["w", "g", "m"],
                             dict(lrs=(0.1, 0.2, 0.05), wds=(0.0, 0.01, 0.02),
                                  momentum=0.9)),
    "multi_mp_sgd_update": (["w", "g", "w32"],
                            dict(lrs=(0.1, 0.2, 0.05), wds=(0.0, 0.01, 0.02))),
    "multi_mp_sgd_mom_update": (["w", "g", "m32", "w32"],
                                dict(lrs=(0.1, 0.2, 0.05),
                                     wds=(0.0, 0.01, 0.02), momentum=0.9)),
    "multi_adamw_update": (["w", "g", "m", "pos"],
                           dict(lrs=(0.01, 0.02, 0.005),
                                wds=(0.0, 0.01, 0.02), etas=(1.0, 0.5, 1.0))),
    "multi_mp_adamw_update": (["w", "g", "m32", "pos32", "w32"],
                              dict(lrs=(0.01, 0.02, 0.005),
                                   wds=(0.0, 0.01, 0.02), etas=0.5)),
    "multi_lamb_update": (["w", "g", "m", "pos"],
                          dict(learning_rates=(0.01, 0.02, 0.005),
                               wds=(0.0, 0.01, 0.02), step_count=(1, 2, 3))),
    "multi_mp_lamb_update": (["w", "g", "m32", "pos32", "w32"],
                             dict(learning_rates=(0.01, 0.02, 0.005),
                                  wds=(0.0, 0.01, 0.02),
                                  step_count=(1, 2, 3))),
    "preloaded_multi_sgd_update": (["w", "g"], {}),
    "preloaded_multi_sgd_mom_update": (["w", "g", "m"], dict(momentum=0.9)),
    "preloaded_multi_mp_sgd_update": (["w", "g", "w32"], {}),
    "preloaded_multi_mp_sgd_mom_update": (["w", "g", "m32", "w32"],
                                          dict(momentum=0.9)),
}
# aliases of the JAX registry -> canonical names
ALIASES = {"_adamw_update": "adamw_update",
           "_contrib_adamw_update": "adamw_update",
           "_mp_adamw_update": "mp_adamw_update",
           "_contrib_group_adagrad_update": "group_adagrad_update",
           "_sparse_adagrad_update": "sparse_adagrad_update",
           "_multi_adamw_update": "multi_adamw_update",
           "_multi_mp_adamw_update": "multi_mp_adamw_update",
           "_multi_lamb_update": "multi_lamb_update",
           "_multi_mp_lamb_update": "multi_mp_lamb_update"}
CANONICAL = sorted(set(SINGLE) | set(MULTI) | {"multi_sum_sq", "multi_lars"})


def canonical(name):
    return ALIASES.get(name, name)


def _values(rng, role, shape):
    if role in ("w", "g", "m"):
        scale = 0.1 if role == "g" else 1.0
        return (scale * rng.randn(*shape)).astype(np.float32)
    if role == "pos":       # second moments, histories: above 0
        return (0.5 + rng.rand(*shape)).astype(np.float32)
    if role == "rows":      # group AdaGrad's per-row history
        return (0.5 + rng.rand(shape[0])).astype(np.float32)
    if role == "norm":
        return np.float32(1.0 + rng.rand())
    if role == "gvals":     # three rows of a row-sparse gradient
        return (0.1 * rng.randn(3, *shape[1:])).astype(np.float32)
    if role == "idx":
        return np.array([4, 0, 2], np.int32)
    raise ValueError(role)


def _group(rng, roles, shape):
    out = []
    for role in roles:
        wide = role.endswith("32")
        out.append((_values(rng, role[:-2] if wide else role, shape),
                    wide or role == "idx"))
    return out


def case(name, seed=0, shape=(6, 5)):
    """``([(numpy array, stays float32), ...], keyword arguments)`` for op
    ``name``: the op's positional inputs, made from ``seed``."""
    op = canonical(name)
    rng = np.random.RandomState(seed)
    if op in SINGLE:
        roles, kw = SINGLE[op]
        return _group(rng, roles, shape), dict(kw)
    if op in MULTI:
        roles, kw = MULTI[op]
        specs = [s for _ in range(GROUPS) for s in _group(rng, roles, shape)]
        if op.startswith("preloaded"):
            specs += [(np.array([0.1, 0.2, 0.05], np.float32), True),
                      (np.array([0.0, 0.01, 0.02], np.float32), True)]
        return specs, dict(kw)
    if op == "multi_sum_sq":
        return _group(rng, ["w", "g", "m"], shape), {}
    if op == "multi_lars":   # lrs, |w|², |g|², wds
        specs = [np.array([0.1, 0.2, 0.3, 0.4], np.float32),
                 np.array([4.0, 0.0, 2.5, 9.0], np.float32),
                 np.array([0.3, 1.0, 0.0, 0.7], np.float32),
                 (0.01 * rng.rand(4)).astype(np.float32)]
        return [(a, True) for a in specs], dict(eta=0.01, rescale_grad=0.5)
    raise KeyError(name)


def to_torch(torch, specs, dtype, device="cpu"):
    """The inputs as tensors on ``device``, in ``dtype`` unless they stay
    float32 (integers stay integers)."""
    out = []
    for arr, wide in specs:
        t = torch.tensor(arr, device=device)
        if not wide:
            t = t.to(dtype)
        out.append(t)
    return out
