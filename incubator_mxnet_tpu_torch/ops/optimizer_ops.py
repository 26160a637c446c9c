"""Optimizer update operators (counterpart of
``incubator_mxnet_tpu/ops/optimizer_ops.py``).

The API the reference's optimizers are built on: ``nd.sgd_update``,
``nd.adam_update``, the master-weight ``mp_*`` variants, the LAMB
phases, FTRL, FTML, RMSProp, group and sparse AdaGrad, the multi-tensor
``multi_*`` family (the reference's interleaved varargs layout, w0, g0,
w1, g1, ...) and its ``preloaded_multi_*`` form, whose learning rates
and weight decays are tensors at the end.  Each op is a pure function
on tensors that returns the new weight and the new states; the
``ndarray`` module's wrappers add ``out=``, which writes them in place.

Each formula is the JAX op's, in its order of operations, so a float32
or bfloat16 update rounds where the JAX package's rounds: a Python
hyper-parameter meets a tensor as JAX's weak-typed scalar does
(``optimizer.weak_scalar``), while a tensor one (the ``preloaded``
learning rates) promotes what it multiplies, as a JAX array does.  The
``mp_*`` variants compute on the float32 master with the gradient cast
to float32 and round the weight once.  The ``multi_*`` ops are loops
over the single-tensor ops, so they equal those loops bit for bit.  The
JAX ops reach no Pallas kernel: these are plain PyTorch on either
device.

``OPS`` maps every name and alias to its function; ``multi_sum_sq`` and
``multi_lars`` are not differentiable.
"""
from __future__ import annotations

import torch

from ..optimizer.optimizer import weak_scalar as _w

__all__ = ["OPS", "NON_DIFFERENTIABLE"]

#: ``{op name or alias: function}``
OPS: dict = {}
#: the names whose outputs carry no gradient
NON_DIFFERENTIABLE: set = set()


def _register(name, aliases=(), differentiable=True):
    def deco(fn):
        for n in (name, *aliases):
            OPS[n] = fn
            if not differentiable:
                NON_DIFFERENTIABLE.add(n)
        return fn
    return deco


def _times(v, t):
    """``v * t`` as JAX computes it: a Python number ``v`` is weak-typed
    (rounded to t's dtype first), a tensor ``v`` promotes ``t``."""
    if isinstance(v, torch.Tensor):
        dtype = torch.promote_types(v.dtype, t.dtype)
        return v.to(dtype) * t.to(dtype)
    return _w(v, t) * t


def _prep(grad, rescale_grad, clip_gradient):
    """The rescaled gradient, clipped whenever ``clip_gradient >= 0``
    (so 0 zeroes it; -1, the default, is off)."""
    g = _times(rescale_grad, grad)
    if clip_gradient is not None and clip_gradient >= 0:
        c = _w(clip_gradient, g)
        g = torch.clamp(g, -c, c)
    return g


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        c = _w(clip_weights, w)
        w = torch.clamp(w, -c, c)
    return w


def _f32(t):
    return t.to(torch.float32)


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------

@_register("sgd_update")
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    return (_times(1 - lr * wd, weight) - _times(lr, g)).to(weight.dtype)


@_register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = _times(momentum, mom) - _times(lr, g + _times(wd, weight))
    return (weight + new_mom).to(weight.dtype), new_mom.to(mom.dtype)


@_register("nag_mom_update")
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + _times(wd, weight)
    new_mom = _times(momentum, mom) + g
    new_weight = weight - _times(lr, g + _times(momentum, new_mom))
    return new_weight.to(weight.dtype), new_mom.to(mom.dtype)


def _mp(out, weight):
    """The master-weight result: ``(new weight rounded to weight's dtype,
    *states, new master)``."""
    if isinstance(out, tuple):
        new_w32, *state = out
        return (new_w32.to(weight.dtype), *state, new_w32)
    return out.to(weight.dtype), out


@_register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    return _mp(sgd_update(weight32, _f32(grad), lr, wd, rescale_grad,
                          clip_gradient), weight)


@_register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    return _mp(sgd_mom_update(weight32, _f32(grad), mom, lr, momentum, wd,
                              rescale_grad, clip_gradient), weight)


@_register("mp_nag_mom_update")
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    return _mp(nag_mom_update(weight32, _f32(grad), mom, lr, momentum, wd,
                              rescale_grad, clip_gradient), weight)


# ---------------------------------------------------------------------------
# Sign-based
# ---------------------------------------------------------------------------

@_register("signsgd_update")
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return (_times(1 - lr * wd, weight)
            - _times(lr, torch.sign(g))).to(weight.dtype)


@_register("signum_update")
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = (_times(momentum, mom)
               - _times(1 - momentum, g + _times(wd, weight)))
    new_weight = (_times(1 - lr * wd_lh, weight)
                  + _times(lr, torch.sign(new_mom)))
    return new_weight.to(weight.dtype), new_mom.to(mom.dtype)


# ---------------------------------------------------------------------------
# Adam family
# ---------------------------------------------------------------------------

def _moments(g, mean, var, beta1, beta2):
    new_mean = _times(beta1, mean) + _times(1 - beta1, g)
    new_var = _times(beta2, var) + _times(1 - beta2, torch.square(g))
    return new_mean, new_var


def _adam_step(lr, new_mean, new_var, epsilon):
    """lr * mean / (sqrt(var) + epsilon)."""
    return _times(lr, new_mean) / (torch.sqrt(new_var)
                                   + _w(epsilon, new_var))


@_register("adam_update")
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient) + _times(wd, weight)
    new_mean, new_var = _moments(g, mean, var, beta1, beta2)
    new_weight = weight - _adam_step(lr, new_mean, new_var, epsilon)
    return (new_weight.to(weight.dtype), new_mean.to(mean.dtype),
            new_var.to(var.dtype))


@_register("adamw_update", aliases=("_adamw_update", "_contrib_adamw_update"))
def adamw_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay: wd applies to the weight directly, not
    through the moments."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mean, new_var = _moments(g, mean, var, beta1, beta2)
    step = _adam_step(lr, new_mean, new_var, epsilon) + _times(wd, weight)
    new_weight = weight - _times(eta, step)
    return (new_weight.to(weight.dtype), new_mean.to(mean.dtype),
            new_var.to(var.dtype))


@_register("mp_adamw_update", aliases=("_mp_adamw_update",))
def mp_adamw_update(weight, grad, mean, var, weight32, lr, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    return _mp(adamw_update(weight32, _f32(grad), mean, var, lr, beta1,
                            beta2, epsilon, wd, eta, rescale_grad,
                            clip_gradient), weight)


# ---------------------------------------------------------------------------
# RMSProp
# ---------------------------------------------------------------------------

@_register("rmsprop_update")
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """The denominator is sqrt(n) + epsilon, the reference kernel's."""
    g = _prep(grad, rescale_grad, clip_gradient) + _times(wd, weight)
    new_n = _times(gamma1, n) + _times(1 - gamma1, torch.square(g))
    new_weight = weight - _times(lr, g) / (torch.sqrt(new_n)
                                           + _w(epsilon, new_n))
    new_weight = _clip_weights(new_weight, clip_weights)
    return new_weight.to(weight.dtype), new_n.to(n.dtype)


@_register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' variant, epsilon inside the square root."""
    grad_p = _prep(grad, rescale_grad, clip_gradient) + _times(wd, weight)
    new_n = _times(gamma1, n) + _times(1 - gamma1, torch.square(grad_p))
    new_g = _times(gamma1, g_state) + _times(1 - gamma1, grad_p)
    inner = new_n - torch.square(new_g)
    new_delta = (_times(gamma2, delta) - _times(lr, grad_p)
                 / torch.sqrt(inner + _w(epsilon, inner)))
    new_weight = _clip_weights(weight + new_delta, clip_weights)
    return (new_weight.to(weight.dtype), new_n.to(n.dtype),
            new_g.to(g_state.dtype), new_delta.to(delta.dtype))


# ---------------------------------------------------------------------------
# FTRL
# ---------------------------------------------------------------------------

@_register("ftrl_update")
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    root = torch.sqrt(new_n)
    sigma = (root - torch.sqrt(n)) / _w(lr, root)
    new_z = z + g - sigma * weight
    l1 = _w(lamda1, new_z)
    den = (_w(beta, root) + root) / _w(lr, root)
    solved = -(new_z - torch.sign(new_z) * l1) / (den + _w(wd, den))
    new_weight = torch.where(torch.abs(new_z) > l1, solved,
                             torch.zeros_like(weight))
    return (new_weight.to(weight.dtype), new_z.to(z.dtype),
            new_n.to(n.dtype))


# ---------------------------------------------------------------------------
# LAMB phases
# ---------------------------------------------------------------------------

@_register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mean, new_var = _moments(g, mean, var, beta1, beta2)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / _w(1 - beta1 ** t, m)
        v = v / _w(1 - beta2 ** t, v)
    update = m / (torch.sqrt(v) + _w(epsilon, v)) + _times(wd, weight)
    return (update.to(weight.dtype), new_mean.to(mean.dtype),
            new_var.to(var.dtype))


def _tensor(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


@_register("lamb_update_phase2")
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """The trust ratio r1 / r2 (1 where either norm is 0), r1 clipped to
    the bounds that are above 0."""
    r1, r2 = _tensor(r1, weight), _tensor(r2, weight)
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=_w(lower_bound, r1))
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=_w(upper_bound, r1))
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    step = _times(lr, ratio)
    dtype = torch.promote_types(step.dtype, g.dtype)
    return (weight - step.to(dtype) * g.to(dtype)).to(weight.dtype)


@_register("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    return lamb_update_phase1(weight32, _f32(grad), mean, var, beta1, beta2,
                              epsilon, t, bias_correction, wd, rescale_grad,
                              clip_gradient)


@_register("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0):
    return _mp(lamb_update_phase2(weight32, g, r1, r2, lr, lower_bound,
                                  upper_bound), weight)


# ---------------------------------------------------------------------------
# AdaGrad variants
# ---------------------------------------------------------------------------

@_register("group_adagrad_update",
           aliases=("_contrib_group_adagrad_update",))
def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Row-wise AdaGrad: one accumulator per row of the weight."""
    g = _prep(grad, rescale_grad, clip_gradient)
    sq = torch.square(g)
    grp = sq.mean(dim=tuple(range(1, g.dim()))) if g.dim() > 1 else sq
    new_hist = history + grp
    denom = torch.sqrt(new_hist + _w(epsilon, new_hist)).reshape(
        (-1,) + (1,) * (g.dim() - 1))
    new_weight = weight - _times(lr, g) / denom
    return new_weight.to(weight.dtype), new_hist.to(history.dtype)


@_register("sparse_adagrad_update", aliases=("_sparse_adagrad_update",))
def sparse_adagrad_update(weight, grad_values, grad_indices, history, lr,
                          epsilon=1e-7, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """Lazy AdaGrad on the rows ``grad_indices`` (a row-sparse gradient
    as values and row indices, each row once): only those rows of the
    weight and the history move; epsilon outside the square root, as
    in the reference kernel; no weight decay."""
    idx = torch.as_tensor(grad_indices, device=weight.device).long()
    g = _prep(grad_values, rescale_grad, clip_gradient)
    hist_rows = history[idx] + torch.square(g)
    w_rows = weight[idx] - _times(lr, g) / (torch.sqrt(hist_rows)
                                            + _w(epsilon, hist_rows))
    return (weight.index_copy(0, idx, w_rows.to(weight.dtype)),
            history.index_copy(0, idx, hist_rows.to(history.dtype)))


# ---------------------------------------------------------------------------
# Multi-tensor family: interleaved inputs, per-tensor lrs / wds
# ---------------------------------------------------------------------------

def _each(val, i):
    return val[i] if isinstance(val, (tuple, list)) else val


def _loop(tensors, width, n, step):
    """Run ``step(i, group of width tensors)`` over the first ``n``
    groups → the outputs gathered by position: all first outputs, then
    all second ones, ..."""
    outs = [step(i, tensors[width * i:width * i + width]) for i in range(n)]
    if outs and isinstance(outs[0], tuple):
        return tuple(o[k] for k in range(len(outs[0])) for o in outs)
    return tuple(outs)


@_register("multi_sgd_update")
def multi_sgd_update(*tensors, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=None):
    n = num_weights if num_weights is not None else len(tensors) // 2
    return _loop(tensors, 2, n, lambda i, t: sgd_update(
        *t, _each(lrs, i), _each(wds, i), rescale_grad, clip_gradient))


@_register("multi_sgd_mom_update")
def multi_sgd_mom_update(*tensors, lrs, wds, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=None):
    n = num_weights if num_weights is not None else len(tensors) // 3
    return _loop(tensors, 3, n, lambda i, t: sgd_mom_update(
        *t, _each(lrs, i), momentum, _each(wds, i), rescale_grad,
        clip_gradient))


@_register("multi_mp_sgd_update")
def multi_mp_sgd_update(*tensors, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    n = num_weights if num_weights is not None else len(tensors) // 3
    return _loop(tensors, 3, n, lambda i, t: mp_sgd_update(
        *t, _each(lrs, i), _each(wds, i), rescale_grad, clip_gradient))


@_register("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*tensors, lrs, wds, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    n = num_weights if num_weights is not None else len(tensors) // 4
    return _loop(tensors, 4, n, lambda i, t: mp_sgd_mom_update(
        *t, _each(lrs, i), momentum, _each(wds, i), rescale_grad,
        clip_gradient))


@_register("multi_adamw_update", aliases=("_multi_adamw_update",))
def multi_adamw_update(*tensors, lrs, wds, etas=1.0, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
                       num_weights=None):
    """Aggregated AdamW: (w, g, mean, var) x n, per-tensor lrs, wds and
    etas."""
    n = num_weights if num_weights is not None else len(tensors) // 4
    return _loop(tensors, 4, n, lambda i, t: adamw_update(
        *t, _each(lrs, i), beta1, beta2, epsilon, _each(wds, i),
        _each(etas, i), rescale_grad, clip_gradient))


@_register("multi_mp_adamw_update", aliases=("_multi_mp_adamw_update",))
def multi_mp_adamw_update(*tensors, lrs, wds, etas=1.0, beta1=0.9,
                          beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0, num_weights=None):
    n = num_weights if num_weights is not None else len(tensors) // 5
    return _loop(tensors, 5, n, lambda i, t: mp_adamw_update(
        *t, _each(lrs, i), beta1, beta2, epsilon, _each(wds, i),
        _each(etas, i), rescale_grad, clip_gradient))


def _norm(t):
    return torch.sqrt(torch.sum(torch.square(_f32(t))))


@_register("multi_lamb_update", aliases=("_multi_lamb_update",))
def multi_lamb_update(*tensors, learning_rates, wds, step_count, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, bias_correction=True,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lower_bound=-1.0, upper_bound=-1.0, num_tensors=None):
    """Aggregated LAMB: (w, g, mean, var) x n with per-tensor step
    counts; phase 1, then phase 2 with the weight's and the update's
    float32 norms."""
    n = num_tensors if num_tensors is not None else len(tensors) // 4

    def step(i, t):
        w, g, m, v = t
        upd, nm, nv = lamb_update_phase1(
            w, g, m, v, beta1, beta2, epsilon, _each(step_count, i),
            bias_correction, _each(wds, i), rescale_grad, clip_gradient)
        nw = lamb_update_phase2(w, upd, _norm(w), _norm(upd),
                                _each(learning_rates, i), lower_bound,
                                upper_bound)
        return nw, nm, nv
    return _loop(tensors, 4, n, step)


@_register("multi_mp_lamb_update", aliases=("_multi_mp_lamb_update",))
def multi_mp_lamb_update(*tensors, learning_rates, wds, step_count,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         bias_correction=True, rescale_grad=1.0,
                         clip_gradient=-1.0, lower_bound=-1.0,
                         upper_bound=-1.0, num_tensors=None):
    n = num_tensors if num_tensors is not None else len(tensors) // 5

    def step(i, t):
        w, g, m, v, w32 = t
        upd, nm, nv = lamb_update_phase1(
            w32, _f32(g), m, v, beta1, beta2, epsilon,
            _each(step_count, i), bias_correction, _each(wds, i),
            rescale_grad, clip_gradient)
        nw32 = lamb_update_phase2(w32, upd, _norm(w32), _norm(upd),
                                  _each(learning_rates, i), lower_bound,
                                  upper_bound)
        return nw32.to(w.dtype), nm, nv, nw32
    return _loop(tensors, 5, n, step)


# ---------------------------------------------------------------------------
# FTML
# ---------------------------------------------------------------------------

@_register("ftml_update")
def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """The wd-inclusive gradient is clipped as one quantity, as the
    reference kernel clips it."""
    g = _times(rescale_grad, grad) + _times(wd, weight)
    if clip_grad is not None and clip_grad >= 0:
        c = _w(clip_grad, g)
        g = torch.clamp(g, -c, c)
    new_v = _times(beta2, v) + _times(1 - beta2, torch.square(g))
    root = torch.sqrt(new_v / _w(1 - beta2 ** t, new_v))
    d_t = _times((1 - beta1 ** t) / lr, root + _w(epsilon, root))
    new_z = (_times(beta1, z) + _times(1 - beta1, g)
             - (d_t - _times(beta1, d)) * weight)
    new_weight = -new_z / d_t
    return (new_weight.to(weight.dtype), d_t.to(d.dtype),
            new_v.to(v.dtype), new_z.to(z.dtype))


# ---------------------------------------------------------------------------
# LARS support
# ---------------------------------------------------------------------------

@_register("multi_sum_sq", differentiable=False)
def multi_sum_sq(*arrays, num_arrays=None):
    """Each array's sum of squares in float32, stacked into one 1-D
    tensor."""
    n = num_arrays if num_arrays is not None else len(arrays)
    return torch.stack([torch.sum(torch.square(_f32(a)))
                        for a in arrays[:n]])


@_register("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS rates: lr · eta·|w| / (|g|·rescale + wd·|w| + eps) where both
    norms are above 0, else lr."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = _times(rescale_grad, torch.sqrt(grads_sum_sq))
    den = g_norm + wds * w_norm
    ratio = _times(eta, w_norm) / (den + _w(eps, den))
    return torch.where((w_norm > 0) & (g_norm > 0), lrs * ratio, lrs)


# ---------------------------------------------------------------------------
# preloaded_multi_*: the multi_sgd family with lrs and wds as tensors at
# the end of the inputs
# ---------------------------------------------------------------------------

@_register("preloaded_multi_sgd_update")
def preloaded_multi_sgd_update(*tensors, rescale_grad=1.0,
                               clip_gradient=-1.0, num_weights=None):
    lrs, wds, rest = tensors[-2], tensors[-1], tensors[:-2]
    n = num_weights if num_weights is not None else len(rest) // 2
    return _loop(rest, 2, n, lambda i, t: sgd_update(
        *t, lrs[i], wds[i], rescale_grad, clip_gradient))


@_register("preloaded_multi_sgd_mom_update")
def preloaded_multi_sgd_mom_update(*tensors, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0,
                                   num_weights=None):
    lrs, wds, rest = tensors[-2], tensors[-1], tensors[:-2]
    n = num_weights if num_weights is not None else len(rest) // 3
    return _loop(rest, 3, n, lambda i, t: sgd_mom_update(
        *t, lrs[i], momentum, wds[i], rescale_grad, clip_gradient))


@_register("preloaded_multi_mp_sgd_update")
def preloaded_multi_mp_sgd_update(*tensors, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=None):
    lrs, wds, rest = tensors[-2], tensors[-1], tensors[:-2]
    n = num_weights if num_weights is not None else len(rest) // 3
    return _loop(rest, 3, n, lambda i, t: mp_sgd_update(
        *t, lrs[i], wds[i], rescale_grad, clip_gradient))


@_register("preloaded_multi_mp_sgd_mom_update")
def preloaded_multi_mp_sgd_mom_update(*tensors, momentum=0.0,
                                      rescale_grad=1.0,
                                      clip_gradient=-1.0,
                                      num_weights=None):
    lrs, wds, rest = tensors[-2], tensors[-1], tensors[:-2]
    n = num_weights if num_weights is not None else len(rest) // 4
    return _loop(rest, 4, n, lambda i, t: mp_sgd_mom_update(
        *t, lrs[i], momentum, wds[i], rescale_grad, clip_gradient))
