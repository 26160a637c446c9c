"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py``).

The same base class, per-index state, update formulas, dtype behaviour
and registry names as the JAX package, for all 18 of its optimizers.
The JAX version rebinds immutable arrays; here an update is plain
PyTorch ops on the parameter and its state tensors, written in place
under ``torch.no_grad()``, so no second copy of the weights or the
state is made.  The gradient is never written: the scaled (and clipped)
gradient is a new tensor.  Each formula keeps the JAX package's order of
operations, so float32 and bfloat16 results round where the JAX
package's do.

A Python hyper-parameter meets a tensor as JAX's weak-typed scalar does
(:func:`weak_scalar`): below float32 it is rounded to the tensor's dtype
first, so a bfloat16 update rounds where the JAX package's rounds.

``multi_precision=True`` keeps a float32 master copy of every float16
or bfloat16 weight: the state is ``(master, state of the master)``, the
update runs on the master with the gradient cast to float32, and the
weight receives the master rounded to its dtype.

Where the port differs from the JAX package on purpose: ``LAMB`` and
``LARS`` raise on a float16 or bfloat16 weight without a master copy
(the JAX ones return a float32 weight, whose next mixed-precision
backward fails), and :meth:`Updater.get_states` converts nested states
to numpy at every level (the JAX one leaves a multi-precision state's
inner tuple as device arrays, which do not pickle).
"""
from __future__ import annotations

import functools
import math
import pickle

import numpy as np
import torch

from .. import random as random_mod

__all__ = ["Optimizer", "SGD", "SGLD", "Signum", "DCASGD", "NAG", "AdaGrad",
           "AdaDelta", "Adam", "AdamW", "Adamax", "Nadam", "FTRL", "FTML",
           "LARS", "LAMB", "RMSProp", "LBSGD", "Test", "Updater",
           "get_updater", "register", "create", "weak_scalar"]

_registry: dict[str, type] = {}
_LOW_PRECISION = (torch.float16, torch.bfloat16)


@functools.lru_cache(maxsize=256)  # bounded: Adam's coefficient moves
def _rounded(v, dtype):
    return torch.tensor(v, dtype=dtype).item()


def weak_scalar(v, t):
    """The Python number ``v`` as JAX meets tensor ``t`` with it: a
    weak-typed scalar takes t's dtype, so for a bfloat16 (or float16)
    tensor it is rounded to that dtype first (0.9 -> 0.8984375), where
    PyTorch would compute with it unrounded in float32.  Float32 and
    wider tensors get ``v`` unchanged.  Rounded on the host and cached:
    nothing touches the device, so a CUDA graph may capture the caller."""
    if t.dtype.is_floating_point and t.dtype.itemsize < 4:
        return _rounded(float(v), t.dtype)
    return v


def register(cls):
    """Register an optimizer class under its lower-cased name."""
    _registry[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer by its registry name (``"sgd"``, ``"lamb"``, ...;
    any case)."""
    try:
        cls = _registry[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{sorted(_registry)}") from None
    return cls(**kwargs)


class Optimizer:
    """Base optimizer.  State is kept per parameter index, as in the JAX
    package (``create_state`` / ``update(index, weight, grad, state)``);
    the trainer drives it.

    The learning rate of an update is ``lr_scheduler(num_update)`` where
    a scheduler is given (its ``base_lr`` is set to ``learning_rate``
    when that is given too), else ``learning_rate``; ``num_update``
    counts from ``begin_num_update`` and moves before the rate is read.
    A parameter's multipliers come from ``param_dict`` (its ``lr_mult``
    and ``wd_mult`` attributes, where set), else from
    :meth:`set_lr_mult`/:meth:`set_wd_mult` by index, else by the name
    ``param_idx2name`` gives the index."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: dict[int, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: dict = {}
        self.wd_mult: dict = {}

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler overwrites learning rate")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers, ``{index or name: multiplier}``."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers, ``{index or name: multiplier}``."""
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def create_state(self, index, weight):
        return None

    def _has_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """``(float32 master copy, state of the master)`` for a float16 or
        bfloat16 weight under ``multi_precision``, else
        :meth:`create_state`."""
        if self._has_master(weight):
            master = weight.detach().to(torch.float32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """Update the master copy with the gradient in float32 and give
        the weight its value rounded to the weight's dtype; without a
        master, :meth:`update`."""
        if self._has_master(weight):
            master, mstate = state
            self.update(index, master, grad.to(torch.float32), mstate)
            weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

    def _prep(self, index, weight, grad):
        """Count the update first (as the JAX package does: a scheduler
        reads the count after it moved), then return ``(lr, wd, rescaled
        and clipped gradient)``."""
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * weak_scalar(self.rescale_grad, grad)
        if self.clip_gradient is not None:
            c = weak_scalar(self.clip_gradient, g)
            g = g.clamp_(-c, c)
        return lr, wd, g

    def __getstate__(self):
        # a pickled optimizer (Updater.get_states(dump_optimizer=True))
        # leaves the parameters out: set_states keeps the live ones
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.learning_rate})"


def _plus_wd(g, wd, w):
    """``g + wd * w`` (the JAX package's L2 term), the weight decay
    rounded as a weak scalar."""
    return g + weak_scalar(wd, w) * w


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: mom = momentum·mom -
    lr·(grad + wd·w); w += mom (without momentum, w -= lr·(grad +
    wd·w)).  ``lazy_update`` matters only for sparse gradients, which
    the port does not have."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        g = g.to(weight.dtype) + weak_scalar(wd, weight) * weight
        lr = weak_scalar(lr, g)
        if state is not None:
            state.mul_(weak_scalar(self.momentum, state)).sub_(lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr/2·(grad + wd·w),
    plus N(0, lr) noise drawn in float32 and cast to the weight's dtype.
    The noise comes from ``generator`` (a ``torch.Generator``), or
    without one from the port's generator of the weight's device, which
    ``random.seed`` seeds.  Its stream is PyTorch's, not the JAX
    package's threefry."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        gen = self.generator
        if gen is None:
            gen = random_mod.generator(weight.device)
        noise = torch.randn(weight.shape, dtype=torch.float32,
                            device=gen.device, generator=gen)
        noise = noise.mul_(math.sqrt(lr)).to(weight.device, weight.dtype)
        weight.sub_(weak_scalar(lr / 2, weight) * _plus_wd(g, wd, weight))
        weight.add_(noise)


@register
class Signum(Optimizer):
    """signSGD with momentum: mom = momentum·mom - (1 - momentum)·(grad +
    wd·w); w = (1 - lr·wd_lh)·w + lr·sign(mom)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        w = weight
        decay = weak_scalar(1 - lr * self.wd_lh, w)
        if state is not None:
            state.mul_(weak_scalar(self.momentum, state)).sub_(
                weak_scalar(1 - self.momentum, g) * _plus_wd(g, wd, w))
            w.mul_(decay).add_(weak_scalar(lr, state) * torch.sign(state))
        else:
            step = weak_scalar(lr, g) * torch.sign(_plus_wd(g, wd, w))
            w.mul_(decay).sub_(step)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient plus
    lamda·g²·(w - w_prev), with optional momentum; the state keeps the
    previous weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        mom, prev = state
        w = weight
        comp = _plus_wd(g, wd, w) + \
            weak_scalar(self.lamda, g) * g * g * (w - prev)
        if mom is not None:
            mom.mul_(weak_scalar(self.momentum, mom)).sub_(
                weak_scalar(lr, comp) * comp)
            w.add_(mom)
        else:
            w.sub_(weak_scalar(lr, comp) * comp)
        prev.copy_(w)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD: g = grad + wd·w; mom = momentum·mom +
    g; w -= lr·(g + momentum·mom)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        g = _plus_wd(g, wd, weight)
        lr = weak_scalar(lr, g)
        if state is not None:
            state.mul_(weak_scalar(self.momentum, state)).add_(g)
            weight.sub_(lr * (g + weak_scalar(self.momentum, state) * state))
        else:
            weight.sub_(lr * g)


@register
class AdaGrad(Optimizer):
    """hist += g²; w -= lr·(g / sqrt(hist + eps) + wd·w)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        state.add_(g * g)
        step = g / (state + weak_scalar(self.float_stable_eps, state)
                    ).sqrt_()
        weight.sub_(weak_scalar(lr, step)
                    * (step + weak_scalar(wd, weight) * weight))


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate): running averages of g² and of the
    squared steps, with decay ``rho``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _, wd, g = self._prep(index, weight, grad)
        acc_g, acc_delta = state
        g = _plus_wd(g, wd, weight)
        rho, keep = (weak_scalar(self.rho, g), weak_scalar(1 - self.rho, g))
        eps = weak_scalar(self.epsilon, g)
        acc_g.mul_(rho).add_(keep * g * g)
        delta = (acc_delta + eps).sqrt_() / (acc_g + eps).sqrt_() * g
        acc_delta.mul_(rho).add_(keep * delta * delta)
        weight.sub_(delta)


@register
class Adam(Optimizer):
    """Adam with bias correction, as the JAX package writes it:
    m = β1·m + (1-β1)·g, v = β2·v + (1-β2)·g², then
    w -= lr·sqrt(1-β2^t)/(1-β1^t) · m/(sqrt(v) + ε), with g = grad +
    wd·w and t the parameter's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _moments(self, m, v, g):
        m.mul_(weak_scalar(self.beta1, m)).add_(
            weak_scalar(1 - self.beta1, g) * g)
        v.mul_(weak_scalar(self.beta2, v)).add_(
            weak_scalar(1 - self.beta2, g) * g * g)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, v = state
        if wd:
            g = g + weak_scalar(wd, weight) * weight
        self._moments(m, v, g)
        coef = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        weight.sub_(weak_scalar(coef, m) * m
                    / (v.sqrt() + weak_scalar(self.epsilon, v)))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: the moments see the raw
    gradient, and w -= lr·wd·w after the Adam step."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, v = state
        self._moments(m, v, g)
        coef = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        decay = weak_scalar(lr * wd, weight) * weight
        weight.sub_(weak_scalar(coef, m) * m
                    / (v.sqrt() + weak_scalar(self.epsilon, v)))
        weight.sub_(decay)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm: u = max(β2·u, |g|);
    w -= lr/(1-β1^t) · m/(u + 1e-8)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, u = state
        g = _plus_wd(g, wd, weight)
        m.mul_(weak_scalar(self.beta1, m)).add_(
            weak_scalar(1 - self.beta1, g) * g)
        torch.maximum(u * weak_scalar(self.beta2, u), g.abs(), out=u)
        coef = weak_scalar(lr / (1 - self.beta1 ** t), m)
        weight.sub_(coef * m / (u + weak_scalar(1e-8, u)))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule
    β1·(1 - 0.5·0.96^(t·schedule_decay)); the schedule's running product
    is the optimizer's, over all parameters, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, v = state
        g = _plus_wd(g, wd, weight)
        mom_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_t1 = self.beta1 * (
            1 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= mom_t
        m_sched_next = self.m_schedule * mom_t1
        g_prime = g / weak_scalar(1 - self.m_schedule, g)
        m.mul_(weak_scalar(self.beta1, m)).add_(
            weak_scalar(1 - self.beta1, g) * g)
        v.mul_(weak_scalar(self.beta2, v)).add_(
            weak_scalar(1 - self.beta2, g) * g * g)
        m_prime = m / weak_scalar(1 - m_sched_next, m)
        v_prime = v / weak_scalar(1 - self.beta2 ** t, v)
        m_bar = weak_scalar(1 - mom_t, g) * g_prime + \
            weak_scalar(mom_t1, m) * m_prime
        weight.sub_(weak_scalar(lr, m_bar) * m_bar
                    / (v_prime.sqrt_() + weak_scalar(self.epsilon, v)))


@register
class FTRL(Optimizer):
    """Follow the regularized leader (FTRL-proximal) with L1 ``lamda1``
    and L2 ``wd``: the weight is solved from the state (z, n), not
    stepped."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        z, n = state
        lr_w = weak_scalar(lr, n)
        old_root = n.sqrt()
        n.add_(g * g)
        root = n.sqrt()
        sigma = (root - old_root) / lr_w
        z.add_(g).sub_(sigma * weight)
        l1 = weak_scalar(self.lamda1, z)
        solved = -(z - torch.sign(z) * l1) / (
            (weak_scalar(self.beta, root) + root) / lr_w
            + weak_scalar(wd, root))
        weight.copy_(torch.where(z.abs() > l1, solved,
                                 torch.zeros_like(weight)))


@register
class FTML(Optimizer):
    """Follow the moving leader: d, v, z as the JAX package keeps them;
    the weight is -z/d."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        d, v, z = state
        w = weight
        g = _plus_wd(g, wd, w)
        v.mul_(weak_scalar(self.beta2, v)).add_(
            weak_scalar(1 - self.beta2, g) * g * g)
        d_t = weak_scalar((1 - self.beta1 ** t) / lr, v) * (
            (v / weak_scalar(1 - self.beta2 ** t, v)).sqrt_()
            + weak_scalar(self.epsilon, v))
        sigma = d_t - weak_scalar(self.beta1, d) * d
        z.mul_(weak_scalar(self.beta1, z)).add_(
            weak_scalar(1 - self.beta1, g) * g).sub_(sigma * w)
        d.copy_(d_t)
        torch.div(-z, d_t, out=w)


def _require_master(opt, weight):
    if weight.dtype in _LOW_PRECISION:
        raise ValueError(
            f"{type(opt).__name__} on a {weight.dtype} weight needs a "
            "float32 master copy: pass multi_precision=True (without it "
            "the layer-wise norms and trust ratio are float32 and the "
            "JAX package returns the weight as float32, which breaks "
            "the next mixed-precision backward)")


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the gradient (with weight decay)
    scaled by eta·|w| / (|g| + wd·|w| + eps), 1 where either norm is 0,
    then SGD with momentum.  Needs float32 weights, or float32 masters
    through ``multi_precision``."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        _require_master(self, weight)
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _require_master(self, weight)
        lr, wd, g = self._prep(index, weight, grad)
        w = weight
        w_norm = torch.linalg.vector_norm(w)
        g_norm = torch.linalg.vector_norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones((), dtype=w_norm.dtype, device=w.device))
        g = _plus_wd(g, wd, w) * trust
        if state is not None:
            state.mul_(self.momentum).sub_(lr * g)
            w.add_(state)
        else:
            w.sub_(lr * g)


@register
class LAMB(Optimizer):
    """Layer-wise Adam for large batches: Adam's step r (bias-corrected
    moments, plus wd·w) scaled by the trust ratio |w| / |r|, 1 where
    either norm is 0; ``lower_bound``/``upper_bound`` clamp |w|.  Needs
    float32 weights, or float32 masters through ``multi_precision``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        _require_master(self, weight)
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _require_master(self, weight)
        lr, wd, g = self._prep(index, weight, grad)
        t = self._index_update_count[index]
        m, v = state
        w = weight
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        mh, vh = m, v
        if self.bias_correction:
            mh = m / (1 - self.beta1 ** t)
            vh = v / (1 - self.beta2 ** t)
        r = mh / (vh.sqrt() + self.epsilon)
        if wd:
            r.add_(wd * w)
        w_norm = torch.linalg.vector_norm(w)
        if self.lower_bound is not None:
            w_norm = w_norm.clamp(min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp(max=self.upper_bound)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), dtype=w_norm.dtype,
                                       device=w.device))
        w.sub_((lr * ratio) * r)


@register
class RMSProp(Optimizer):
    """RMSProp: n = (1-γ1)·g² + γ1·n, w -= lr·g/(sqrt(n) + ε); with
    ``centered``, Graves' form with the mean gradient and the momentum
    γ2 of the step.  ``clip_weights`` clips the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (torch.zeros_like(weight), torch.zeros_like(weight), torch.zeros_like(weight))
        return (torch.zeros_like(weight),)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, g = self._prep(index, weight, grad)
        w = weight
        g = _plus_wd(g, wd, w)
        keep, fresh = (weak_scalar(self.gamma1, g),
                       weak_scalar(1 - self.gamma1, g))
        eps = weak_scalar(self.epsilon, g)
        n = state[0]
        n.mul_(keep).add_(fresh * g * g)
        if self.centered:
            _, mg, delta = state
            mg.mul_(keep).add_(fresh * g)
            delta.mul_(weak_scalar(self.gamma2, delta)).sub_(
                weak_scalar(lr, g) * g / (n - mg * mg + eps).sqrt_())
            w.add_(delta)
        else:
            w.sub_(weak_scalar(lr, g) * g / (n.sqrt() + eps))
        if self.clip_weights:
            c = weak_scalar(self.clip_weights, w)
            w.clamp_(-c, c)


@register
class LBSGD(SGD):
    """Large-batch SGD: SGD's update; the warm-up arguments are taken and
    kept, as in the JAX package (layer-wise scaling is LARS)."""

    def __init__(self, learning_rate=0.01, momentum=0.0,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kwargs)
        self.warmup_strategy = warmup_strategy


@register
class Test(Optimizer):
    """The reference's test optimizer: w += rescale_grad·grad, and the
    state holds the new weight."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.add_(grad * weak_scalar(self.rescale_grad, grad))
        state.copy_(weight)


def _to_numpy(state):
    """A state as the JAX package's states file holds it: every tensor, at
    any depth of nesting, as a numpy array (bfloat16 as float32, which
    holds it exactly)."""
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()
    if isinstance(state, (tuple, list)):
        return tuple(_to_numpy(s) for s in state)
    return state


def _copy_into(state, saved, where):
    """Copy a saved state (numpy arrays, nested as ``state``) into the
    freshly created ``state`` in place: its device and dtype stay."""
    if isinstance(state, torch.Tensor):
        if not hasattr(saved, "shape"):
            raise ValueError(f"optimizer state {where}: the saved state "
                             "does not have the optimizer's structure "
                             "(another optimizer or multi_precision "
                             "setting?)")
        arr = np.asarray(saved)
        if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16
            arr = arr.astype(np.float32)
        if tuple(arr.shape) != tuple(state.shape):
            raise ValueError(f"optimizer state {where}: saved shape "
                             f"{arr.shape}, the weight's {tuple(state.shape)}")
        state.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        return
    if state is None or saved is None:
        if state is not saved:
            raise ValueError(f"optimizer state {where}: saved {saved!r}, "
                             f"the optimizer's {state!r}")
        return
    if not isinstance(saved, (tuple, list)) or len(saved) != len(state):
        raise ValueError(f"optimizer state {where}: the saved state does not "
                         "have the optimizer's structure (another optimizer "
                         "or multi_precision setting?)")
    for i, (s, v) in enumerate(zip(state, saved)):
        _copy_into(s, v, f"{where}[{i}]")


class Updater:
    """Applies an optimizer by index, creating each index's state at its
    first update.

    :meth:`get_states` pickles ``{index: state as numpy}``, the JAX
    package's states format; :meth:`set_states` takes such a file
    (written by either package) and keeps it aside: at an index's next
    update the optimizer's state is created on the weight's device and
    the saved values are copied into it, so the update continues from
    them, in the weight's device and dtype."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: dict = {}
        self._saved: dict = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            state = self.optimizer.create_state_multi_precision(index,
                                                                weight)
            if index in self._saved:
                _copy_into(state, self._saved.pop(index), f"index {index}")
            self.states[index] = state
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        states = dict(self._saved)
        states.update({k: _to_numpy(v) for k, v in self.states.items()})
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states_bytes):
        data = pickle.loads(states_bytes)
        if isinstance(data, tuple):
            states, optimizer = data
            optimizer.param_dict = self.optimizer.param_dict
            self.optimizer = optimizer
        else:
            states = data
        self.states = {}
        self._saved = dict(states)


def get_updater(optimizer):
    return Updater(optimizer)
