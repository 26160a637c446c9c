"""Whole-step training: forward, backward, optimizer update and BatchNorm
moving statistics as one step (counterpart of
``incubator_mxnet_tpu/fuse.py``).

The JAX package compiles the whole step into one donated-buffer XLA
program per batch shape.  Here the step owns its parameters, moving
statistics and optimizer state as tensors it updates in place (the
counterpart of donation), and on the card the first call for a batch
shape and dtype runs one step eagerly on a side stream (the warm-up:
kernels are built, libraries initialised) and then captures one whole
step — forward, backward, update, moving statistics — into a
``torch.cuda.CUDAGraph``.  Later calls copy x and y into the graph's
static inputs and replay it: one launch for the step instead of
hundreds.  On the CPU the step runs eagerly.

The update formulas (SGD with momentum, NAG, Adam, AdamW) are the JAX
package's, with its dtype behaviour: the state is ``zeros_like`` of
each parameter (after AMP a bfloat16 momentum on a bfloat16 weight, with
no float32 master copy), every parameter is written back in its own
dtype, and Adam's step count is a device tensor, so its bias correction
is computed on the device.  Each Python hyper-parameter meets a tensor
as JAX's weak-typed scalar does (``optimizer.weak_scalar``: rounded to
a bfloat16 tensor's dtype first, on the host, so the update stays
capturable); Adam's correction is a float32 tensor, as in JAX, and
promotes what it multiplies.

Not ported yet: ``mesh``/``batch_spec``, ``remat``, ``chunk_steps`` and
``chunked_loop()``, and the lint / memlint / shardlint hooks.
"""
from __future__ import annotations

import importlib

import torch
from torch.func import functional_call

from . import autograd
from .context import resolve_device
from .gluon.nn import Dropout
from .optimizer.optimizer import weak_scalar as _w

__all__ = ["FusedTrainStep", "make_fused_train_step", "sgd_init",
           "adam_init", "kernel_launches"]

# modules whose kernel wrappers keep launch counters (``*launches``)
_KERNEL_MODULES = ("layer_norm", "softmax_xent", "fused_block",
                   "fused_conv", "softmax", "rms_norm", "flash_attention")


def kernel_launches():
    """``{"<module>.<counter>": launches}`` of every kernel wrapper's
    launch counter, e.g. ``"fused_conv.dx_launches"``."""
    out = {}
    for name in _KERNEL_MODULES:
        mod = importlib.import_module(f".ops.{name}", __package__)
        for attr, value in vars(mod).items():
            if attr.endswith("launches") and isinstance(value, int):
                out[f"{name}.{attr}"] = value
    return out


def sgd_init(params):
    return {"mom": {k: torch.zeros_like(p) for k, p in params.items()}}


def adam_init(params):
    device = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def _wide(t):
    """t in float32 at least: the JAX package multiplies a state by a
    float32 device scalar, which promotes a bfloat16 state."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _sgd_update(grads, state, params, lr, momentum, wd):
    for k, p in params.items():
        m, g = state["mom"][k], grads[k]
        gw = g + _w(wd, p) * p
        m.copy_(_w(momentum, m) * m - _w(lr, gw) * gw)
        p.copy_(p + m)


def _nag_update(grads, state, params, lr, momentum, wd):
    """Nesterov momentum, the formula of optimizer.py's NAG."""
    for k, p in params.items():
        m, g = state["mom"][k], grads[k]
        m.copy_(_w(momentum, m) * m + g + _w(wd, p) * p)
        d = g + _w(wd, p) * p + _w(momentum, m) * m
        p.copy_(p - _w(lr, d) * d)


def _adam_corr(state, b1, b2):
    t = state["t"]
    t.add_(1)
    tf = t.float()
    return torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)


def _adam_update(grads, state, params, lr, b1, b2, eps, wd):
    corr = _adam_corr(state, b1, b2)
    for k, p in params.items():
        m, v, g = state["m"][k], state["v"][k], grads[k] + _w(wd, p) * p
        m.copy_(_w(b1, m) * m + _w(1 - b1, g) * g)
        g2 = torch.square(g)
        v.copy_(_w(b2, v) * v + _w(1 - b2, g2) * g2)
        p.copy_(p - lr * corr * _wide(m) / (torch.sqrt(v) + _w(eps, v)))


def _adamw_update(grads, state, params, lr, b1, b2, eps, wd):
    """Decoupled weight decay, the formula of optimizer.py's AdamW."""
    corr = _adam_corr(state, b1, b2)
    for k, p in params.items():
        m, v, g = state["m"][k], state["v"][k], grads[k]
        m.copy_(_w(b1, m) * m + _w(1 - b1, g) * g)
        g2 = torch.square(g)
        v.copy_(_w(b2, v) * v + _w(1 - b2, g2) * g2)
        p.copy_(p - lr * corr * _wide(m) / (torch.sqrt(v) + _w(eps, v))
                - _w(lr * wd, p) * p)


_UPDATES = {"sgd": _sgd_update, "nag": _nag_update, "adam": _adam_update,
            "adamw": _adamw_update}


class _Captured:
    """One batch shape's CUDA graph and its static tensors."""

    def __init__(self, graph, x, y, loss):
        self.graph, self.x, self.y, self.loss = graph, x, y, loss


class FusedTrainStep:
    """Whole train step over a block.

    Usage::

        step = make_fused_train_step(net, loss_fn, "sgd",
                                     {"learning_rate": 0.1, "momentum": 0.9})
        for x, y in data:
            loss = step(x, y)      # one step; state stays on the device
        step.write_back()          # copy the trained state into the block

    ``device`` is where the step's state lives and runs: ``cuda:0``
    unless given (raises without CUDA), or ``"cpu"``.  The block is not
    touched until :meth:`write_back`.  Trainable parameters
    (``requires_grad``) go to the optimizer; the others (BatchNorm's
    moving statistics) are the step's aux state, which the block's
    forward updates in place through ``register_state_update``.  The
    loss is the mean of ``loss_fn`` over the batch.  On the card a block
    that draws random numbers (Dropout with a rate) is refused: a graph
    replay would repeat one mask."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 device=None):
        if optimizer not in _UPDATES:
            raise ValueError(
                f"fused step supports sgd/nag/adam/adamw; got {optimizer!r} "
                "(use the eager Trainer for others)")
        self.block = block
        self.loss_block = loss_fn
        self.optimizer = optimizer
        opt = dict(optimizer_params or {})
        self.lr = opt.get("learning_rate", 0.01)
        self.momentum = opt.get("momentum", 0.0)
        self.wd = opt.get("wd", 0.0)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _refuse_random(block)
        named = block.collect_params()
        self._trainable_names = [n for n, p in named.items()
                                 if p.requires_grad]
        self._aux_names = [n for n, p in named.items() if not p.requires_grad]
        self.params = {n: named[n].detach().to(self.device, copy=True)
                       .requires_grad_(True) for n in self._trainable_names}
        self.aux = {n: named[n].detach().to(self.device, copy=True)
                    for n in self._aux_names}
        self.opt_state = (sgd_init(self.params) if optimizer in ("sgd", "nag")
                          else adam_init(self.params))
        if optimizer in ("sgd", "nag"):
            self._hyper = dict(lr=self.lr, momentum=self.momentum, wd=self.wd)
        else:
            self._hyper = dict(lr=self.lr, b1=0.9, b2=0.999, eps=1e-8,
                               wd=self.wd)
        self._graphs: dict[tuple, _Captured] = {}
        #: kernel launches recorded in each capture, by (x shape, x dtype,
        #: y shape, y dtype): what one replay launches
        self.capture_launches: dict[tuple, dict[str, int]] = {}

    def _step(self, x, y):
        """One step on the step's own state → the loss (detached)."""
        with autograd.record():
            out = functional_call(self.block, {**self.params, **self.aux},
                                  (x,))
            if isinstance(out, tuple):
                out = out[0]
            loss = self.loss_block(out, y).mean()
        names = self._trainable_names
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            _UPDATES[self.optimizer](grads, self.opt_state, self.params,
                                     **self._hyper)
        return loss.detach()

    @property
    def step_fn(self):
        """The step run eagerly, ``(x, y) -> loss``, on this step's own
        state: what one graph replay does, without the graph."""
        return self._step

    def __call__(self, x, y):
        x, y = x.to(self.device), y.to(self.device)
        if self.device.type != "cuda":
            return self._step(x, y)
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        cap = self._graphs.get(key)
        if cap is None:
            return self._warm_up_and_capture(key, x, y)
        cap.x.copy_(x)
        cap.y.copy_(y)
        cap.graph.replay()
        return cap.loss.clone()

    def _warm_up_and_capture(self, key, x, y):
        """This call's step, run eagerly on a side stream, then one whole
        step captured (not run) into a CUDA graph for later calls."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = self._step(x, y)
        current.wait_stream(side)
        loss = loss.clone()
        static_x, static_y = x.clone(), y.clone()
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        with torch.cuda.graph(graph):
            static_loss = self._step(static_x, static_y)
        after = kernel_launches()
        self.capture_launches[key] = {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}
        self._graphs[key] = _Captured(graph, static_x, static_y, static_loss)
        return loss

    @torch.no_grad()
    def write_back(self):
        """Copy the trained parameters and moving statistics into the
        block's own, each in its own dtype and on its own device."""
        named = self.block.collect_params()
        for name, val in {**self.params, **self.aux}.items():
            named[name].copy_(val)


def _refuse_random(block):
    for mod in block.modules():
        if isinstance(mod, Dropout) and mod._rate > 0:
            raise ValueError(
                f"FusedTrainStep cannot run {type(block).__name__} on the "
                f"card: it holds Dropout(rate={mod._rate}), and a CUDA "
                "graph replay would repeat one random mask every step")


def make_fused_train_step(block, loss_fn, optimizer="sgd",
                          optimizer_params=None, **kwargs):
    return FusedTrainStep(block, loss_fn, optimizer, optimizer_params,
                          **kwargs)
