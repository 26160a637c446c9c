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
hundreds.  On the CPU the step runs eagerly.  ``chunked_loop()``
(``fuse_loop.py``) runs K steps a replay.

Random blocks (Dropout) draw as the same eager step would: a replay
advances PyTorch's default CUDA generator by what the captured step
drew, and a block's private CUDA generators (``Dropout.generator``) are
registered with each graph, so they advance too.

``remat`` (None, ``"dots"``, ``"nothing"``) trades recompute for
activation memory, as the JAX package's ``jax.checkpoint`` policies do.
The step checkpoints the block layer by layer (the children of its
``HybridSequential`` s, see :func:`remat_segments`) with
``torch.utils.checkpoint`` (non-reentrant): ``"nothing"`` keeps each
layer's input and recomputes its forward in the backward; ``"dots"``
also keeps the products — cuBLAS's and cuDNN's by selective
checkpointing, the fused 1x1 and 3x3 kernels' by their autograd
Functions (``_remat.py``) — and recomputes the elementwise tail.  A
recompute takes the first run's random draws and leaves the moving
statistics alone, so the loss and every parameter equal the step
without remat.

``donate`` (default True) is the JAX contract: with ``donate=True`` the
state is updated in place; with ``donate=False`` tensors a caller took
from ``params``, ``aux`` or ``opt_state`` before a call keep their
values (each call works on the step's own copy and hands out new
tensors after it).

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

Not ported yet: ``mesh``/``batch_spec`` (ROADMAP §A item 11) and the
lint / memlint / shardlint hooks (item 12).
"""
from __future__ import annotations

import functools
import importlib
from contextlib import contextmanager

import torch
from torch.func import functional_call

from . import _remat, autograd
from .autograd import grad_req_of
from .amp import amp as amp_mod
from .base import resolve_chunk_steps
from .context import resolve_device
from .optimizer.optimizer import weak_scalar as _w

__all__ = ["FusedTrainStep", "make_fused_train_step", "sgd_init",
           "adam_init", "kernel_launches", "remat_segments"]

# modules whose kernel wrappers keep launch counters (``*launches``)
_KERNEL_MODULES = ("layer_norm", "softmax_xent", "fused_block",
                   "fused_conv", "softmax", "rms_norm", "flash_attention",
                   "image_batch", "jpeg_decode", "int8_conv")


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


_REMAT = (None, "dots", "nothing")

# the products remat="dots" keeps (cuBLAS's and cuDNN's); the fused
# kernels' outputs are kept by their autograd Functions
_PRODUCTS = frozenset(getattr(torch.ops.aten, n) for n in (
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
    "cudnn_convolution", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention"))


def _keep_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_segments(block):
    """The layers a ``remat`` step checkpoints one at a time: the
    children of every ``HybridSequential`` reached from ``block``
    through other blocks, without descending into them (ResNet's stem
    layers, each bottleneck and the global pooling), or ``[block]``
    where there are none."""
    from .gluon.nn import HybridSequential
    out = []

    def walk(mod, in_sequence):
        for child in mod.children():
            if isinstance(child, HybridSequential):
                walk(child, True)
            elif in_sequence:
                out.append(child)
            else:
                walk(child, False)

    walk(block, isinstance(block, HybridSequential))
    return out or [block]


def _generators(block):
    """The private CUDA generators of ``block``'s layers (a Dropout's or
    a ZoneoutCell's ``generator``), each once."""
    seen = {}
    for mod in block.modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator) and gen.device.type == "cuda":
            seen[id(gen)] = gen
    return list(seen.values())


def capturing(graph):
    """Capture into ``graph`` on this thread only: another thread's CUDA
    calls meanwhile (a checkpoint writer copying a snapshot to the host)
    neither join the graph nor break the capture."""
    return torch.cuda.graph(graph, capture_error_mode="thread_local")


def _opt_leaves(opt_state):
    for key, val in opt_state.items():
        if isinstance(val, dict):
            for name, t in val.items():
                yield f"opt/{key}/{name}", t
        else:
            yield f"opt/{key}", val


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
    touched until :meth:`write_back`.  Trainable parameters (``grad_req``
    not ``"null"``) go to the optimizer; the others (BatchNorm's moving
    statistics, frozen parameters) are the step's aux state, which the
    block's forward updates in place through ``register_state_update``
    where it is a moving statistic and leaves alone otherwise.  The
    loss is the mean of ``loss_fn`` over the batch.  ``chunk_steps``
    (resolved by ``base.resolve_chunk_steps``) is the K that
    :meth:`chunked_loop` takes by default; ``remat`` and ``donate`` as
    in the module docstring."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 device=None, donate=True, remat=None, chunk_steps=None,
                 mesh=None, batch_spec=None):
        if optimizer not in _UPDATES:
            raise ValueError(
                f"fused step supports sgd/nag/adam/adamw; got {optimizer!r} "
                "(use the eager Trainer for others)")
        if remat not in _REMAT:
            raise ValueError(
                f"remat must be None, 'dots' or 'nothing'; got {remat!r}")
        if mesh is not None or batch_spec is not None:
            raise NotImplementedError(
                "FusedTrainStep(mesh=, batch_spec=) is not ported yet: the "
                "port trains on one device (ROADMAP §A item 11)")
        self.block = block
        self.loss_block = loss_fn
        self.optimizer = optimizer
        opt = dict(optimizer_params or {})
        self.lr = opt.get("learning_rate", 0.01)
        self.momentum = opt.get("momentum", 0.0)
        self.wd = opt.get("wd", 0.0)
        self.device = resolve_device(device)
        self.donate = bool(donate)
        self.remat = remat
        self.chunk_steps = resolve_chunk_steps(chunk_steps)
        named = block.collect_params()
        self._trainable_names = [n for n, p in named.items()
                                 if grad_req_of(p) != "null"]
        self._aux_names = [n for n, p in named.items()
                           if grad_req_of(p) == "null"]
        # the working state: what the step (and its graphs) update
        self._params = {n: named[n].detach().to(self.device, copy=True)
                        .requires_grad_(True) for n in self._trainable_names}
        self._aux = {n: named[n].detach().to(self.device, copy=True)
                     for n in self._aux_names}
        self._opt = (sgd_init(self._params) if optimizer in ("sgd", "nag")
                     else adam_init(self._params))
        if optimizer in ("sgd", "nag"):
            self._hyper = dict(lr=self.lr, momentum=self.momentum, wd=self.wd)
        else:
            self._hyper = dict(lr=self.lr, b1=0.9, b2=0.999, eps=1e-8,
                               wd=self.wd)
        self._segments = remat_segments(block) if remat else []
        self._publish()
        self._graphs: dict[tuple, _Captured] = {}
        #: kernel launches recorded in each capture, by (x shape, x dtype,
        #: y shape, y dtype): what one replay launches
        self.capture_launches: dict[tuple, dict[str, int]] = {}

    # -- the state ------------------------------------------------------

    def _publish(self):
        """Hand out the state: the working tensors themselves when the
        step donates, else copies of them."""
        if self.donate:
            self.params, self.aux, self.opt_state = (self._params, self._aux,
                                                     self._opt)
            return

        def copy(t):
            return t.detach().clone().requires_grad_(t.requires_grad)

        self.params = {k: copy(v) for k, v in self._params.items()}
        self.aux = {k: copy(v) for k, v in self._aux.items()}
        self.opt_state = {k: ({n: copy(t) for n, t in v.items()}
                              if isinstance(v, dict) else copy(v))
                          for k, v in self._opt.items()}

    def _begin(self):
        """Before a call without donation: take in what the caller may
        have set in the handed-out state."""
        if self.donate:
            return
        with torch.no_grad():
            work = self._tree(self._params, self._aux, self._opt)
            for key, t in self.state_tree().items():
                work[key].copy_(t)

    @staticmethod
    def _tree(params, aux, opt_state):
        out = {f"params/{k}": v for k, v in params.items()}
        out.update((f"aux/{k}", v) for k, v in aux.items())
        out.update(_opt_leaves(opt_state))
        return out

    def state_tree(self):
        """``params``, ``aux`` and ``opt_state`` as one flat ``{name:
        tensor}`` (``params/<name>``, ``aux/<name>``, ``opt/mom/<name>``,
        ``opt/t``, ...): what a checkpoint saves."""
        return self._tree(self.params, self.aux, self.opt_state)

    @torch.no_grad()
    def load_state_tree(self, tree):
        """Copy a :meth:`state_tree` (from a checkpoint: tensors or numpy
        arrays, any device) into the step's state, in place, each in its
        own dtype; every name must be present."""
        mine = self.state_tree()
        missing = sorted(set(mine) - set(tree))
        extra = sorted(set(tree) - set(mine))
        if missing or extra:
            raise KeyError(f"state tree mismatch: missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        for key, t in mine.items():
            src = torch.as_tensor(tree[key])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.device))
        self._begin()

    # -- one step -------------------------------------------------------

    @contextmanager
    def _remat_installed(self):
        """Route each remat segment's forward through a checkpoint while
        the step's forward runs."""
        for mod in self._segments:
            mod.forward = functools.partial(self._checkpointed, mod,
                                            type(mod).forward)
        try:
            yield
        finally:
            for mod in self._segments:
                del mod.forward

    def _checkpointed(self, mod, forward, *args, **kwargs):
        """``forward(mod, ...)`` under ``torch.utils.checkpoint``; its
        recompute sees the same tensors, cast policy and train mode as
        the first run, and replays the first run's kept values."""
        from torch.nn.utils.stateless import _reparametrize_module
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        region = _remat.Region(self.remat)
        bound = dict(mod.named_parameters(remove_duplicate=False))
        bound.update(mod.named_buffers(remove_duplicate=False))
        policy, training = amp_mod.current_policy(), autograd.is_training()
        runs = []

        def run(*a, **k):
            mode = (autograd.train_mode() if training
                    else autograd.predict_mode())
            with region.run(recompute=bool(runs)), mode, \
                    amp_mod.policy_scope(policy), \
                    _reparametrize_module(mod, bound):
                runs.append(1)
                return forward(mod, *a, **k)

        context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                        _keep_products)
                      if self.remat == "dots" else None)
        extra = {"context_fn": context_fn} if context_fn else {}
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)

    def _step(self, x, y):
        """One step on the step's own state → the loss (detached)."""
        with autograd.record(), self._remat_installed():
            out = functional_call(self.block, {**self._params, **self._aux},
                                  (x,))
            if isinstance(out, tuple):
                out = out[0]
            loss = self.loss_block(out, y).mean()
        names = self._trainable_names
        grads = torch.autograd.grad(loss, [self._params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self._params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            _UPDATES[self.optimizer](grads, self._opt, self._params,
                                     **self._hyper)
        return loss.detach()

    @property
    def step_fn(self):
        """The step run eagerly, ``(x, y) -> loss``, on this step's own
        state: what one graph replay does, without the graph.  A loop
        (``fuse_loop.ChunkedTrainLoop``) runs it K times in a capture."""
        return self._step

    def new_graph(self):
        """A ``torch.cuda.CUDAGraph`` with the block's private CUDA
        generators registered, so that each replay advances them."""
        graph = torch.cuda.CUDAGraph()
        for gen in _generators(self.block):
            graph.register_generator_state(gen)
        return graph

    def __call__(self, x, y):
        x, y = x.to(self.device), y.to(self.device)
        self._begin()
        if self.device.type != "cuda":
            loss = self._step(x, y)
        else:
            key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
            cap = self._graphs.get(key)
            if cap is None:
                loss = self._warm_up_and_capture(key, x, y)
            else:
                cap.x.copy_(x)
                cap.y.copy_(y)
                cap.graph.replay()
                loss = cap.loss.clone()
        self._publish()
        return loss

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
        graph = self.new_graph()
        before = kernel_launches()
        with capturing(graph):
            static_loss = self._step(static_x, static_y)
        after = kernel_launches()
        self.capture_launches[key] = {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}
        self._graphs[key] = _Captured(graph, static_x, static_y, static_loss)
        return loss

    def chunked_loop(self, chunk_steps=None):
        """A :class:`~.fuse_loop.ChunkedTrainLoop` over this step, K =
        ``chunk_steps`` or the step's own; it shares the step's state,
        so tail steps, :meth:`write_back` and checkpoints see one
        state."""
        from .fuse_loop import ChunkedTrainLoop
        return ChunkedTrainLoop(self, chunk_steps=chunk_steps)

    @torch.no_grad()
    def write_back(self):
        """Copy the trained parameters and moving statistics into the
        block's own, each in its own dtype and on its own device."""
        named = self.block.collect_params()
        for name, val in {**self.params, **self.aux}.items():
            named[name].copy_(val)


def make_fused_train_step(block, loss_fn, optimizer="sgd",
                          optimizer_params=None, **kwargs):
    return FusedTrainStep(block, loss_fn, optimizer, optimizer_params,
                          **kwargs)
