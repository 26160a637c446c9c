"""Trainer (subset of ``incubator_mxnet_tpu/gluon/trainer.py``): applies
an optimizer to a set of parameters on one device.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size`` and updates every parameter whose ``grad_req``
is not ``"null"`` (``gluon/parameter.py``).  With ``grad_req "write"``
(the default) each ``autograd.backward`` overwrites the gradient, but
PyTorch's own ``.backward()`` adds into ``.grad``, so after its update
the trainer sets the ``.grad`` of every ``"write"`` parameter to
``None``; the next backward of either kind then writes fresh
gradients, and two steps in a row compute what the JAX package
computes.  The ``"add"`` gradients stay for the user's
``zero_grad()``, as in the JAX package, and ``"null"`` parameters are
skipped.  A parameter that the backward did not reach is updated with a
zero gradient, which is what the JAX package's zero-initialised
gradient buffer gives it.  One difference remains: a second
``update()`` without a fresh backward reapplies the JAX package's stale
``"write"`` gradient, while here it applies zeros.

The trainer may be built before a deferred parameter has its shape
(``Trainer(net.collect_params(), ...)`` before the first batch): it
holds the parameter objects, which the first forward materialises in
place, and the optimizer creates each parameter's state at its first
update.

On one device there is nothing to reduce: ``kvstore`` may be ``None``,
``"device"`` or ``"local"``, and anything else raises.

``save_states``/``load_states`` write and read the optimizer's states
(``Updater.get_states``: a pickled ``{index: numpy state}``, the JAX
package's format).  The update counts are not in that file: a resumed
run passes ``begin_num_update`` (the steps already taken) to its
optimizer, as with the JAX package.

``checkpoint_dir`` builds a ``checkpoint.AsyncCheckpointManager`` there
(keeping ``checkpoint_keep`` steps), and ``chunk_steps`` resolves the
chunk budget (``MXNET_TRAIN_CHUNK_STEPS``, default 1), as the JAX
trainer does; its elastic runtime (``elastic=True``: heartbeats,
eviction, rejoin) is not ported yet (ROADMAP §A item 11) and raises.
"""
from __future__ import annotations

import torch
from torch.nn.parameter import UninitializedParameter

from .. import optimizer as opt_mod
from ..autograd import grad_req_of
from ..base import resolve_chunk_steps

__all__ = ["Trainer"]

_ONE_DEVICE_KVSTORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", elastic=False, checkpoint_dir=None,
                 checkpoint_keep=5, chunk_steps=None):
        if elastic:
            raise NotImplementedError(
                "Trainer(elastic=True) is not ported yet: the elastic "
                "runtime (heartbeats, eviction, rejoin) comes with "
                "distribution (ROADMAP §A item 11)")
        if hasattr(params, "values"):
            params = list(params.values())
        self._params = list(params)
        if not all(isinstance(p, torch.Tensor) for p in self._params):
            raise TypeError("Trainer: params must be a dict or list of "
                            "parameters (tensors)")
        if not (kvstore is None or (isinstance(kvstore, str)
                                    and kvstore in _ONE_DEVICE_KVSTORES)):
            raise NotImplementedError(
                f"kvstore {kvstore!r} is not ported yet: this slice trains "
                "on one device (kvstore None, 'device' or 'local'); "
                "distributed kvstores are a later slice of the port")
        self._scale = 1.0
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             **(optimizer_params or {}))
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._ckpt = None
        if checkpoint_dir is not None:
            from ..checkpoint import AsyncCheckpointManager
            self._ckpt = AsyncCheckpointManager(checkpoint_dir,
                                                keep=checkpoint_keep)
        # the chunk budget: checkpoints land between K-step chunks
        self._chunk_steps = resolve_chunk_steps(chunk_steps)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size``, update, and clear the
        gradients.  (One device: no gradient reduction.)
        ``ignore_stale_grad`` is taken and not read, as in the JAX
        package: a gradient ``backward()`` did not reach is zero."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across devices: nothing to do on one device,
        as in the JAX package."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size`` and update every parameter that
        takes a gradient; then clear the ``"write"`` gradients."""
        self._optimizer.rescale_grad = self._scale / batch_size
        writes = []
        for i, p in enumerate(self._params):
            if isinstance(p, UninitializedParameter):
                raise RuntimeError(f"parameter {i} has no shape yet: run a "
                                   "forward before the first step")
            req = grad_req_of(p)
            if req == "null":
                continue
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            self._updater(i, grad, p)
            if req == "write":
                writes.append(p)
        for p in writes:
            p.grad = None

    def zero_grad(self):
        """Drop every gradient, so the next backward writes fresh ones
        (to an ``"add"`` parameter, as to zeros)."""
        for p in self._params:
            p.grad = None

    def save_states(self, fname):
        """Write the optimizer's states to ``fname``."""
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Read states written by :meth:`save_states` (of either package);
        each parameter's next update continues from them."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
