"""Trainer (subset of ``incubator_mxnet_tpu/gluon/trainer.py``): applies
an optimizer to a set of parameters on one device.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size`` and updates every parameter that requires a
gradient.  The JAX package's parameters have ``grad_req "write"``: each
``backward()`` overwrites the gradient.  PyTorch adds into ``.grad``
instead, so after its update the trainer sets every ``.grad`` to
``None``; the next ``backward()`` then writes fresh gradients, and two
steps in a row compute what the JAX package computes.  A parameter that
``backward()`` did not reach is updated with a zero gradient, which is
what the JAX package's zero-initialised gradient buffer gives it.

On one device there is nothing to reduce: ``kvstore`` may be ``None``,
``"device"`` or ``"local"``, and anything else raises.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt_mod

__all__ = ["Trainer"]

_ONE_DEVICE_KVSTORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
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

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """Rescale by ``1 / batch_size``, update, and clear the
        gradients.  (One device: no gradient reduction.)"""
        self.update(batch_size)

    def update(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            self._updater(i, grad, p)
        self.zero_grad()

    def zero_grad(self):
        """Drop every gradient, so the next ``backward()`` writes fresh
        ones."""
        for p in self._params:
            p.grad = None
