"""Second derivatives through the kernels' autograd Functions.

A kernel's backward is hand-written CUDA: its gradients are written
through ``data_ptr()`` and carry no graph, so differentiating them again
(``create_graph=True``, then a second ``grad``/``backward``) would miss
every term through the kernel and give a partial result.  Each Function
therefore looks at ``torch.is_grad_enabled()`` in its backward, which
is true only under ``create_graph``:

- on a CPU tensor it recomputes its backward through the plain versions
  with grad enabled, the statistics it saved (mean, rstd, lse, the
  product) recomputed from the saved inputs so that they carry the
  graph.  The plain versions are deterministic, so the first-order
  result is what the backward gives without ``create_graph``, bit for
  bit, and its derivative is the plain composition's, as the JAX
  package's CPU path gives it;
- on a CUDA tensor it runs the kernel and ties each gradient to
  :class:`_Guard`, whose backward raises :class:`HigherOrderGradientError`
  naming the kernel, as the JAX package's Pallas path raises under a
  second ``jax.grad``.  It never swaps in the plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["HigherOrderGradientError", "guard"]


class HigherOrderGradientError(RuntimeError):
    """A second derivative was asked of a hand-written kernel's
    backward, which is not differentiable."""


class _Guard(torch.autograd.Function):
    """``apply(kernel, grad, *deps)`` → grad itself (a view), whose
    backward raises: the graph reaches ``deps`` only to refuse."""

    @staticmethod
    def forward(ctx, kernel, grad, *deps):
        ctx.kernel = kernel
        return grad

    @staticmethod
    def backward(ctx, *grads):
        raise HigherOrderGradientError(
            f"{ctx.kernel}: the backward of this hand-written kernel is "
            "not differentiable, so a second derivative through it would "
            "be partial; differentiate the plain version (the op on CPU "
            "tensors) instead")


def guard(kernel, grads, deps):
    """``grads`` (a tuple; None entries stay None), each tied to every
    tensor of ``deps`` that requires a gradient, so that differentiating
    it raises :class:`HigherOrderGradientError` naming ``kernel``."""
    deps = [d for d in deps
            if isinstance(d, torch.Tensor) and d.requires_grad]
    if not deps:
        return grads
    return tuple(None if g is None else _Guard.apply(kernel, g, *deps)
                 for g in grads)
