"""Losses (subset of ``incubator_mxnet_tpu/gluon/loss.py``)."""
from __future__ import annotations

from ..amp.amp import cast_args
from ..ops import index_ops, nn_ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if label.shape != pred.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    """Base loss: a scalar ``weight`` and the ``batch_axis``; a loss is
    averaged over every other axis."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = [i for i in range(loss.dim()) if i != self._batch_axis]
        if not axes:
            return loss
        (loss,) = cast_args("mean", loss)
        return loss.mean(dim=axes)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy → one loss per sample.

    Sparse integer labels on (N, C) logits along the last axis take the
    fused branch: ``nn_ops.softmax_xent``, the hand-written kernels,
    where the probabilities are never stored.  Everything else takes
    ``log_softmax`` and ``pick`` (sparse) or a sum against dense labels,
    as in the JAX package."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if (self._sparse_label and not self._from_logits and pred.dim() == 2
                and self._axis in (-1, 1)):
            loss = nn_ops.softmax_xent(pred, label).reshape(-1, 1)
            loss = _apply_weighting(loss, self._weight, sample_weight)
            return self._mean(loss)
        if not self._from_logits:
            pred = nn_ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -index_ops.pick(pred, label, axis=self._axis,
                                   keepdims=True)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
