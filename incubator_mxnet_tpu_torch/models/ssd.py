"""SSD single-shot detector (counterpart of
``incubator_mxnet_tpu/models/ssd.py``; BASELINE config 4, reference
``example/ssd``).

A VGG-style backbone is cut into scale stages (two 3x3 conv + BatchNorm
+ ReLU and a 2x2 max pool each; the last stage a global max pool); every
stage emits class and box convolutions and its ``multibox_prior``
anchors.  Targets and decoding are the detection ops of
``ops/contrib_ops.py``, on the device of the predictions.
:meth:`SSD.detections` runs the class softmax through the softmax kernel
(``ops/softmax.py``); :class:`SSDLoss` uses ``log_softmax``, a PyTorch
op, as the JAX loss uses XLA's.  Parameter names are the JAX model's
(``stage0.0.weight``, ``stage0.1.gamma``, ``cls0.weight``, ...), so
``convert.params_from_jax`` carries its weights across.
"""
from __future__ import annotations

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops import contrib_ops, index_ops, nn_ops

__all__ = ["SSD", "SSDLoss", "ssd_300"]


def _feature_block(channels):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, 3, padding=1),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, 3, padding=1),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.MaxPool2D(2))
    return blk


class SSD(HybridBlock):
    """Multi-scale SSD head over a simple VGG-style backbone.

    ``num_classes`` excludes the background; ``sizes`` and ``ratios``
    give one tuple per scale stage, as in the reference example.  Stage
    i has ``base_channels · min(2^i, 4)`` channels; the last stage is a
    global max pool."""

    def __init__(self, num_classes=20,
                 sizes=((0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                        (0.71, 0.79), (0.88, 0.961)),
                 ratios=((1, 2, 0.5),) * 5,
                 base_channels=16):
        super().__init__()
        self.num_classes = num_classes
        self.sizes = sizes
        self.ratios = ratios
        self._num_stages = len(sizes)
        for i in range(self._num_stages):
            na = len(sizes[i]) + len(ratios[i]) - 1
            setattr(self, f"stage{i}",
                    _feature_block(base_channels * min(2 ** i, 4))
                    if i < self._num_stages - 1 else nn.GlobalMaxPool2D())
            setattr(self, f"cls{i}",
                    nn.Conv2D(na * (num_classes + 1), 3, padding=1))
            setattr(self, f"box{i}", nn.Conv2D(na * 4, 3, padding=1))

    def forward(self, x):
        """``x`` (B, 3, H, W) → ``(anchors (1, N, 4), cls_preds (B, C+1,
        N), box_preds (B, N·4))``.  ``cls_preds`` is a transposed view of
        the (B, N, C+1) predictions."""
        anchors, cls_preds, box_preds = [], [], []
        for i in range(self._num_stages):
            x = getattr(self, f"stage{i}")(x)
            anchors.append(contrib_ops.multibox_prior(
                x, sizes=self.sizes[i], ratios=self.ratios[i]))
            cls_preds.append(self._flatten_pred(
                getattr(self, f"cls{i}")(x), self.num_classes + 1))
            box_preds.append(self._flatten_pred(
                getattr(self, f"box{i}")(x), 4))
        box_preds = torch.cat(box_preds, dim=1)
        return (torch.cat(anchors, dim=1),
                torch.cat(cls_preds, dim=1).transpose(1, 2),
                box_preds.reshape(box_preds.shape[0], -1))

    @staticmethod
    def _flatten_pred(p, k):
        # (B, A·K, H, W) → (B, H, W, A·K) → (B, H·W·A, K)
        t = p.permute(0, 2, 3, 1)
        return t.reshape(t.shape[0], -1, k)

    # -- training / inference helpers ----------------------------------
    def targets(self, anchors, labels, cls_preds, overlap_threshold=0.5,
                negative_mining_ratio=3.0):
        """``contrib_ops.multibox_target`` (cls_target 0 = background)."""
        return contrib_ops.multibox_target(
            anchors, labels, cls_preds, overlap_threshold=overlap_threshold,
            negative_mining_ratio=negative_mining_ratio)

    def detections(self, cls_preds, box_preds, anchors, nms_threshold=0.45,
                   threshold=0.01, nms_topk=400):
        """The class softmax (the softmax kernel on the card, one launch)
        then ``contrib_ops.multibox_detection`` → (B, N, 6) rows
        ``[cls_id, score, x0, y0, x1, y1]``, -1 where dropped.  Nothing
        here is differentiated, as the JAX op is not."""
        with torch.no_grad():
            probs = nn_ops.softmax(cls_preds, axis=1)
            return contrib_ops.multibox_detection(
                probs, box_preds, anchors, nms_threshold=nms_threshold,
                threshold=threshold, nms_topk=nms_topk)


class SSDLoss:
    """Softmax cross-entropy over the classes (anchors that hard negative
    mining marked ignored contribute nothing), averaged over the rest,
    plus ``lambd`` times the smooth-L1 box loss over the matched offsets
    averaged over the matched count: the reference example's objective.
    → (B,) losses."""

    def __init__(self, lambd=1.0):
        self.lambd = lambd

    def __call__(self, cls_preds, box_preds, cls_target, loc_target,
                 loc_mask):
        logp = nn_ops.log_softmax(cls_preds, axis=1)           # (B, C+1, N)
        ignore = cls_target < 0
        safe = torch.where(ignore, torch.zeros_like(cls_target), cls_target)
        ce = -index_ops.pick(logp.transpose(1, 2), safe, axis=-1)  # (B, N)
        valid = 1.0 - ignore.to(torch.float32)
        one = torch.ones((1,), dtype=valid.dtype, device=valid.device)
        cls_loss = (ce * valid).sum(dim=-1) / torch.maximum(
            valid.sum(dim=-1), one)
        diff = (box_preds - loc_target) * loc_mask
        ad = diff.abs()
        sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
        npos = torch.maximum(loc_mask.sum(dim=-1), one)
        return cls_loss + self.lambd * (sl1.sum(dim=-1) / npos)


def ssd_300(num_classes=20, **kwargs):
    """The standard configuration (reference example/ssd's symbol zoo):
    20 classes (Pascal VOC), five scales, 4 anchors a pixel, base width
    16; its inputs are 300x300."""
    return SSD(num_classes=num_classes, **kwargs)
