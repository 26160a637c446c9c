"""Detection ops (subset of ``incubator_mxnet_tpu/ops/contrib_ops.py``):
``box_iou``, ``multibox_prior``, ``multibox_target``, ``box_nms`` and
``multibox_detection``, the SSD family.

The JAX package leaves these to XLA, so here they are plain PyTorch ops
on the tensor's own device, with no copy to the host inside them.  Each
keeps the JAX op's static shapes: NMS is a greedy loop of ``topk``
iterations over a ``(k, k)`` IoU matrix, batched over the images, and
suppressed rows are filled with -1.  The JAX ops are not differentiable
(``differentiable=False``); their outputs here carry no gradient either.

Where the JAX ops leave an order open, the port fixes one that is the
same on every device:

- two ground truths that pick the same best anchor in the forced
  (bipartite) stage of :func:`multibox_target`: the one with the higher
  index wins, by ``scatter_reduce(..., "amax")`` (JAX on the CPU keeps
  the last write, which is the same one; a CUDA scatter with duplicate
  indices keeps any of them);
- every sort is stable (``jnp.argsort`` is), so equal scores keep their
  index order, and ``argmax`` returns the first maximum, as in JAX.

Float arithmetic follows the JAX op's order: the anchors' sizes are
rounded once from Python doubles and the variances are float32 tensors
(a true division on the card too, which a Python scalar divisor would
turn into a product with its reciprocal).
"""
from __future__ import annotations

import torch

__all__ = ["box_iou", "multibox_prior", "multibox_target", "box_nms",
           "multibox_detection"]


# ----------------------------------------------------------------------
# geometry helpers
# ----------------------------------------------------------------------

def _corner_iou(a, b):
    """IoU between corner-format boxes a (..., Na, 4) and b (..., Nb, 4)
    → (..., Na, Nb)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0.0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0.0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _center_to_corner(b):
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU of boxes ``lhs`` (..., N, 4) and ``rhs`` (..., M, 4)
    in ``"corner"`` (x0, y0, x1, y1) or ``"center"`` (x, y, w, h) format
    → (..., N, M)."""
    if format not in ("corner", "center"):
        raise ValueError(f"box_iou: format {format!r} (corner, center)")
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _corner_iou(lhs, rhs)


def _variances(variances, device):
    return torch.tensor(variances, dtype=torch.float32, device=device)


# ----------------------------------------------------------------------
# MultiBoxPrior
# ----------------------------------------------------------------------

@torch.no_grad()
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes for each pixel of the feature map ``data`` (..., H,
    W), on its device: per pixel ``len(sizes) + len(ratios) - 1`` boxes,
    ``(s_i, r_0)`` for every size then ``(s_0, r_j)`` for j > 0, of
    width ``s·√r`` and height ``s/√r``, centred at ``((x + offset)·step,
    (y + offset)·step)`` with ``step = 1/W`` (``1/H``) unless given →
    (1, H·W·A, 4) corner format, clipped to [0, 1] if ``clip``.  Only
    ``data``'s shape is read."""
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    # a Python scalar times a float32 tensor: the scalar is rounded to
    # float32 first, as JAX rounds a weak-typed one
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + offsets[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")             # (H, W)
    wh = [(s * ratios[0] ** 0.5, s / ratios[0] ** 0.5) for s in sizes]
    wh += [(sizes[0] * r ** 0.5, sizes[0] / r ** 0.5) for r in ratios[1:]]
    # computed in doubles, rounded once to float32
    wh = torch.tensor(wh, dtype=torch.float32, device=dev)     # (A, 2)
    cxy = torch.stack([cx, cy], dim=-1)[:, :, None, :]         # (H, W, 1, 2)
    half = wh[None, None, :, :] / 2.0                          # (1, 1, A, 2)
    boxes = torch.cat([cxy - half, cxy + half], dim=-1)        # (H, W, A, 4)
    boxes = boxes.reshape(1, h * w * wh.shape[0], 4)
    return boxes.clamp(0.0, 1.0) if clip else boxes


# ----------------------------------------------------------------------
# MultiBoxTarget
# ----------------------------------------------------------------------

@torch.no_grad()
def multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth, every image at once.

    ``anchors`` (1, N, 4) corner; ``labels`` (B, M, 5), rows ``[cls, x0,
    y0, x1, y1]`` with cls -1 for padding; ``cls_preds`` (B, C+1, N),
    read (detached) only for hard negative mining.  Each ground truth
    first takes its best anchor (the higher ground-truth index wins a
    shared anchor), then every anchor whose best IoU reaches
    ``overlap_threshold`` takes its best ground truth.  With
    ``negative_mining_ratio > 0`` the unmatched anchors whose best IoU is
    below ``negative_mining_thresh`` are ranked by 1 - p(background),
    the top ``ratio × #matched`` stay background and the others get
    ``ignore_label``.  → ``(loc_target (B, N·4), loc_mask (B, N·4),
    cls_target (B, N))``: cls_target is 0 for background and gt class + 1
    for a match; loc_target the matched box against its anchor, scaled by
    ``variances``, 0 where unmatched."""
    anchors = anchors.reshape(-1, 4)
    n = anchors.shape[0]
    bsz, m = labels.shape[0], labels.shape[1]
    dev = anchors.device
    var = _variances(variances, dev)
    valid = labels[..., 0] >= 0                                # (B, M)
    gt = labels[..., 1:5]                                      # (B, M, 4)
    iou = _corner_iou(anchors[None], gt)                       # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    # stage 1: each ground truth takes its best anchor; padding rows
    # scatter into a dump slot n that is dropped
    best_anchor = iou.argmax(dim=1)                            # (B, M)
    ba = torch.where(valid, best_anchor, torch.full_like(best_anchor, n))
    forced = torch.zeros(bsz, n + 1, dtype=torch.bool, device=dev).scatter(
        1, ba, True)[:, :n]
    gt_index = torch.arange(m, device=dev).expand(bsz, m)
    forced_gt = torch.zeros(bsz, n + 1, dtype=torch.long,
                            device=dev).scatter_reduce(
        1, ba, gt_index, reduce="amax")[:, :n]
    # stage 2: threshold matches
    best_iou, best_gt = iou.max(dim=2)                         # (B, N)
    matched = forced | (best_iou >= overlap_threshold)
    match_gt = torch.where(forced, forced_gt, best_gt)
    gt_cls = labels[..., 0].gather(1, match_gt)
    cls_target = torch.where(matched, gt_cls + 1.0,
                             torch.zeros_like(gt_cls))

    if negative_mining_ratio > 0:
        probs = torch.softmax(cls_preds.detach(), dim=1)       # (B, C+1, N)
        candidate = ~matched & (best_iou < negative_mining_thresh)
        neg_score = torch.where(candidate, 1.0 - probs[:, 0],
                                torch.full_like(best_iou, -1.0))
        max_neg = (matched.sum(dim=1) * negative_mining_ratio).to(
            torch.int32)                                       # (B,)
        order = torch.argsort(-neg_score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(bsz, n))
        keep_neg = candidate & (rank < max_neg[:, None])
        cls_target = torch.where(matched | keep_neg, cls_target,
                                 torch.full_like(cls_target, ignore_label))

    # location targets: the matched box against its anchor
    g = gt.gather(1, match_gt[..., None].expand(bsz, n, 4))    # (B, N, 4)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-12)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-12)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = (g[..., 2] - g[..., 0]).clamp(min=1e-12)
    gh = (g[..., 3] - g[..., 1]).clamp(min=1e-12)
    loc = torch.stack([(gcx - acx) / aw / var[0],
                       (gcy - acy) / ah / var[1],
                       torch.log(gw / aw) / var[2],
                       torch.log(gh / ah) / var[3]], dim=-1)   # (B, N, 4)
    mask = matched[..., None].to(torch.float32).expand(bsz, n, 4)
    return ((loc * mask).reshape(bsz, -1), mask.reshape(bsz, -1),
            cls_target)


# ----------------------------------------------------------------------
# NMS + MultiBoxDetection
# ----------------------------------------------------------------------

def _nms_keep(boxes, scores, ids, iou_threshold, force_suppress, topk):
    """Greedy NMS of each image's boxes (B, n, 4) in score order →
    ``(order (B, k), alive (B, k))``: the first ``k = min(topk, n)``
    indices by score and which of them survive.  Entries to drop must
    carry a score <= 0.  One iteration a kept slot: box i suppresses the
    later boxes it overlaps above ``iou_threshold`` (of its class unless
    ``force_suppress``) if it is still alive itself."""
    n = scores.shape[1]
    k = min(topk, n) if topk > 0 else n
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]  # (B, k)
    b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    s = scores.gather(1, order)
    c = ids.gather(1, order)
    overlap = _corner_iou(b, b) > iou_threshold                # (B, k, k)
    if not force_suppress:
        overlap &= c[:, :, None] == c[:, None, :]
    # only later boxes are suppressed
    overlap &= torch.ones(k, k, dtype=torch.bool,
                          device=boxes.device).triu(1)
    alive = s > 0
    for i in range(k):
        alive &= ~(overlap[:, i] & alive[:, i:i + 1])
    return order, alive


@torch.no_grad()
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression of each image's rows ``data`` (B, n, W) or
    (n, W): a row whose score (column ``score_index``) is not above
    ``valid_thresh``, whose id (column ``id_index``, where >= 0) is
    ``background_id``, or which a better-scored row of its id (of any id
    with ``force_suppress``) overlaps above ``overlap_thresh``, is
    dropped; only the ``topk`` best (all if -1) are considered.  The
    survivors come first in score order, every other row is -1.  Boxes
    (4 columns from ``coord_start``) are read in ``in_format`` and
    written in ``out_format`` (``"corner"`` or ``"center"``)."""
    for fmt in (in_format, out_format):
        if fmt not in ("corner", "center"):
            raise ValueError(f"box_nms: format {fmt!r} (corner, center)")
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    bsz, n, width = data.shape
    cs = coord_start
    boxes = data[..., cs:cs + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    scores = data[..., score_index]
    ids = data[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    if background_id >= 0 and id_index >= 0:
        valid &= ids != background_id
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    order, alive = _nms_keep(boxes, scores, ids, overlap_thresh,
                             force_suppress, topk if topk > 0 else n)
    rows = data
    if in_format == "center" and out_format == "corner":
        rows = torch.cat([data[..., :cs], boxes, data[..., cs + 4:]], dim=-1)
    elif in_format == "corner" and out_format == "center":
        c = data[..., cs:cs + 4]
        center = torch.stack([(c[..., 0] + c[..., 2]) / 2,
                              (c[..., 1] + c[..., 3]) / 2,
                              c[..., 2] - c[..., 0], c[..., 3] - c[..., 1]],
                             dim=-1)
        rows = torch.cat([data[..., :cs], center, data[..., cs + 4:]],
                         dim=-1)
    # compact: survivors first in score order; the rest go to a dump
    # slot n that is dropped
    dest = torch.where(alive, alive.cumsum(dim=1) - 1,
                       torch.full_like(order, n))
    picked = rows.gather(1, order[..., None].expand(-1, -1, width))
    out = torch.full((bsz, n + 1, width), -1.0, dtype=data.dtype,
                     device=data.device)
    out.scatter_(1, dest[..., None].expand(-1, -1, width), picked)
    out = out[:, :n]
    return out[0] if squeeze else out


@torch.no_grad()
def multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and suppress: ``cls_prob`` (B, C+1, N), ``loc_pred`` (B,
    N·4), ``anchors`` (1, N, 4) → (B, N, 6) rows ``[cls_id, score, x0,
    y0, x1, y1]``.  Each anchor's box is decoded from its offsets
    (scaled by ``variances``, clipped to [0, 1] if ``clip``), takes its
    best foreground class (ids count the classes without
    ``background_id``) and that probability as its score; scores not
    above ``threshold`` are dropped, then :func:`box_nms` per class over
    the ``nms_topk`` best.  Dropped rows are -1."""
    anchors = anchors.reshape(-1, 4)
    n = anchors.shape[0]
    bsz = cls_prob.shape[0]
    var = _variances(variances, anchors.device)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(bsz, n, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)                                # (B, N, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)   # (B, C, N)
    score, cls_id = fg.max(dim=1)
    keep = score > threshold
    score = torch.where(keep, score, torch.zeros_like(score))
    rows = torch.cat([cls_id.to(boxes.dtype)[..., None], score[..., None],
                      boxes], dim=-1)
    rows = torch.where(keep[..., None], rows, torch.full_like(rows, -1.0))
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)
