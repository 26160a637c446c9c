"""The port's detection ops (``ops/contrib_ops.py``) against the JAX
package's, on the CPU, and the JAX suite's properties on the port alone.

Inputs come from numpy with a seed and go through both ops.  Tolerances:
``multibox_prior`` bit for bit; float outputs within 1e-5 absolute
(boxes and scores in [0, 1], location targets up to about 10: a few
float32 ulps); integer outputs (class targets, masks, class ids, which
rows survive) equal.  One rule admits a difference: hard negative mining
ranks about N candidates by 1 - p(background), and the two packages'
softmaxes may round p an ulp apart, so an anchor whose score lies within
1e-6 of the cut-off (the ``ratio·#pos``-th largest) may be kept by one
and ignored by the other.  Each case states how many such near-ties its
data has and admits only those; NMS and the IoU threshold likewise, where
a pair's IoU lies within 1e-6 of the threshold (none of these data has
one).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import contrib_ops as jco

from incubator_mxnet_tpu_torch.ops import contrib_ops as co

NEAR = 1e-6
FLOAT_TOL = 1e-5


def _jax(op, *args, **kw):
    """The JAX op's function on ``args``, compiled whole by ``jax.jit``
    with its keywords static (one compile a case, rather than one a
    primitive)."""
    fn = jax.jit(functools.partial(op.fn, **kw))
    out = fn(*(jnp.asarray(a) for a in args))
    if isinstance(out, tuple):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= FLOAT_TOL, (what, err)


def _boxes(rng, shape, center=False):
    """Random boxes inside [0, 1]: corner (x0, y0, x1, y1), or center
    (x, y, w, h)."""
    xy = rng.uniform(0.05, 0.7, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    if center:
        return np.concatenate([xy + wh / 2, wh], -1).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ----------------------------------------------------------------------
# parity with the JAX ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rng = np.random.RandomState(0)
    a = _boxes(rng, (2, 7), fmt == "center")
    b = _boxes(rng, (2, 5), fmt == "center")
    want = _jax(jco.box_iou, a, b, format=fmt)
    got = co.box_iou(_t(a), _t(b), format=fmt)
    assert got.shape == (2, 7, 5)
    _close(got, want, fmt)


@pytest.mark.parametrize("shape,kw", [
    ((1, 3, 4, 6), dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5))),
    ((2, 8, 150, 150), dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5))),
    ((1, 8, 37, 37), dict(sizes=(0.54, 0.619), ratios=(1, 2, 0.5))),
    ((1, 8, 1, 1), dict(sizes=(0.88, 0.961), ratios=(1, 2, 0.5),
                        clip=True)),
    ((1, 2, 5, 7), dict(sizes=(0.3,), ratios=(1, 3), steps=(0.1, 0.2),
                        offsets=(0.25, 0.75))),
])
def test_multibox_prior_matches_jax_bit_for_bit(shape, kw):
    x = np.zeros(shape, np.float32)
    want = _jax(jco.multibox_prior, x, **kw)
    got = co.multibox_prior(_t(x), **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _anchors(h=8, w=8, sizes=(0.25, 0.35), ratios=(1, 2)):
    return co.multibox_prior(torch.zeros(1, 3, h, w), sizes=sizes,
                             ratios=ratios).numpy()


def _mining_near_ties(cls_preds, cls_t, ratio):
    """Per image, the candidates (the anchors that are no match) whose
    mining score 1 - p(background) lies within NEAR of the cut-off, the
    ``ratio·#pos``-th largest, where the first score past the cut-off
    lies within NEAR of it too; none where it does not (then no rounding
    of the softmax can move the cut)."""
    probs = torch.softmax(_t(cls_preds), dim=1).numpy()
    near = np.zeros(cls_t.shape, bool)
    for b in range(cls_t.shape[0]):
        cand = cls_t[b] <= 0
        score = np.where(cand, 1.0 - probs[b, 0], -1.0)
        k = int(np.float32((cls_t[b] > 0).sum()) * np.float32(ratio))
        ranked = np.sort(score[cand])[::-1]
        if 0 < k < len(ranked) and ranked[k - 1] - ranked[k] <= NEAR:
            near[b] = cand & (np.abs(score - ranked[k - 1]) <= NEAR)
    return near


def _target_case(case):
    rng = np.random.RandomState(3)
    anchors = _anchors()
    n = anchors.shape[1]
    if case == "padding":
        labels = np.array([[[1, 0.1, 0.1, 0.35, 0.35], [-1, 0, 0, 0, 0]],
                           [[0, 0.5, 0.4, 0.9, 0.8],
                            [1, 0.05, 0.6, 0.3, 0.95]]], np.float32)
        cls_preds = rng.randn(2, 3, n).astype(np.float32)
        return anchors, labels, cls_preds, {}
    if case == "shared_anchor":
        # two ground truths whose best anchor is the same one: the
        # higher index (class 1) wins it in both packages
        labels = np.array([[[0, 0.30, 0.30, 0.56, 0.56],
                            [1, 0.31, 0.31, 0.55, 0.55],
                            [-1, 0, 0, 0, 0]]], np.float32)
        cls_preds = rng.randn(1, 3, n).astype(np.float32)
        return anchors, labels, cls_preds, dict(overlap_threshold=0.95)
    labels = np.full((4, 3, 5), -1.0, np.float32)
    for b in range(4):
        for j in range(1 + b % 3):
            box = _boxes(rng, ())
            labels[b, j] = [rng.randint(0, 2), *box]
    if case == "zero_preds":      # all scores equal: the sort's ties
        cls_preds = np.zeros((4, 3, n), np.float32)
    else:
        cls_preds = (rng.randn(4, 3, n) * 2).astype(np.float32)
    return anchors, labels, cls_preds, dict(negative_mining_ratio=3.0)


# near-ties at the mining cut-off that each case's data has; with all
# scores equal (``zero_preds``) every candidate ties, but both packages
# compute the same score for each and break the ties by index, so that
# case is held to exact equality
TARGET_NEAR_TIES = {"padding": 0, "shared_anchor": 0, "mining": 0,
                    "zero_preds": None}


@pytest.mark.parametrize("case", sorted(TARGET_NEAR_TIES))
def test_multibox_target_matches_jax(case):
    anchors, labels, cls_preds, kw = _target_case(case)
    want = _jax(jco.multibox_target, anchors, labels, cls_preds, **kw)
    got = [a.numpy() for a in co.multibox_target(
        _t(anchors), _t(labels), _t(cls_preds), **kw)]
    _close(got[0], want[0], "loc_target")
    np.testing.assert_array_equal(got[1], want[1])      # loc_mask
    ratio = kw.get("negative_mining_ratio", -1.0)
    near = (_mining_near_ties(cls_preds, got[2], ratio) if ratio > 0
            else np.zeros(got[2].shape, bool))
    if TARGET_NEAR_TIES[case] is None:
        near[:] = False
    else:
        assert int(near.sum()) == TARGET_NEAR_TIES[case], int(near.sum())
    differ = got[2] != want[2]
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)
    if case == "shared_anchor":
        # the forced anchor went to gt 1 (class 1 → target 2)
        assert (got[2][0] == 2).sum() >= 1 and (got[2][0] == 1).sum() == 0
    if ratio > 0:
        assert (got[2] == -1).any()


def _nms_rows(rng, bsz, n, center):
    """Rows ``[id, score, 4 coords]`` in clusters of overlapping boxes,
    some scores at or below 0."""
    base = _boxes(rng, (bsz, n // 3), center)
    boxes = np.repeat(base, 3, axis=1)[:, :n]
    boxes = boxes + rng.uniform(-0.03, 0.03, boxes.shape).astype(np.float32)
    ids = rng.randint(0, 3, (bsz, n, 1)).astype(np.float32)
    scores = rng.uniform(-0.2, 1.0, (bsz, n, 1)).astype(np.float32)
    return np.concatenate([ids, scores, boxes], -1).astype(np.float32)


def _iou_near_ties(rows, thresh, center):
    b = torch.from_numpy(rows[..., 2:6])
    iou = co.box_iou(b, b, format="center" if center else "corner")
    return int((iou - thresh).abs().le(NEAR).sum())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(id_index=0),
    dict(id_index=0, force_suppress=True),
    dict(id_index=0, topk=7),
    dict(id_index=0, background_id=1, valid_thresh=0.2),
    dict(id_index=0, in_format="center", out_format="corner"),
    dict(id_index=0, in_format="corner", out_format="center"),
    dict(id_index=0, in_format="center", out_format="center",
         overlap_thresh=0.3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_box_nms_matches_jax(kw):
    center = kw.get("in_format") == "center"
    rows = _nms_rows(np.random.RandomState(5), 2, 30, center)
    assert _iou_near_ties(rows, kw.get("overlap_thresh", 0.5), center) == 0
    want = _jax(jco.box_nms, rows, **kw)
    got = co.box_nms(_t(rows), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2] == -1, want[..., :2] == -1)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got, want, "rows")
    assert (got[..., 1] == -1).any() and (got[..., 1] > 0).any()
    # one image without the batch axis
    _close(co.box_nms(_t(rows[1]), **kw), want[1], "2-D")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_threshold=0.45, threshold=0.01, nms_topk=400),
    dict(nms_threshold=0.3, force_suppress=True, nms_topk=20),
    dict(clip=False, threshold=0.3, background_id=1),
], ids=["default", "ssd", "force-topk20", "noclip-bg1"])
def test_multibox_detection_matches_jax(kw):
    rng = np.random.RandomState(7)
    anchors = _anchors(6, 6, sizes=(0.3, 0.5), ratios=(1, 2, 0.5))
    n = anchors.shape[1]
    logits = rng.randn(3, 4, n).astype(np.float32) * 2
    cls_prob = torch.softmax(_t(logits), dim=1).numpy()
    loc = (rng.randn(3, n * 4) * 0.5).astype(np.float32)
    want = _jax(jco.multibox_detection, cls_prob, loc, anchors, **kw)
    got = co.multibox_detection(_t(cls_prob), _t(loc), _t(anchors),
                                **kw).numpy()
    assert got.shape == (3, n, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1] == -1, want[..., 1] == -1)
    _close(got, want, "detections")
    assert (got[..., 1] > 0).any()


def test_detection_outputs_carry_no_gradient():
    """The JAX ops are ``differentiable=False``: no output of the port's
    ops is attached to the graph, whatever its inputs."""
    anchors = torch.from_numpy(_anchors())
    n = anchors.shape[1]
    cls_preds = torch.randn(1, 3, n, requires_grad=True)
    labels = torch.tensor([[[1, 0.1, 0.1, 0.35, 0.35]]])
    outs = co.multibox_target(anchors, labels, cls_preds,
                              negative_mining_ratio=3.0)
    det = co.multibox_detection(torch.softmax(cls_preds, 1),
                                torch.zeros(1, n * 4, requires_grad=True),
                                anchors)
    assert not any(o.requires_grad for o in (*outs, det))


# ----------------------------------------------------------------------
# the JAX suite's properties (tests/test_contrib_det.py), on the port
# ----------------------------------------------------------------------

def test_multibox_prior_layout():
    a = co.multibox_prior(torch.zeros(1, 3, 4, 6), sizes=(0.5, 0.25),
                          ratios=(1, 2, 0.5))
    assert a.shape == (1, 4 * 6 * 4, 4)     # A = 2 + 3 - 1 = 4
    an = a.numpy()[0]
    # first cell centre ((0 + .5)/6, (0 + .5)/4) = (1/12, 1/8); size .5
    np.testing.assert_allclose(
        an[0], [1 / 12 - .25, 1 / 8 - .25, 1 / 12 + .25, 1 / 8 + .25],
        atol=1e-6)
    w, h = an[2, 2] - an[2, 0], an[2, 3] - an[2, 1]   # ratio 2
    np.testing.assert_allclose(w / h, 2.0, rtol=1e-5)


def test_box_iou_known_values():
    a = torch.tensor([[0., 0., 2., 2.]])
    b = torch.tensor([[1., 1., 3., 3.], [0., 0., 2., 2.], [5., 5., 6., 6.]])
    np.testing.assert_allclose(co.box_iou(a, b).numpy()[0],
                               [1 / 7, 1.0, 0.0], atol=1e-6)


def test_multibox_target_matching():
    anchors = torch.from_numpy(_anchors())
    labels = torch.tensor([[[1, 0.1, 0.1, 0.35, 0.35], [-1, 0, 0, 0, 0]]])
    n = anchors.shape[1]
    loc_t, loc_m, cls_t = co.multibox_target(anchors, labels,
                                             torch.zeros(1, 3, n))
    assert loc_t.shape == (1, n * 4) and cls_t.shape == (1, n)
    ct = cls_t.numpy()[0]
    assert (ct == 2).sum() >= 1             # gt class 1 → target 2
    assert (ct == 0).sum() > n // 2         # most anchors are background
    lm = loc_m.numpy()[0].reshape(n, 4)
    lt = loc_t.numpy()[0].reshape(n, 4)
    assert np.all(lt[lm[:, 0] == 0] == 0)
    assert np.isfinite(lt).all()


def test_multibox_target_hard_negative_mining():
    anchors = torch.from_numpy(_anchors(sizes=(0.25,), ratios=(1,)))
    labels = torch.tensor([[[0, 0.4, 0.4, 0.6, 0.6]]])
    n = anchors.shape[1]
    cls_preds = torch.rand(1, 2, n, generator=torch.Generator()
                           .manual_seed(0))
    _, _, cls_t = co.multibox_target(anchors, labels, cls_preds,
                                     negative_mining_ratio=3.0)
    ct = cls_t.numpy()[0]
    num_pos = (ct > 0).sum()
    assert (ct == -1).sum() > 0                   # mining ignored some
    assert (ct == 0).sum() <= 3 * max(num_pos, 1)  # ratio respected


def test_box_nms_suppression_and_compaction():
    rows = torch.tensor([
        [0, 0.9, 0.10, 0.10, 0.50, 0.50],
        [0, 0.8, 0.12, 0.12, 0.52, 0.52],   # overlaps row 0, same class
        [1, 0.7, 0.11, 0.11, 0.51, 0.51],   # overlaps, another class
        [0, 0.6, 0.60, 0.60, 0.90, 0.90],   # disjoint
    ])
    out = co.box_nms(rows, overlap_thresh=0.5, id_index=0).numpy()
    assert out[0, 1] == pytest.approx(0.9)
    assert out[1, 1] == pytest.approx(0.7)   # the other class survives
    assert out[2, 1] == pytest.approx(0.6)
    assert (out[3] == -1).all()
    out2 = co.box_nms(rows, overlap_thresh=0.5, id_index=0,
                      force_suppress=True).numpy()
    assert out2[1, 1] == pytest.approx(0.6)  # cross-class suppressed


def test_multibox_detection_decodes_offsets():
    anchors = torch.tensor([[[0.2, 0.2, 0.4, 0.4], [0.6, 0.6, 0.8, 0.8]]])
    cls_prob = torch.tensor([[[0.1, 0.9], [0.2, 0.05], [0.7, 0.05]]])
    det = co.multibox_detection(cls_prob, torch.zeros(1, 8), anchors,
                                threshold=0.1).numpy()[0]
    best = det[det[:, 1] > 0]
    assert len(best) >= 1
    # anchor 0: the foreground argmax over {class 1: 0.2, class 2: 0.7}
    assert best[0][0] == 1.0
    np.testing.assert_allclose(best[0][2:], [0.2, 0.2, 0.4, 0.4], atol=1e-5)


def test_formats_are_checked():
    b = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="format"):
        co.box_iou(b, b, format="xywh")
    with pytest.raises(ValueError, match="format"):
        co.box_nms(torch.zeros(2, 6), out_format="xywh")
