"""The port's ``gluon.metric`` against the JAX package's.

Every metric is fed the same numpy predictions and labels, as torch
tensors in the port and as numpy arrays in the JAX package, over two
batches; ``get()`` agrees to 1e-6 relative (both compute in numpy, in
the same order).  Labels are float32, as the LeNet example's are.
"""
import math

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.gluon import metric as jmetric
from incubator_mxnet_tpu_torch.gluon import metric

N, C = 32, 5


def _probs(rng, n=N, c=C):
    p = rng.random((n, c)).astype(np.float32) + 0.05
    return p / p.sum(1, keepdims=True)


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, C, N).astype(np.float32)
    if kind == "class":
        return cls, _probs(rng)
    if kind == "binary":
        return rng.integers(0, 2, N).astype(np.float32), _probs(rng, c=2)
    if kind == "binary1d":
        return (rng.integers(0, 2, N).astype(np.float32),
                rng.random(N).astype(np.float32))
    if kind == "regress":
        return (rng.standard_normal(N).astype(np.float32),
                rng.standard_normal((N, 1)).astype(np.float32))
    if kind == "vectors":
        return (rng.standard_normal((N, 6)).astype(np.float32),
                rng.standard_normal((N, 6)).astype(np.float32))
    if kind == "sequence":
        lbl = rng.integers(0, C, (4, 8)).astype(np.float32)
        return lbl, _probs(rng, 32, C).reshape(4, 8, C)
    if kind == "loss":
        return None, rng.random((N, 1)).astype(np.float32)
    raise ValueError(kind)


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(-1)).sum()), label.size


CASES = [
    ("Accuracy", {}, "class"), ("TopKAccuracy", {"top_k": 3}, "class"),
    ("F1", {}, "binary"), ("F1", {"threshold": 0.3}, "binary1d"),
    ("MCC", {}, "binary"), ("MAE", {}, "regress"), ("MSE", {}, "regress"),
    ("RMSE", {}, "regress"), ("CrossEntropy", {}, "class"),
    ("NegativeLogLikelihood", {}, "class"),
    ("Perplexity", {}, "class"), ("Perplexity", {"ignore_label": 0},
                                  "sequence"),
    ("PearsonCorrelation", {}, "vectors"), ("PCC", {}, "class"),
    ("Fbeta", {"beta": 2.0}, "binary"),
    ("BinaryAccuracy", {"threshold": 0.6}, "binary1d"),
    ("MeanPairwiseDistance", {}, "vectors"),
    ("MeanPairwiseDistance", {"p": 1.0}, "vectors"),
    ("MeanCosineSimilarity", {}, "vectors"), ("Loss", {}, "loss"),
    ("Torch", {}, "loss"), ("Caffe", {}, "loss"),
    ("CustomMetric", {"feval": _feval, "name": "absdiff"}, "class"),
]


def _feed(m, batches, as_tensor):
    for lbl, pred in batches:
        wrap = torch.from_numpy if as_tensor else (lambda a: a)
        m.update([None if lbl is None else wrap(lbl)], [wrap(pred)])


def _close(got, want):
    gn, gv = got
    wn, wv = want
    assert gn == wn
    gv, wv = np.atleast_1d(gv), np.atleast_1d(wv)
    np.testing.assert_allclose(np.asarray(gv, np.float64),
                               np.asarray(wv, np.float64), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_metric_matches_jax(name, kwargs, kind):
    batches = [_batch(kind, s) for s in (0, 1)]
    ours, theirs = getattr(metric, name)(**kwargs), getattr(
        jmetric, name)(**kwargs)
    _close(ours.get(), theirs.get())            # empty: nan or the start
    _feed(ours, batches, True)
    _feed(theirs, batches, False)
    _close(ours.get(), theirs.get())
    assert ours.get_name_value() == [tuple(ours.get())] or isinstance(
        ours.get()[0], list)
    ours.reset()
    theirs.reset()
    _feed(ours, batches[:1], True)
    _feed(theirs, batches[:1], False)
    _close(ours.get(), theirs.get())


@pytest.mark.parametrize("spec", ["acc", "accuracy", "top_k_accuracy",
                                  "ce", "nll_loss", "mse", "rmse", "mae",
                                  "pearsonr", "f1", "mcc", "perplexity",
                                  "loss", "pcc", "fbeta", "binary_accuracy",
                                  "mpd", "cos_sim", "torch", "caffe",
                                  "cross-entropy"])
def test_create_by_name_matches_jax(spec):
    ours, theirs = metric.create(spec), jmetric.create(spec)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.name == theirs.name


def test_composite_and_list_create_match_jax():
    batches = [_batch("class", s) for s in (2, 3)]
    ours = metric.create(["acc", metric.TopKAccuracy(top_k=2), "ce"])
    theirs = jmetric.create(["acc", jmetric.TopKAccuracy(top_k=2), "ce"])
    assert isinstance(ours, metric.CompositeEvalMetric)
    _feed(ours, batches, True)
    _feed(theirs, batches, False)
    names, values = ours.get()
    jnames, jvalues = theirs.get()
    assert names == jnames
    np.testing.assert_allclose(values, jvalues, rtol=1e-6)
    ours.reset()
    assert all(math.isnan(v) for v in ours.get()[1])


def test_np_wrapper_and_callable_create_match_jax():
    batches = [_batch("class", s) for s in (4, 5)]
    for make in (lambda m: m.np(_feval), lambda m: m.create(_feval)):
        ours, theirs = make(metric), make(jmetric)
        _feed(ours, batches, True)
        _feed(theirs, batches, False)
        _close(ours.get(), theirs.get())


def test_metrics_take_low_precision_and_float_labels():
    lbl, pred = _batch("class", 6)
    ours, theirs = metric.Accuracy(), jmetric.Accuracy()
    ours.update([torch.from_numpy(lbl).to(torch.bfloat16)],
                [torch.from_numpy(pred).to(torch.float16)])
    theirs.update([lbl], [pred.astype(np.float16)])
    _close(ours.get(), theirs.get())
    ce = metric.CrossEntropy()
    ce.update([lbl.tolist()], [torch.from_numpy(pred).to(torch.bfloat16)])
    assert np.isfinite(ce.get()[1])


def test_create_refuses_an_unknown_name():
    with pytest.raises(KeyError, match="not registered"):
        metric.create("no-such-metric")
