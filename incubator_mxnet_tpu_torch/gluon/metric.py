"""Evaluation metrics (counterpart of ``incubator_mxnet_tpu/gluon/metric.py``;
reference ``python/mxnet/gluon/metric.py``).

Host code: labels and predictions — tensors on either device, numpy
arrays or lists — are copied to the host as numpy arrays (bfloat16 and
float16 widened to float32) and every metric computes in numpy, with
the JAX package's formulas.  Labels may be floats (the LeNet example's
are float32).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Fbeta", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Perplexity", "PearsonCorrelation",
           "PCC", "BinaryAccuracy", "MeanPairwiseDistance",
           "MeanCosineSimilarity", "Torch", "Caffe", "Loss", "CustomMetric",
           "create", "np"]

_REGISTRY: dict[str, type] = {}


class _Registry:
    """Metric classes by lower-cased name (the JAX package's
    ``base.registry("metric")``)."""

    @staticmethod
    def register(obj=None, name=None):
        def do(cls):
            _REGISTRY[(name or cls.__name__).lower()] = cls
            return cls
        return do if obj is None else do(obj)

    @staticmethod
    def alias(*names):
        def do(cls):
            for n in names:
                _REGISTRY[n.lower()] = cls
            return cls
        return do

    @staticmethod
    def create(name, *args, **kwargs):
        if not isinstance(name, str):
            return name                 # already an instance
        try:
            cls = _REGISTRY[name.lower()]
        except KeyError:
            raise KeyError(f"metric {name!r} is not registered (known: "
                           f"{sorted(_REGISTRY)})") from None
        return cls(*args, **kwargs)


_reg = _Registry()


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _reg.create(metric, *args, **kwargs)


class EvalMetric:
    """Base metric: ``update(labels, preds)`` accumulates, ``get()``
    returns ``(name, value)``."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label_dict, pred_dict):
        labels = [label_dict[n] for n in (self.label_names or label_dict)]
        preds = [pred_dict[n] for n in (self.output_names or pred_dict)]
        self.update(labels, preds)

    def __str__(self):
        return f"EvalMetric: {dict([self.get_name_value()[0]])}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _to_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@_reg.register(name="acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


_reg.alias("accuracy")(Accuracy)


@_reg.register(name="top_k_accuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).astype("int32").ravel()
            pred = _as_np(pred)
            topk = onp.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += (topk == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


@_reg.register(name="f1")
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.threshold = threshold
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype("int32")
            pred = _as_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).ravel()
            else:
                pred = (pred.ravel() > self.threshold).astype("int32")
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@_reg.register(name="mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.tp = self.fp = self.fn = self.tn = 0

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype("int32")
            pred = _as_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).ravel()
            else:
                pred = (pred.ravel() > 0.5).astype("int32")
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.tn += int(((pred == 0) & (label == 0)).sum())
            self.num_inst += 1

    def get(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = math.sqrt(max(
            (self.tp + self.fp) * (self.tp + self.fn) *
            (self.tn + self.fp) * (self.tn + self.fn), 1))
        return self.name, num / den


@_reg.register(name="mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            diff = onp.abs(label - pred.reshape(label.shape))
            self.sum_metric += diff.mean() * len(label)
            self.num_inst += len(label)


@_reg.register(name="mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            diff = (label - pred.reshape(label.shape)) ** 2
            self.sum_metric += diff.mean() * len(label)
            self.num_inst += len(label)


@_reg.register(name="rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, math.sqrt(value) if not math.isnan(value) else value


@_reg.register(name="ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype("int64")
            pred = _as_np(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += (-onp.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


_reg.alias("cross-entropy")(CrossEntropy)


@_reg.register(name="nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@_reg.register(name="perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).astype("int64").ravel()
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += -onp.log(onp.maximum(prob, 1e-10)).sum()
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@_reg.register(name="pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            self._labels.append(_as_np(label).ravel())
            self._preds.append(_as_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        lab = onp.concatenate(self._labels)
        pred = onp.concatenate(self._preds)
        return self.name, float(onp.corrcoef(lab, pred)[0, 1])


@_reg.register(name="pcc")
class PCC(EvalMetric):
    """Multiclass Pearson correlation on the confusion matrix
    (reference metric.py:1651) — the K-class generalization of MCC."""

    def __init__(self, name="pcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset()

    def reset(self):
        super().reset()
        self._cm = onp.zeros((0, 0), onp.float64)

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = onp.zeros((k, k), onp.float64)
            cm[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype("int64")
            pred = _as_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(-1).ravel()
            pred = pred.astype("int64")
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            onp.add.at(self._cm, (label, pred), 1.0)
            self.num_inst += label.size

    def get(self):
        c = self._cm
        if self.num_inst == 0 or c.size == 0:
            return self.name, float("nan")
        n = c.sum()
        t = c.sum(axis=1)   # true occurrences per class
        p = c.sum(axis=0)   # predicted occurrences per class
        cov_tp = onp.trace(c) * n - (t * p).sum()
        cov_tt = n * n - (t * t).sum()
        cov_pp = n * n - (p * p).sum()
        denom = math.sqrt(max(cov_tt * cov_pp, 0.0))
        return self.name, float(cov_tp / denom) if denom else float("nan")


@_reg.register(name="fbeta")
class Fbeta(F1):
    """Fbeta score for binary classification (reference metric.py:815):
    (1+beta^2) * P * R / (beta^2 * P + R)."""

    def __init__(self, name="fbeta", beta=1.0, threshold=0.5, **kwargs):
        self.beta = beta
        super().__init__(name=name, threshold=threshold, **kwargs)

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        b2 = self.beta ** 2
        denom = b2 * prec + rec
        fbeta = (1 + b2) * prec * rec / denom if denom else 0.0
        return self.name, fbeta


@_reg.register(name="binary_accuracy")
class BinaryAccuracy(EvalMetric):
    """Binary/multilabel accuracy at a threshold (reference
    metric.py:876)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel()
            pred = (_as_np(pred).ravel() > self.threshold)
            self.sum_metric += float((pred == (label > 0.5)).sum())
            self.num_inst += label.size


@_reg.register(name="mpd")
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between rows (reference metric.py:1197)."""

    def __init__(self, name="mpd", p=2.0, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            diff = onp.abs(pred.reshape(pred.shape[0], -1)
                           - label.reshape(label.shape[0], -1)) ** self.p
            dist = diff.sum(axis=1) ** (1.0 / self.p)
            self.sum_metric += float(dist.sum())
            self.num_inst += pred.shape[0]


@_reg.register(name="cos_sim")
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference
    metric.py:1263)."""

    def __init__(self, name="cos_sim", eps=1e-12, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            num = (label * pred).sum(axis=-1)
            den = onp.maximum(
                onp.linalg.norm(label, axis=-1)
                * onp.linalg.norm(pred, axis=-1), self.eps)
            sim = num / den
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@_reg.register(name="loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _to_list(preds):
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            value = self._feval(_as_np(label), _as_np(pred))
            if isinstance(value, tuple):
                s, n = value
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += value
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)


@_reg.register(name="torch")
class Torch(Loss):
    """Legacy alias (reference metric.py Torch: Loss-style mean)."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name=name, **kwargs)


@_reg.register(name="caffe")
class Caffe(Loss):
    """Legacy alias (reference metric.py Caffe)."""

    def __init__(self, name="caffe", **kwargs):
        super().__init__(name=name, **kwargs)
