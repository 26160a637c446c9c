"""Named models over ``deploy.load_predictor`` artifacts (counterpart of
``incubator_mxnet_tpu/serving/model_repository.py``).

Each loaded model gets a :class:`~.batcher.DynamicBatcher`.  A model is
warmed at load — one zeros batch at every bucket the batcher can pad
to — before it is visible to traffic, so no request pays a first-call
cost.  Reload, admission control, SLO classes and metrics are not
ported yet.
"""
from __future__ import annotations

import threading
import time

from ..context import resolve_device
from ..deploy import load_predictor
from .admission import ModelNotFound, ServingError, ShuttingDown
from .batcher import DynamicBatcher, parse_buckets

__all__ = ["ModelRepository", "ModelEntry"]


class ModelEntry:
    """One loaded model: predictor and its batcher."""

    __slots__ = ("predictor", "batcher", "cold_start_ms")

    def __init__(self, predictor, batcher):
        self.predictor = predictor
        self.batcher = batcher
        self.cold_start_ms = None

    def describe(self):
        return {"device": str(self.predictor.device),
                "cold_start_ms": self.cold_start_ms,
                "queue_depth": self.batcher.depth}


class ModelRepository:
    """Models served on ``device`` (``cuda:0`` unless given; raises
    without CUDA), batched to ``buckets`` (default
    ``MXNET_SERVING_BATCH_BUCKETS``)."""

    def __init__(self, buckets=None, device=None):
        self.device = resolve_device(device)
        self.buckets = (list(buckets) if buckets is not None
                        else parse_buckets())
        self._models: dict[str, ModelEntry] = {}
        self._draining = False
        self._lock = threading.Lock()

    @property
    def draining(self):
        return self._draining

    def load(self, name, path):
        """Load the artifact at ``path`` as ``name``; it becomes visible
        only after the load and the warmup succeed.  Raises if the name
        is already loaded."""
        t0 = time.monotonic()
        predictor = load_predictor(path, device=self.device)
        batcher = DynamicBatcher(name, predictor, buckets=self.buckets)
        entry = ModelEntry(predictor, batcher)
        try:
            self.warmup_entry(entry)
        except Exception:
            batcher.drain()  # no leaked worker thread
            raise
        entry.cold_start_ms = round((time.monotonic() - t0) * 1000.0, 3)
        with self._lock:
            taken = name in self._models
            if not taken:
                self._models[name] = entry
        if taken:
            batcher.drain()
            raise ServingError(f"model {name!r} already loaded")
        return entry.describe()

    @staticmethod
    def warmup_entry(entry):
        """Every size a batch of 1..max_batch requests can pad to."""
        b = entry.batcher
        sizes = sorted({s for s in b.buckets if s <= b.max_batch}
                       | {b._bucket_for(b.max_batch)})
        entry.predictor.warmup(sizes)
        return sizes

    def unload(self, name):
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is None:
            raise ModelNotFound(f"model {name!r} is not loaded")
        entry.batcher.drain()
        return {"unloaded": name}

    def drain_all(self, timeout=30.0):
        """Graceful shutdown: stop admission, flush every queue."""
        self._draining = True
        with self._lock:
            entries = list(self._models.values())
        for e in entries:
            e.batcher.drain(timeout)

    def get(self, name):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise ModelNotFound(f"model {name!r} is not loaded")
        return entry

    def predict_async(self, name, inputs, deadline_ms=None):
        """Enqueue one instance on ``name``'s batcher; returns a
        :class:`~.batcher.PendingResult`."""
        if self._draining:
            raise ShuttingDown("server is draining")
        return self.get(name).batcher.submit_async(inputs, deadline_ms)

    def models(self):
        with self._lock:
            entries = dict(self._models)
        return {name: e.describe() for name, e in entries.items()}
