"""Serving error types (subset of ``incubator_mxnet_tpu/serving/admission.py``).

Each carries the HTTP status the front end answers with.  Queue bounds,
SLO classes and fault injection are not ported yet.
"""
from __future__ import annotations

__all__ = ["ServingError", "BadRequest", "ModelNotFound",
           "DeadlineExceeded", "ShuttingDown"]


class ServingError(Exception):
    """Base for serving-layer failures; carries the HTTP status."""
    http_status = 500

    def payload(self):
        return {"error": type(self).__name__, "message": str(self)}


class BadRequest(ServingError):
    http_status = 400


class ModelNotFound(ServingError):
    http_status = 404


class DeadlineExceeded(ServingError):
    """Deadline elapsed; reports where the time went (queue vs compute)."""
    http_status = 504

    def __init__(self, msg, queue_ms=None, compute_ms=None):
        super().__init__(msg)
        self.queue_ms = queue_ms
        self.compute_ms = compute_ms

    def payload(self):
        out = super().payload()
        if self.queue_ms is not None:
            out["queue_ms"] = round(self.queue_ms, 3)
        if self.compute_ms is not None:
            out["compute_ms"] = round(self.compute_ms, 3)
        return out


class ShuttingDown(ServingError):
    """The model's batcher is draining — no new work admitted."""
    http_status = 503
