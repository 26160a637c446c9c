"""Per-model dynamic batcher (counterpart of
``incubator_mxnet_tpu/serving/batcher.py``).

Concurrent single-instance requests against one model are stacked into
a batch, padded with zero rows up to the next size in
``MXNET_SERVING_BATCH_BUCKETS`` (default ``1,2,4,8,16,32``), run once,
and sliced back out.  A forming batch flushes when
``MXNET_SERVING_MAX_BATCH`` requests wait (default: the largest bucket)
or when the oldest has waited ``MXNET_SERVING_MAX_LATENCY_MS``
(default 5), whichever comes first.  Requests are grouped by input
signature (instance shapes and dtypes), so a batch is rectangular.

A padded row is computed and dropped; it never reaches a caller.  The
weighted fair gate, continuous batching, fault injection and tracing of
the JAX package are not ported yet.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..base import get_env
from .admission import DeadlineExceeded, ServingError, ShuttingDown

__all__ = ["DynamicBatcher", "PendingResult", "parse_buckets"]


def parse_buckets(text=None):
    """``MXNET_SERVING_BATCH_BUCKETS`` → sorted unique ints."""
    raw = (text if text is not None
           else get_env("MXNET_SERVING_BATCH_BUCKETS", "1,2,4,8,16,32"))
    try:
        sizes = sorted({int(v) for v in str(raw).split(",") if v.strip()})
    except ValueError:
        raise ValueError(
            f"MXNET_SERVING_BATCH_BUCKETS must be comma-separated ints, "
            f"got {raw!r}") from None
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch buckets must be >= 1, got {raw!r}")
    return sizes


class _Request:
    __slots__ = ("inputs", "event", "batch_out", "row", "error",
                 "t_enqueue", "deadline_ms", "queue_ms", "compute_ms",
                 "cancelled")

    def __init__(self, inputs, deadline_ms):
        self.inputs = inputs
        self.event = threading.Event()
        self.batch_out = None    # the whole batch's outputs
        self.row = None          # this request's row in them
        self.error = None
        self.t_enqueue = time.monotonic()
        self.deadline_ms = deadline_ms
        self.queue_ms = None
        self.compute_ms = None
        self.cancelled = False

    def age_ms(self, now=None):
        return ((now if now is not None else time.monotonic())
                - self.t_enqueue) * 1000.0

    def expired(self, now=None):
        return (self.deadline_ms is not None
                and self.age_ms(now) > self.deadline_ms)


class PendingResult:
    """Handle for an in-flight request (``submit_async``)."""

    __slots__ = ("_batcher", "_req")

    def __init__(self, batcher, req):
        self._batcher = batcher
        self._req = req

    def result(self):
        """Block until this instance's slice of a batch is ready;
        returns ``(outputs, timing)``: a tuple of instance-level arrays
        and the queue/compute split in ms."""
        req = self._req
        timeout = (None if req.deadline_ms is None
                   else req.deadline_ms / 1000.0 + 5.0)
        if not req.event.wait(timeout):
            req.cancelled = True   # the worker drops it if not yet run
            raise DeadlineExceeded(
                f"request to {self._batcher.name!r} timed out awaiting "
                "batch", queue_ms=req.age_ms())
        if req.error is not None:
            raise req.error
        if req.batch_out is None:
            raise DeadlineExceeded(
                f"request to {self._batcher.name!r} was cancelled "
                "before execution", queue_ms=req.age_ms())
        result = tuple(o[req.row] for o in req.batch_out)
        return result, {"queue_ms": req.queue_ms,
                        "compute_ms": req.compute_ms}


class DynamicBatcher:
    """One batching queue and worker thread per loaded model.

    ``predictor(*stacked_inputs)`` must return a tuple of arrays whose
    leading axis is the batch.  ``batches`` counts the executed batches
    by ``(rows, padded_to)``."""

    def __init__(self, name, predictor, buckets=None):
        self.name = name
        self.predictor = predictor
        self.buckets = (list(buckets) if buckets is not None
                        else parse_buckets())
        self.max_batch = get_env("MXNET_SERVING_MAX_BATCH", self.buckets[-1],
                                 int)
        if self.max_batch < 1:
            raise ValueError(
                f"MXNET_SERVING_MAX_BATCH must be >= 1, got "
                f"{self.max_batch}")
        self.max_latency_ms = get_env("MXNET_SERVING_MAX_LATENCY_MS", 5.0,
                                      float)
        if self.max_latency_ms < 0:
            raise ValueError(
                f"MXNET_SERVING_MAX_LATENCY_MS must be >= 0, got "
                f"{self.max_latency_ms}")
        self.batches = collections.Counter()
        self._pending: dict[tuple, list[_Request]] = {}
        self._depth = 0
        self._running = True
        self._cond = threading.Condition()
        self._worker = threading.Thread(
            target=self._loop, name=f"batcher-{name}", daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------

    @property
    def depth(self):
        """Queued-but-unfinished request count."""
        with self._cond:
            return self._depth

    def submit_async(self, inputs, deadline_ms=None):
        """Enqueue one instance (a tuple of arrays: the exported
        signature without its batch axis); returns a
        :class:`PendingResult` whose ``result()`` blocks."""
        arrs = tuple(np.asarray(x) for x in inputs)
        sig = tuple((a.shape, a.dtype) for a in arrs)
        req = _Request(arrs, deadline_ms)
        with self._cond:
            if not self._running:
                raise ShuttingDown(f"batcher for {self.name!r} is draining")
            group = self._pending.setdefault(sig, [])
            group.append(req)
            self._depth += 1
            # wake the worker only when this submit changes what it
            # should do: a new group arms the timer, a full one flushes
            if len(group) == 1 or len(group) >= self.max_batch:
                self._cond.notify()
        return PendingResult(self, req)

    # -- worker side --------------------------------------------------

    def _take_batch(self):
        """Wait for a flushable group; pop up to ``max_batch`` of its
        requests.  Returns None only at shutdown with nothing queued."""
        with self._cond:
            while True:
                if not self._running and not self._pending:
                    return None
                now = time.monotonic()
                best_sig, best_age = None, -1.0
                for sig, reqs in self._pending.items():
                    age = reqs[0].age_ms(now)
                    full = len(reqs) >= self.max_batch
                    ripe = age >= self.max_latency_ms
                    # draining flushes at once: no timer to wait out
                    if (full or ripe or not self._running) and age > best_age:
                        best_sig, best_age = sig, age
                if best_sig is not None:
                    reqs = self._pending.pop(best_sig)
                    if len(reqs) > self.max_batch:
                        self._pending[best_sig] = reqs[self.max_batch:]
                    return reqs[:self.max_batch]
                oldest = max((r[0].age_ms(now)
                              for r in self._pending.values()), default=None)
                if oldest is None:
                    self._cond.wait()
                else:
                    self._cond.wait(
                        max(0.0, self.max_latency_ms - oldest) / 1000.0
                        + 0.0005)

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._execute(batch)
            finally:
                with self._cond:
                    self._depth -= len(batch)
                    self._cond.notify_all()

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        # past the largest bucket the flush cap is the last bucket
        return self.max_batch

    def _execute(self, batch):
        t_start = time.monotonic()
        live = []
        for req in batch:
            if req.cancelled:
                req.event.set()
            elif req.expired(t_start):
                req.queue_ms = req.age_ms(t_start)
                req.error = DeadlineExceeded(
                    f"request to {self.name!r} spent {req.queue_ms:.1f}ms "
                    "queued, past its deadline", queue_ms=req.queue_ms)
                req.event.set()
            else:
                live.append(req)
        if not live:
            return
        n = len(live)
        padded_to = self._bucket_for(n)
        try:
            stacked = [np.stack([r.inputs[i] for r in live])
                       for i in range(len(live[0].inputs))]
            if padded_to > n:
                stacked = [np.concatenate(
                    [s, np.zeros((padded_to - n,) + s.shape[1:], s.dtype)])
                    for s in stacked]
            t_exec = time.monotonic()
            out = self.predictor(*stacked)
            compute_ms = (time.monotonic() - t_exec) * 1000.0
        except Exception as e:  # any failure goes to every request of the batch
            err = e if isinstance(e, ServingError) else ServingError(
                f"batch execution failed for {self.name!r}: "
                f"{type(e).__name__}: {e}")
            for req in live:
                req.queue_ms = (t_start - req.t_enqueue) * 1000.0
                req.error = err
                req.event.set()
            return
        self.batches[(n, padded_to)] += 1
        now = time.monotonic()
        for i, req in enumerate(live):
            req.queue_ms = (t_start - req.t_enqueue) * 1000.0
            req.compute_ms = compute_ms
            if req.expired(now):
                req.error = DeadlineExceeded(
                    f"request to {self.name!r} finished past its "
                    "deadline", queue_ms=req.queue_ms,
                    compute_ms=compute_ms)
            else:
                req.batch_out, req.row = out, i
            req.event.set()

    # -- lifecycle ----------------------------------------------------

    def drain(self, timeout=30.0):
        """Stop admitting, flush everything queued, stop the worker.
        Returns whether the worker ended within ``timeout``."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout)
        return not self._worker.is_alive()
