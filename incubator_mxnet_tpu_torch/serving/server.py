"""HTTP front end (counterpart of ``incubator_mxnet_tpu/serving/server.py``).

Endpoints, with the JAX server's bodies:

* ``POST /v1/models/{name}:predict`` — ``{"inputs": [tensor, ...],
  "timeout_ms": n?}``, each tensor a nested JSON list shaped like the
  exported input without its batch axis.  Answers
  ``{"outputs": [...], "timing": {"queue_ms":, "compute_ms":}}``.
* ``GET /healthz`` — liveness and per-model queue depths; 503 while
  draining.

Each handler thread blocks while its request rides a batch: the
threading server gives one thread per request, the batcher turns them
into bucket-sized launches.  Metrics, admin verbs, sessions, the router
and flight recording are not ported yet.

Run: ``python -m incubator_mxnet_tpu_torch.serving.server --model
name=<prefix> --port 8080`` (``--device cpu`` to serve on the CPU).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..base import get_env
from .admission import BadRequest, ServingError
from .model_repository import ModelRepository

__all__ = ["InferenceServer", "health_body", "main"]


def health_body(repository, t_start=None):
    """``(code, body)`` of ``/healthz``."""
    draining = repository.draining
    models, total = {}, 0
    for name, d in repository.models().items():
        total += d["queue_depth"]
        models[name] = dict(d, state="draining" if draining else "ready")
    body = {"status": "draining" if draining else "ok",
            "uptime_s": (round(time.monotonic() - t_start, 3)
                         if t_start is not None else None),
            "queue_depth": total,
            "models": models}
    return (503 if draining else 200), body


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the stdlib backlog of 5 drops a burst of concurrent connects into
    # a one-second TCP retransmit
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if get_env("MXNET_SERVING_VERBOSE", False, bool):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    @property
    def app(self):
        return self.server.app

    def _send(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self):
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            return self._send(*health_body(self.app.repository,
                                           self.app.t_start))
        self._send(404, {"error": "NotFound", "message": path})

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            name = path[len("/v1/models/"):-len(":predict")]
            if name:
                return self._predict(name)
        self._read_body()
        self._send(404, {"error": "NotFound", "message": path})

    def _predict(self, name):
        try:
            code, payload = 200, self._predict_inner(name)
        except ServingError as e:
            code, payload = e.http_status, e.payload()
        except Exception as e:  # the HTTP boundary: any error is a 500
            code = 500
            payload = {"error": type(e).__name__, "message": str(e)}
        self._send(code, payload)

    def _predict_inner(self, name):
        # the body is read before anything can fail, so a kept-alive
        # connection never holds a stale one; the model is resolved
        # before the body is parsed, so an unknown name is a 404
        raw = self._read_body()
        entry = self.app.repository.get(name)
        try:
            body = json.loads(raw or b"{}")
        except (ValueError, UnicodeDecodeError) as e:
            raise BadRequest(f"request body is not JSON: {e}") from None
        if not isinstance(body, dict) or not isinstance(body.get("inputs"),
                                                        list):
            raise BadRequest('body needs "inputs": [tensor, ...]')
        specs = entry.predictor.meta["inputs"]
        if len(body["inputs"]) != len(specs):
            raise BadRequest(f"model {name!r} takes {len(specs)} inputs, "
                             f"got {len(body['inputs'])}")
        try:
            arrs = tuple(np.asarray(x, dtype=spec["dtype"])
                         for x, spec in zip(body["inputs"], specs))
        except (TypeError, ValueError, OverflowError) as e:
            raise BadRequest(f"malformed input tensor: {e}") from None
        for a, spec in zip(arrs, specs):
            want = tuple(spec["shape"][1:])
            if tuple(a.shape) != want:
                raise BadRequest(f"instance shape {tuple(a.shape)} != "
                                 f"exported instance shape {want}")
        pending = self.app.repository.predict_async(
            name, arrs, body.get("timeout_ms"))
        out, timing = pending.result()
        return {"outputs": [o.tolist() for o in out],
                "timing": {k: round(v, 3) for k, v in timing.items()
                           if v is not None}}


class InferenceServer:
    """The repository and the HTTP listener as one unit.  Without a
    ``repository`` it makes one on ``device`` (``cuda:0`` unless given;
    raises without CUDA) with ``buckets``."""

    def __init__(self, repository=None, host="127.0.0.1", port=0,
                 buckets=None, device=None):
        self.repository = repository or ModelRepository(buckets=buckets,
                                                        device=device)
        self.host = host
        self.port = int(port)
        self.t_start = time.monotonic()
        self._httpd = None
        self._thread = None

    def start(self):
        """Bind and serve on a background thread; returns the bound port
        (an ephemeral one when constructed with port 0)."""
        self._httpd = _HTTPServer((self.host, self.port), _Handler)
        self._httpd.app = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()
        return self.port

    def shutdown(self, drain=True, timeout=30.0):
        """Drain the queues first, so queued requests get real answers,
        then close the listener."""
        if drain:
            self.repository.drain_all(timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


def main(argv=None):
    import argparse
    import signal

    p = argparse.ArgumentParser(
        description="dynamic-batching inference server (PyTorch port)")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=PREFIX",
                   help="load artifact PREFIX as model NAME at startup")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int,
                   default=get_env("MXNET_SERVING_PORT", 8080, int))
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default cuda:0)")
    args = p.parse_args(argv)

    server = InferenceServer(host=args.host, port=args.port,
                             device=args.device)
    for spec in args.model:
        name, sep, path = spec.partition("=")
        if not sep:
            p.error(f"--model wants NAME=PREFIX, got {spec!r}")
        server.repository.load(name, path)
        print(f"[serving] loaded {name} from {path}", flush=True)
    port = server.start()
    print(f"[serving] listening on {args.host}:{port} "
          f"({server.repository.device})", flush=True)

    done = threading.Event()

    def stop(signum, frame):
        print(f"[serving] signal {signum}: draining", flush=True)
        done.set()

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    done.wait()
    server.shutdown(drain=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
