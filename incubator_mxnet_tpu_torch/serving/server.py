"""ModelServer — stdlib HTTP front end over FrozenModel + DynamicBatcher
(counterpart of ``incubator_mxnet_tpu/serving/server.py``).

* ``POST /predict`` — body ``{"data": <nested list>, "timeout_ms": N?}``;
  200 with ``{"output": ..., "batch_size": n, "batch_id": i,
  "batch_index": j, "latency_ms": t}``, or the admission error's HTTP code
  (400 invalid, 429 queue full, 504 deadline, 503 draining) with
  ``{"error": ..., "message": ...}``;
* ``GET /healthz`` — shallow: 200 ``{"status": "ok"}`` while the batcher
  runs and admits, 503 ``"draining"`` or ``"degraded"`` otherwise;
* ``GET /stats`` — serving counters, batch fill, latency percentiles,
  queue depth, uptime and QPS.

``stop()`` drains: /healthz turns 503, admissions stop, the batcher
finishes every accepted request, then the listener closes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import DynamicBatcher
from .errors import InvalidInputError, ServingError
from .frozen import FrozenModel

__all__ = ["ModelServer"]


class _Handler(BaseHTTPRequestHandler):
    """One HTTP request. It reaches its ModelServer through ``self.server``
    (the HTTP server, which holds it as ``model_server``): the class itself
    holds no reference to any server, so a stopped ModelServer and its
    FrozenModel are freed as soon as the last reference goes, with no
    reference cycle left for the collector."""

    protocol_version = "HTTP/1.1"
    # headers and body leave as separate small segments, and Nagle holds
    # the second until the first is ACKed, which a delayed ACK can hold for
    # ~40 ms: send at once
    disable_nagle_algorithm = True

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        server = self.server.model_server
        try:
            if self.path.startswith("/healthz"):
                code, doc = server.health()
                self._reply(code, doc)
            elif self.path.startswith("/stats"):
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "NotFound", "message": self.path})
        except Exception as e:  # noqa: BLE001
            self._safe_500(e)

    def do_POST(self):
        server = self.server.model_server
        try:
            if not self.path.startswith("/predict"):
                self._reply(404, {"error": "NotFound", "message": self.path})
                return
            length = int(self.headers.get("Content-Length") or 0)
            try:
                doc = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(doc, dict) or "data" not in doc:
                    raise ValueError("body must be a JSON object with a "
                                     "'data' key")
                x = np.asarray(doc["data"], dtype=server.model.dtype)
            except (ValueError, TypeError) as e:
                raise InvalidInputError(str(e)) from e
            t0 = time.perf_counter()
            b = server.batcher
            req = b.submit(x, timeout_ms=doc.get("timeout_ms"))
            outs = req.wait((doc.get("timeout_ms") or b.default_timeout_ms)
                            / 1e3 + 30.0)
            out = outs[0] if len(outs) == 1 else outs
            self._reply(200, {
                "output": (out.tolist() if isinstance(out, np.ndarray)
                           else [o.tolist() for o in out]),
                "batch_size": req.batch_size,
                "batch_id": req.batch_id,
                "batch_index": req.batch_index,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        except ServingError as e:
            self._reply(e.code, e.to_json())
        except Exception as e:  # noqa: BLE001
            self._safe_500(e)

    def _safe_500(self, e):
        try:
            self._reply(500, {"error": type(e).__name__,
                              "message": str(e)[:500]})
        except OSError:
            pass

    def log_message(self, *a):   # stay quiet on stderr
        pass


class _HTTPServer(ThreadingHTTPServer):
    """The listener of one ModelServer, which it holds as `model_server`
    for the handlers."""

    def __init__(self, address, model_server):
        self.model_server = model_server
        # socketserver's default accept backlog is 5: a burst of concurrent
        # clients overflows the SYN queue and pays kernel retransmit
        # timeouts (1 s, 3 s). Size it like the admission queue; beyond
        # that the 429 path answers.
        self.request_queue_size = max(128, model_server.batcher.queue_limit)
        super().__init__(address, _Handler)


class ModelServer:
    """Serve a FrozenModel (or freeze a module in place) over HTTP.

    ``ModelServer(net, input_shape=(128,), dtype="int32").start()`` returns
    ``(host, port)``; port 0 (default) binds a free one.
    """

    def __init__(self, model, input_shape=None, host="127.0.0.1", port=0,
                 max_batch=None, max_delay_ms=5.0, queue_limit=256,
                 default_timeout_ms=1000.0, **freeze_kwargs):
        if not isinstance(model, FrozenModel):
            if input_shape is None:
                raise ValueError("input_shape is required when passing an "
                                 "unfrozen module")
            model = FrozenModel(model, input_shape, **freeze_kwargs)
        self.model = model
        self.host = host
        self.port = int(port)
        self.batcher = DynamicBatcher(
            model, max_batch=max_batch, max_delay_ms=max_delay_ms,
            queue_limit=queue_limit, default_timeout_ms=default_timeout_ms)
        self._httpd = None
        self._started_at = None
        self._draining = False

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self.batcher.start()
        self._httpd = _HTTPServer((self.host, self.port), self)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="serving-http", daemon=True).start()
        self._started_at = time.time()
        self._draining = False
        return self.host, self.port

    def stop(self, drain: bool = True):
        """Graceful shutdown: mark draining (healthz 503), stop
        admissions, finish accepted requests, then close the listener and
        drop it (nothing of the listener refers back to this server
        after)."""
        self._draining = True
        self.batcher.stop(drain=drain)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- health and stats -------------------------------------------------
    def health(self):
        """(http_code, body) for /healthz."""
        if self._draining:
            status = "draining"
        elif not self.batcher.running:
            status = "degraded"
        else:
            status = "ok"
        return (200 if status == "ok" else 503), {
            "status": status, "model": repr(self.model),
            "buckets": list(self.model.buckets),
            "queue_depth": self.batcher.queue_depth}

    def stats(self) -> dict:
        """One registry snapshot plus the server's settings and QPS."""
        s = self.batcher.stats()
        uptime = (time.time() - self._started_at) if self._started_at \
            else 0.0
        s["uptime_s"] = round(uptime, 3)
        responses = s.get("serving.responses", 0)
        s["qps"] = round(responses / uptime, 3) if uptime > 0 else 0.0
        s["draining"] = self._draining
        s["buckets"] = list(self.model.buckets)
        s["max_batch"] = self.batcher.max_batch
        s["max_delay_ms"] = self.batcher.max_delay_s * 1e3
        s["queue_limit"] = self.batcher.queue_limit
        return s
