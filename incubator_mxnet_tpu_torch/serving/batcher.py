"""DynamicBatcher — request coalescing under a latency/size policy
(counterpart of ``incubator_mxnet_tpu/serving/batcher.py``).

Single-sample requests enter a bounded thread-safe queue; one dispatcher
thread coalesces whatever is waiting into the smallest bucket of the
FrozenModel that fits, bounded by

* ``max_batch``    — never batch more than this many requests, and
* ``max_delay_ms`` — never hold the FIRST request of a batch longer than
  this before dispatching (the tail-latency knob).

Admission control is explicit and total — a request is never silently
dropped:

* **validation** at submit: shape/dtype mismatch raises
  :class:`InvalidInputError` immediately (nothing enqueued);
* **backpressure** at submit: a full queue raises :class:`QueueFullError`;
* **deadlines**: each request carries `enqueue time + timeout`; the
  dispatcher rejects expired requests with :class:`DeadlineExceededError`
  before spending device time on them, and a request whose deadline passed
  while its batch ran is rejected too, not answered late;
* **drain**: ``stop(drain=True)`` stops admissions
  (:class:`ServerClosedError`) but completes every request already
  accepted before the dispatcher exits.

Telemetry goes to the ``serving`` domain of ``profiler``: request,
response and reject counters, batch count and coalesced-size counter
(their ratio is the batch fill), a queue-depth gauge, and the
``serving.latency_ms`` / ``serving.batch_exec_ms`` histograms.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import profiler as _prof
from .errors import (DeadlineExceededError, QueueFullError,
                     ServerClosedError)

__all__ = ["DynamicBatcher", "Request"]


def _c(name):
    return _prof.counter(name, "serving")


class Request:
    """One in-flight prediction: the dispatcher fulfils it (result or
    error) and sets the event; the submitting thread blocks in `wait`."""

    __slots__ = ("x", "enqueued_at", "deadline", "batch_size", "batch_id",
                 "batch_index", "_event", "_result", "_error")

    def __init__(self, x, timeout_ms):
        self.x = x
        self.enqueued_at = time.perf_counter()
        self.deadline = (self.enqueued_at + timeout_ms / 1e3
                         if timeout_ms else None)
        self.batch_size = None          # size of the batch that served us
        self.batch_id = None            # dispatch sequence number
        self.batch_index = None         # our row within that batch
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _fulfil(self, result=None, error=None):
        self._result = result
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout=None):
        """Block until served; returns the per-output list of numpy arrays
        (batch dim stripped) or raises the rejection error."""
        if not self._event.wait(timeout):
            raise DeadlineExceededError(
                "request not served within the client wait timeout")
        if self._error is not None:
            raise self._error
        return self._result


class DynamicBatcher:
    def __init__(self, model, max_batch=None, max_delay_ms=5.0,
                 queue_limit=256, default_timeout_ms=1000.0):
        self.model = model
        self.max_batch = int(max_batch or model.max_batch)
        if self.max_batch > model.max_batch:
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the largest bucket "
                f"{model.max_batch}")
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.queue_limit = int(queue_limit)
        self.default_timeout_ms = float(default_timeout_ms)
        self._q = collections.deque()
        self._cond = threading.Condition()
        self._closed = False           # no new admissions
        self._stopped = False          # dispatcher must exit (after drain)
        self._thread = None
        self._dispatch_seq = 0         # only the dispatcher increments

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._closed = False
        self._stopped = False
        self._thread = threading.Thread(target=self._run,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop admissions; with `drain` (default) the dispatcher serves
        everything already queued before exiting, otherwise queued
        requests are rejected with ServerClosedError (still not silently
        dropped)."""
        with self._cond:
            self._closed = True
            if not drain:
                self._flush_closed_locked()
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        # with a dead or never-started dispatcher (or a join that timed
        # out) nobody is left to serve what is still queued: reject it
        # rather than leave its clients waiting
        with self._cond:
            self._flush_closed_locked()

    def _flush_closed_locked(self):
        """Reject everything still queued (caller holds ``self._cond``)."""
        while self._q:
            req = self._q.popleft()
            _c("serving.rejected_closed").increment()
            req._fulfil(error=ServerClosedError(
                "server stopped before this request was served"))
        _prof.set_gauge("serving.queue_depth", 0, "serving")

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def queue_depth(self) -> int:
        return len(self._q)        # len(deque) is GIL-atomic; no lock

    # -- admission --------------------------------------------------------
    def submit(self, x, timeout_ms=None) -> Request:
        """Enqueue one SINGLE-SAMPLE request (shape = model.input_shape,
        or (1,) + input_shape). Raises instead of queueing when invalid,
        closed, or over capacity."""
        x = np.asarray(x)
        if x.ndim == len(self.model.input_shape) + 1 and x.shape[0] == 1:
            x = x[0]
        _c("serving.requests").increment()
        try:
            self.model.validate(x)     # InvalidInputError on mismatch
        except Exception:
            _c("serving.rejected_invalid").increment()
            raise
        req = Request(np.ascontiguousarray(x),
                      self.default_timeout_ms if timeout_ms is None
                      else timeout_ms)
        with self._cond:
            if self._closed:
                _c("serving.rejected_closed").increment()
                raise ServerClosedError("server is draining; not "
                                        "accepting new requests")
            if len(self._q) >= self.queue_limit:
                _c("serving.rejected_queue_full").increment()
                raise QueueFullError(
                    f"request queue at capacity ({self.queue_limit})")
            self._q.append(req)
            _prof.set_gauge("serving.queue_depth", len(self._q), "serving")
            self._cond.notify()
        return req

    # -- dispatch loop ----------------------------------------------------
    def _gather(self):
        """Wait for the first request, then coalesce until max_batch or
        the first request has waited max_delay. Returns [] at shutdown."""
        with self._cond:
            while not self._q:
                if self._stopped:
                    return []
                self._cond.wait(0.05)
            dispatch_at = self._q[0].enqueued_at + self.max_delay_s
            while len(self._q) < self.max_batch:
                remaining = dispatch_at - time.perf_counter()
                if remaining <= 0 or self._stopped:
                    break
                self._cond.wait(remaining)
            batch = []
            while self._q and len(batch) < self.max_batch:
                batch.append(self._q.popleft())
            _prof.set_gauge("serving.queue_depth", len(self._q), "serving")
            return batch

    def _run(self):
        while True:
            batch = self._gather()
            if not batch:
                with self._cond:
                    if self._stopped and not self._q:
                        return
                continue
            self._serve(batch)

    def _serve(self, batch):
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req._fulfil(error=DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - req.enqueued_at) * 1e3:.1f} ms in queue"))
                _c("serving.rejected_deadline").increment()
            else:
                live.append(req)
        if not live:
            return
        bid = self._dispatch_seq
        self._dispatch_seq = bid + 1
        n = len(live)
        try:
            bucket = self.model.bucket_for(n)
            x = np.stack([r.x for r in live])
            t0 = time.perf_counter()
            outs = self.model.predict_batch(x)
            exec_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — a bad batch must not kill
            for req in live:    # the dispatcher; reject and keep serving
                req._fulfil(error=e)
            _c("serving.batch_errors").increment()
            return
        _c("serving.batches").increment()
        _c("serving.batched_requests").increment(n)
        _prof.observe("serving.batch_exec_ms", exec_ms, "serving")
        _prof.observe("serving.batch_size", float(n), "serving")
        _prof.observe(f"serving.exec_ms.b{bucket}", exec_ms, "serving")
        done = time.perf_counter()
        # a deadline that expired DURING the batch is a rejection, not a
        # late success: the deadline is the client's stated limit
        responded, late = [], []
        for i, req in enumerate(live):
            req.batch_size = n
            req.batch_id = bid
            req.batch_index = i
            if req.deadline is not None and done > req.deadline:
                late.append(req)
            else:
                responded.append(req)
        # telemetry BEFORE fulfil: a /stats read the instant a client's
        # predict() returns must already count that request
        for req in responded:
            _prof.observe("serving.latency_ms",
                          (done - req.enqueued_at) * 1e3, "serving")
        if responded:
            _c("serving.responses").increment(len(responded))
        if late:
            _c("serving.rejected_deadline_post_batch").increment(len(late))
        for req in responded:
            req._fulfil(result=[o[req.batch_index] for o in outs])
        for req in late:
            req._fulfil(error=DeadlineExceededError(
                f"deadline exceeded during batch execution "
                f"({exec_ms:.1f} ms in bucket {bucket})"))

    # -- stats ------------------------------------------------------------
    @staticmethod
    def stats() -> dict:
        """Serving-domain counters + derived headline numbers."""
        snap = {k.split("/", 1)[1]: v
                for k, v in _prof.counters().items()
                if k.startswith("serving/")}
        batches = snap.get("serving.batches", 0)
        coalesced = snap.get("serving.batched_requests", 0)
        snap["batch_fill"] = (coalesced / batches) if batches else 0.0
        lat = snap.get("serving.latency_ms")
        if isinstance(lat, dict):
            snap["p50_ms"] = lat.get("p50")
            snap["p95_ms"] = lat.get("p95")
            snap["p99_ms"] = lat.get("p99")
        return snap
