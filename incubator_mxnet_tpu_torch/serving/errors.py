"""Serving error taxonomy (a copy of ``incubator_mxnet_tpu/serving/
errors.py``: same classes, same codes). Every error carries an HTTP-ish
status code so the stdlib front end (serving/server.py) can map rejections
to proper client/server status lines, and callers embedding the batcher
directly can branch on `code` without string matching.

Contract (tested in tests/test_torch_serving.py): a request is NEVER
silently dropped — every accepted `submit()` either resolves with a result
or raises one of these from `wait()`, including during shutdown drain.
"""
from __future__ import annotations

__all__ = ["ServingError", "InvalidInputError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError",
           "ReshardingGateError"]


class ServingError(RuntimeError):
    """Base serving failure; `code` follows HTTP semantics."""

    code = 500

    def to_json(self) -> dict:
        return {"error": type(self).__name__, "message": str(self),
                "code": self.code}


class InvalidInputError(ServingError):
    """Malformed request: wrong shape/dtype, or larger than the largest
    compiled bucket (client error, not capacity)."""

    code = 400


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at capacity — fail fast
    so the client can retry/shed instead of stacking latency."""

    code = 429


class DeadlineExceededError(ServingError):
    """The request's deadline passed before (or while) it could be
    served; it was rejected, not dropped."""

    code = 504


class ServerClosedError(ServingError):
    """The server/batcher is draining or stopped; no new work accepted."""

    code = 503


class ReshardingGateError(ServingError):
    """A mesh-sharded FrozenModel compile produced resharding
    collectives (commscope's accidental-all-gather verdict) on the
    serve path — a per-request p99 catastrophe, refused at deploy time
    rather than discovered in production tails. Fix the layout (or pass
    ``reshard_gate=False`` to serve degraded, flagged in /healthz)."""

    code = 500
