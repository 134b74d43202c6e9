"""Thread-safe counters, gauges and histograms: the part of
``incubator_mxnet_tpu/profiler/counters.py`` that the serving ``/stats``
endpoint reads, and the ``mxtpu/trainer.steps`` counter that
``gluon.Trainer.step`` increments.

Names are ``domain/name``. A histogram's value is a dict with count, sum,
min, max, cumulative buckets and interpolated p50/p95/p99.
"""
from __future__ import annotations

import bisect
import threading

__all__ = ["Counter", "Histogram", "counter", "histogram", "observe",
           "set_gauge", "counters", "reset_counters"]

_registry: dict = {}
_lock = threading.Lock()

# request latencies in milliseconds, about four buckets a decade
DEFAULT_HISTOGRAM_BOUNDS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)


class Counter:
    """A counter (``increment``) or, once ``set_value`` is used, a gauge."""

    __slots__ = ("name", "domain", "value", "kind")

    def __init__(self, name: str, domain: str):
        self.name = name
        self.domain = domain
        self.value = 0
        self.kind = "counter"

    def increment(self, delta=1):
        with _lock:
            self.value += delta
            return self.value

    def set_value(self, value):
        with _lock:
            self.value = value
            self.kind = "gauge"


class Histogram:
    """Fixed upper bounds; ``observe`` is one lock acquire."""

    __slots__ = ("name", "domain", "kind", "bounds", "_counts", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, domain: str):
        self.name = name
        self.domain = domain
        self.kind = "histogram"
        self.bounds = DEFAULT_HISTOGRAM_BOUNDS
        self._counts = [0] * (len(self.bounds) + 1)   # last: +Inf
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, value):
        v = float(value)
        with _lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @staticmethod
    def _percentile(counts, bounds, n, mn, mx, q):
        """Linear interpolation inside the bucket that holds quantile q,
        clamped to the observed min and max."""
        if n == 0:
            return None
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            prev, cum = cum, cum + c
            if cum >= target and c:
                lo = bounds[i - 1] if i > 0 else mn
                hi = bounds[i] if i < len(bounds) else mx
                est = lo + (hi - lo) * (target - prev) / c
                return min(max(est, mn), mx)
        return mx

    @property
    def value(self) -> dict:
        """Snapshot; the caller holds the registry lock."""
        counts = list(self._counts)
        mn, mx = self._min, self._max
        buckets, cum = {}, 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            buckets[repr(float(bound))] = cum
        n = cum + counts[-1]
        buckets["+Inf"] = n
        pct = {f"p{int(q * 100)}": self._percentile(counts, self.bounds, n,
                                                    mn, mx, q)
               for q in (0.50, 0.95, 0.99)}
        return {"count": n, "sum": self._sum, "min": mn, "max": mx,
                "buckets": buckets, **pct}


def _get(name, domain, cls):
    key = f"{domain}/{name}"
    with _lock:
        c = _registry.get(key)
        if c is None:
            c = _registry[key] = cls(name, domain)
    if not isinstance(c, cls):
        raise TypeError(f"{key} is already registered as a {c.kind}")
    return c


def counter(name: str, domain: str = "mxtpu") -> Counter:
    """Get or create the counter ``domain/name``."""
    return _get(name, domain, Counter)


def histogram(name: str, domain: str = "mxtpu") -> Histogram:
    """Get or create the histogram ``domain/name``."""
    return _get(name, domain, Histogram)


def observe(name: str, value, domain: str = "mxtpu") -> None:
    histogram(name, domain).observe(value)


def set_gauge(name: str, value, domain: str = "mxtpu") -> None:
    counter(name, domain).set_value(value)


def counters() -> dict:
    """Snapshot of the registry: ``{domain/name: value}``."""
    with _lock:
        return {k: c.value for k, c in _registry.items()}


def reset_counters():
    with _lock:
        _registry.clear()
