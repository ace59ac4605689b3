"""Metrics registry: counters, gauges and wall-time histograms (the port's
own copy of the instruments in the JAX package's ``obs/metrics.py`` that the
serving engine, batcher and server read). Host-side, numpy only. The
Prometheus exposition arrives with the port's ``obs/`` slice."""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional, Sequence

import numpy as np


def time_summary(times: Sequence[float]) -> Dict[str, float]:
    """count/mean/p50/p90/p99/max/total of durations in seconds. Raises on
    an empty sequence (a vacuous summary would read as a measured zero)."""
    if not times:
        raise ValueError("time_summary: no samples recorded")
    ts = np.asarray(list(times), np.float64)
    return {
        "count": float(len(ts)),
        "mean_s": float(ts.mean()),
        "p50_s": float(np.percentile(ts, 50)),
        "p90_s": float(np.percentile(ts, 90)),
        "p99_s": float(np.percentile(ts, 99)),
        "max_s": float(ts.max()),
        "total_s": float(ts.sum()),
    }


class Counter:
    """Monotonic event counter (increments from many threads are locked)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-value-wins instantaneous measurement."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._value


class TimeHistogram:
    """Durations in seconds; percentiles over a ring of the most recent
    ``max_samples``, exact count and total over everything recorded."""

    DEFAULT_MAX_SAMPLES = 8192

    def __init__(self, name: str, max_samples: int = DEFAULT_MAX_SAMPLES):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self._lock = threading.Lock()
        self._samples: Deque[float] = collections.deque(maxlen=int(max_samples))
        self._count = 0
        self._total_s = 0.0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._samples.append(s)
            self._count += 1
            self._total_s += s

    def __len__(self) -> int:
        return self._count

    def summary(self) -> Dict[str, float]:
        with self._lock:
            retained = list(self._samples)
            count, total_s = self._count, self._total_s
        s = time_summary(retained)
        if count > len(retained):
            s["count"] = float(count)
            s["total_s"] = total_s
            s["mean_s"] = total_s / count
        return s


class MetricsRegistry:
    """Named instrument registry (get-or-create, thread-safe creation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, TimeHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> TimeHistogram:
        with self._lock:
            return self._histograms.setdefault(name, TimeHistogram(name))

    def snapshot(self) -> Dict[str, Dict]:
        """One JSON-serializable view of every instrument (histograms as
        summaries, empty ones omitted)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {n: g.value for n, g in gauges.items() if g.value is not None},
            "histograms": {n: h.summary() for n, h in hists.items() if len(h)},
        }
