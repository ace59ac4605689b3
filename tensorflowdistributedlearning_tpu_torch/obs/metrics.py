"""Metrics registry: counters, gauges and wall-time histograms (the port's
own copy of the JAX package's ``obs/metrics.py``). Host-side, numpy only.

``TimeHistogram`` keeps a bounded ring of recent samples for percentiles and
exact counts and totals; ``drain()`` hands one window's samples to the serve
ledger windows (:class:`SampleWindow`), and the lifetime totals survive
drains. ``MetricsRegistry.render_prometheus`` exposes the same instruments in
the Prometheus text exposition format (``text/plain; version=0.0.4``) under
the JAX package's metric names: counters as ``*_total``, gauges verbatim,
time histograms as summaries (``{quantile=...}`` over the retained samples,
lifetime-exact ``_sum`` / ``_count``).
"""

from __future__ import annotations

import collections
import re
import threading
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np


def time_summary(times: Sequence[float], skip_first: int = 0) -> Dict[str, float]:
    """count/mean/p50/p90/p99/max/total of durations in seconds.
    ``skip_first`` drops leading samples unless that would drop all of them.
    Raises on an empty sequence (a vacuous summary would read as a measured
    zero)."""
    if not times:
        raise ValueError("time_summary: no samples recorded")
    ts = np.asarray(list(times[skip_first:]) or list(times), np.float64)
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


class SampleWindow(list):
    """What ``TimeHistogram.drain()`` returns: the retained samples of the
    drained interval, with its EXACT ``count`` and ``total_s`` (the ring may
    have kept fewer samples than were recorded)."""

    def __init__(self, samples: Sequence[float], count: int, total_s: float):
        super().__init__(samples)
        self.count = int(count)
        self.total_s = float(total_s)


def window_total_s(samples) -> float:
    """Exact wall-seconds of a drained window (``total_s`` when the window
    carries it, else the plain sum)."""
    if samples is None:
        return 0.0
    exact = getattr(samples, "total_s", None)
    return float(exact) if exact is not None else float(sum(samples))


def window_count(samples) -> int:
    """Exact sample count of a drained window (see :func:`window_total_s`)."""
    if samples is None:
        return 0
    exact = getattr(samples, "count", None)
    return int(exact) if exact is not None else len(samples)


class TimeHistogram:
    """Durations in seconds; percentiles over a ring of the most recent
    ``max_samples``, exact count and total over everything recorded since
    the last ``drain()``, and lifetime count and total that drains do not
    reset (the monotonic series Prometheus scrapes)."""

    DEFAULT_MAX_SAMPLES = 8192

    def __init__(self, name: str, max_samples: int = DEFAULT_MAX_SAMPLES):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: Deque[float] = collections.deque(maxlen=self.max_samples)
        self._count = 0
        self._total_s = 0.0
        self.lifetime_count = 0
        self.lifetime_total_s = 0.0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._samples.append(s)
            self._count += 1
            self._total_s += s
            self.lifetime_count += 1
            self.lifetime_total_s += s

    def __len__(self) -> int:
        return self._count

    @property
    def total_s(self) -> float:
        return self._total_s

    @property
    def samples(self) -> List[float]:
        """The retained samples (at most ``max_samples``, most recent)."""
        with self._lock:
            return list(self._samples)

    def samples_since(self, mark: int) -> List[float]:
        """Samples recorded after position ``mark`` (a previous ``len()``);
        a mark the ring has evicted past resolves to everything retained."""
        with self._lock:
            evicted = self._count - len(self._samples)
            return list(self._samples)[max(0, mark - evicted):]

    def drain(self) -> SampleWindow:
        """Take (and clear) the interval since the last drain."""
        with self._lock:
            out = SampleWindow(self._samples, self._count, self._total_s)
            self._samples.clear()
            self._count = 0
            self._total_s = 0.0
        return out

    def summary(self, skip_first: int = 0) -> Dict[str, float]:
        with self._lock:
            retained = list(self._samples)
            count, total_s = self._count, self._total_s
        s = time_summary(retained, skip_first=skip_first)
        if skip_first == 0 and count > len(retained):
            s["count"] = float(count)
            s["total_s"] = total_s
            s["mean_s"] = total_s / count
        return s


_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    base = _PROM_INVALID.sub("_", name)
    if base and base[0].isdigit():
        base = "_" + base
    return f"{prefix}_{base}" if prefix else base


def _prom_num(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return format(f, ".10g")


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

    def render_prometheus(self, prefix: str = "tfdl") -> str:
        """Prometheus text exposition (format 0.0.4): names sanitised to
        ``[a-zA-Z0-9_:]`` under ``prefix``, counters with ``_total``, time
        histograms as summaries in seconds (quantiles over the retained ring,
        omitted while it is empty; ``_sum`` / ``_count`` lifetime-exact)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted((n, g.value) for n, g in self._gauges.items() if g.value is not None)
            hists = sorted(self._histograms.items())
        lines: List[str] = []
        for name, c in counters:
            pname = _prom_name(name, prefix) + "_total"
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_prom_num(c.value)}")
        for name, value in gauges:
            pname = _prom_name(name, prefix)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(value)}")
        for name, h in hists:
            if not h.lifetime_count:
                continue
            pname = _prom_name(name, prefix) + "_seconds"
            lines.append(f"# TYPE {pname} summary")
            retained = h.samples
            if retained:
                arr = np.asarray(retained, np.float64)
                for q in (0.5, 0.9, 0.99):
                    lines.append(f'{pname}{{quantile="{q}"}} {_prom_num(np.percentile(arr, q * 100))}')
            lines.append(f"{pname}_sum {_prom_num(h.lifetime_total_s)}")
            lines.append(f"{pname}_count {_prom_num(h.lifetime_count)}")
        return "\n".join(lines) + "\n"
