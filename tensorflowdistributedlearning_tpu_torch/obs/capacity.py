"""Device-memory watermarks and chip-seconds (the port's copy of the JAX
package's ``obs/capacity.py``, same event names and fields).

- :class:`WatermarkTracker`: per-phase peak device memory with a headroom
  estimate and a linear trend. On CUDA, ``torch.cuda.memory_stats`` gives
  JAX's ``bytes_in_use`` (``allocated_bytes.all.current``) and
  ``peak_bytes_in_use`` (``allocated_bytes.all.peak``), and
  ``torch.cuda.mem_get_info`` the card's total as ``bytes_limit``, for the
  served engines' cards only. A process
  that has not initialised CUDA (every CPU run) reports nothing, and the
  tracker stays inert, as the JAX package's does on a CPU.
- :class:`CostMeter`: each dispatched batch's engine time times the chip
  count (the cards the served engines run on), split across its member requests by their share of the batch
  (padding is charged to the requests that rode the bucket); drained per
  serve window into a ``cost`` ledger event.

Both are host bookkeeping on the window cadence: one allocator query and a
few float operations per window.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.obs.metrics import TimeHistogram, window_count, window_total_s

WATERMARK_EVENT = "memory_watermark"
COST_EVENT = "cost"

PHASE_COMPILE = "compile"
PHASE_STEP = "step"
PHASE_EVAL = "eval"
PHASE_CKPT = "ckpt"
PHASE_INFER = "infer"


def _trend_bytes_per_sample(history: Sequence[Tuple[float, int]]) -> Optional[float]:
    """Least-squares slope of peak bytes over the retained samples; None
    under 3 samples."""
    if len(history) < 3:
        return None
    n = len(history)
    ys = [p for _, p in history]
    mean_x = (n - 1) / 2.0
    mean_y = sum(ys) / n
    denom = sum((x - mean_x) ** 2 for x in range(n))
    if not denom:
        return 0.0
    return sum((x - mean_x) * (y - mean_y) for x, y in zip(range(n), ys)) / denom


def cuda_indices(devices: Sequence) -> List[int]:
    """The distinct CUDA indices among ``devices`` (torch devices or names,
    in order); a bare ``cuda`` is the current device, and a device of any
    other type (or None) names no card."""
    import torch

    out: List[int] = []
    for d in devices:
        if d is None:
            continue
        d = torch.device(d)
        if d.type != "cuda":
            continue
        i = d.index if d.index is not None else (torch.cuda.current_device() if torch.cuda.is_initialized() else 0)
        if i not in out:
            out.append(i)
    return out


def memory_stats(devices: Optional[Sequence] = None) -> Dict[str, Dict[str, int]]:
    """Per CUDA device of ``devices`` (default: the current device):
    ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``. Empty when
    CUDA is not initialised in this process, so that a query never creates a
    context."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in cuda_indices(devices if devices is not None else ["cuda"]):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
        }
    return out


def peak_bytes_across_devices(stats: Optional[Dict[str, Dict[str, int]]] = None) -> int:
    """Max ``peak_bytes_in_use`` (else ``bytes_in_use``) across devices; 0
    when nothing is reported or the probe fails."""
    if stats is None:
        try:
            stats = memory_stats() or {}
        except Exception:  # noqa: BLE001 — a failed probe must not crash
            return 0
    return max((int(s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))) for s in stats.values()), default=0)


class WatermarkTracker:
    """Per-phase peak device-memory watermarks.

    ``sample(phase)`` queries the allocator and returns the fields of a
    ``memory_watermark`` event when the peak advanced past the recorded
    high-water mark (or when ``phase`` records its first sample, with
    ``advanced: false`` and ``delta_bytes: 0``); None otherwise, and always
    on a process with no device stats. ``headroom()`` is the live view:
    headroom against ``bytes_limit`` and the trend's samples to the limit."""

    TREND_SAMPLES = 16

    def __init__(self, *, stats_fn: Optional[Callable[[], Dict[str, Dict[str, int]]]] = None):
        self._stats_fn = stats_fn
        # the cards sampled without an injected stats_fn: the served
        # engines' devices (the server sets them), None the current device
        self.devices: Optional[List] = None
        self._lock = threading.Lock()
        self.peak_bytes = 0
        self.bytes_limit: Optional[int] = None
        self.phase_peaks: Dict[str, Dict] = {}
        self._history: Deque[Tuple[float, int]] = collections.deque(maxlen=self.TREND_SAMPLES)
        self.samples = 0
        # the trainers' exact parameter + optimizer-state bytes on the card
        self.predicted_bytes_per_device: Optional[int] = None

    def set_predicted(self, bytes_per_device: Optional[int]) -> None:
        """The exact state bytes each watermark is compared with."""
        if bytes_per_device:
            self.predicted_bytes_per_device = int(bytes_per_device)

    def _query(self, stats: Optional[Dict[str, Dict[str, int]]] = None) -> Tuple[int, Optional[int], int]:
        """(max peak, max limit, live bytes) across devices; zeros when
        nothing is reported."""
        if not stats:
            try:
                stats = (self._stats_fn() if self._stats_fn is not None else memory_stats(self.devices)) or {}
            except Exception:  # noqa: BLE001 — a failed probe must not crash
                return 0, None, 0
        peak = peak_bytes_across_devices(stats)
        live = 0
        limit: Optional[int] = None
        for s in stats.values():
            live = max(live, int(s.get("bytes_in_use", 0)))
            if s.get("bytes_limit"):
                limit = max(limit or 0, int(s["bytes_limit"]))
        return peak, limit, live

    def sample(
        self, phase: str, step: Optional[int] = None, stats: Optional[Dict[str, Dict[str, int]]] = None
    ) -> Optional[Dict]:
        peak, limit, live = self._query(stats)
        if peak <= 0:
            return None
        with self._lock:
            self.samples += 1
            if limit is not None:
                self.bytes_limit = limit
            self._history.append((time.monotonic(), peak))
            prev_global = self.peak_bytes
            advanced = peak > prev_global
            first_for_phase = phase not in self.phase_peaks
            if advanced:
                self.peak_bytes = peak
            if not (advanced or first_for_phase):
                return None
            self.phase_peaks[phase] = {"peak_bytes": peak, "step": step}
            fields: Dict = {
                "phase": phase,
                "peak_bytes": peak,
                "delta_bytes": peak - prev_global if advanced else 0,
                "advanced": advanced,
                "bytes_in_use": live,
            }
            if step is not None:
                fields["step"] = step
            if self.predicted_bytes_per_device:
                fields["predicted_bytes_per_device"] = self.predicted_bytes_per_device
                fields["measured_minus_predicted_bytes"] = peak - self.predicted_bytes_per_device
            if self.bytes_limit:
                fields["bytes_limit"] = self.bytes_limit
                fields["headroom_frac"] = round(max(0.0, 1.0 - peak / self.bytes_limit), 4)
                slope = _trend_bytes_per_sample(list(self._history))
                if slope is not None and slope > 0:
                    fields["samples_to_limit"] = int((self.bytes_limit - peak) / slope)
            return fields

    def headroom(self) -> Optional[Dict]:
        with self._lock:
            if not self.peak_bytes:
                return None
            out: Dict = {"peak_bytes": self.peak_bytes}
            if self.bytes_limit:
                out["bytes_limit"] = self.bytes_limit
                out["headroom_frac"] = round(max(0.0, 1.0 - self.peak_bytes / self.bytes_limit), 4)
            history = list(self._history)
        slope = _trend_bytes_per_sample(history)
        if slope is not None:
            out["trend_bytes_per_sample"] = int(slope)
            if self.bytes_limit and slope > 0:
                out["samples_to_limit"] = int((self.bytes_limit - self.peak_bytes) / slope)
        return out

    def snapshot(self) -> Dict:
        """The /metrics view: per-phase peaks and the headroom estimate."""
        with self._lock:
            out: Dict = {"peak_bytes": self.peak_bytes, "phases": {p: dict(v) for p, v in self.phase_peaks.items()}}
            if self.bytes_limit:
                out["bytes_limit"] = self.bytes_limit
        hr = self.headroom()
        if hr:
            out["headroom"] = hr
        return out


class CostMeter:
    """Chip-seconds of serving requests. One chip-second is one device busy
    for one second. The chip count is the number of cards the served
    engines run on: a port engine runs on one device, so a meter counts 1
    until :meth:`set_devices` is given its engines' devices (the server
    does), and then counts their distinct CUDA cards (1 when none is CUDA:
    cost is then plain wall-seconds). The cards the process merely sees do
    not count."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = int(n_chips)
        self._lock = threading.Lock()
        self.chip_seconds_total = 0.0
        self._request_hist = TimeHistogram("cost/chip_seconds_per_request")
        self._completed_requests = 0
        self._window_started_t = time.monotonic()
        self._window_chip_seconds = 0.0
        self._window_completed = 0

    def set_devices(self, devices: Sequence) -> None:
        """Count the distinct CUDA cards of ``devices`` (the engines')."""
        self.n_chips = max(1, len(cuda_indices(devices)))

    def train_window(
        self, compute_s: float, steps: int, *, examples: Optional[float] = None, step: Optional[int] = None
    ) -> Optional[Dict]:
        """The ``cost`` event fields of one training log window: its
        ``step`` span total times the chip count (None for an empty
        window)."""
        if compute_s <= 0 or steps <= 0:
            return None
        chip_s = compute_s * self.n_chips
        with self._lock:
            self.chip_seconds_total += chip_s
            total = self.chip_seconds_total
        fields: Dict = {
            "scope": "train",
            "n_chips": self.n_chips,
            "chip_seconds": round(chip_s, 6),
            "chip_seconds_total": round(total, 6),
            "chip_seconds_per_step": round(chip_s / steps, 6),
        }
        if step is not None:
            fields["step"] = step
        if examples:
            fields["examples"] = int(examples)
            fields["examples_per_chip_second"] = round(examples / chip_s, 2)
        return fields

    def add_batch(self, compute_s: float, request_examples: Sequence[int]) -> None:
        """Attribute one dispatched batch's engine time to its member
        requests by batch share (called from the batcher worker)."""
        total = sum(request_examples)
        if compute_s <= 0 or total <= 0:
            return
        chip_s = compute_s * self.n_chips
        with self._lock:
            self.chip_seconds_total += chip_s
            self._window_chip_seconds += chip_s
            self._window_completed += len(request_examples)
            self._completed_requests += len(request_examples)
        for n in request_examples:
            self._request_hist.record(chip_s * n / total)

    def serve_window(self) -> Optional[Dict]:
        """Drain one serving window into the ``cost`` event fields: window
        and cumulative chip-seconds, ``rps_per_chip``, per-request
        chip-second percentiles and the duty cycle. None for an idle
        window."""
        samples = self._request_hist.drain()
        with self._lock:
            now = time.monotonic()
            window_s = max(now - self._window_started_t, 1e-9)
            chip_s = self._window_chip_seconds
            completed = self._window_completed
            total = self.chip_seconds_total
            self._window_started_t = now
            self._window_chip_seconds = 0.0
            self._window_completed = 0
        if not completed:
            return None
        fields: Dict = {
            "scope": "serve",
            "n_chips": self.n_chips,
            "window_s": round(window_s, 3),
            "chip_seconds": round(chip_s, 6),
            "chip_seconds_total": round(total, 6),
            "requests": completed,
            "rps_per_chip": round(completed / window_s / self.n_chips, 3),
            "duty_cycle": round(chip_s / (window_s * self.n_chips), 4),
        }
        if samples:
            arr = np.asarray(list(samples), np.float64)
            count = window_count(samples)
            fields["chip_seconds_per_request"] = {
                "mean": round(window_total_s(samples) / max(count, 1), 9),
                "p50": round(float(np.percentile(arr, 50)), 9),
                "p90": round(float(np.percentile(arr, 90)), 9),
                "p99": round(float(np.percentile(arr, 99)), 9),
            }
        return fields

    def snapshot(self) -> Dict:
        """The /metrics view (cumulative; rates belong to windows)."""
        with self._lock:
            out = {"n_chips": self.n_chips, "chip_seconds_total": round(self.chip_seconds_total, 6)}
            if self._completed_requests:
                out["completed_requests"] = self._completed_requests
        return out


def aggregate_cost_events(events: List[Dict]) -> Optional[Dict]:
    """Report-side aggregation of a ledger's ``cost`` events: one dict with
    ``train`` / ``serve`` sub-sections (stable keys — the ``telemetry-report
    --json`` schema). None when the run ledgered no cost."""
    cost = [e for e in events if e.get("event") == COST_EVENT]
    if not cost:
        return None
    out: Dict = {"events": len(cost)}
    train = [e for e in cost if e.get("scope") == "train"]
    serve = [e for e in cost if e.get("scope") == "serve"]
    if train:
        last = train[-1]
        total_chip_s = last.get("chip_seconds_total", 0.0)
        steps = sum(
            e.get("chip_seconds", 0.0) / e["chip_seconds_per_step"]
            for e in train
            if e.get("chip_seconds_per_step")
        )
        section: Dict = {
            "n_chips": last.get("n_chips"),
            "chip_seconds_total": round(total_chip_s, 3),
        }
        if steps:
            section["chip_seconds_per_step"] = round(
                sum(e.get("chip_seconds", 0.0) for e in train) / steps, 6
            )
        examples = sum(e.get("examples", 0) for e in train)
        window_chip_s = sum(e.get("chip_seconds", 0.0) for e in train)
        if examples and window_chip_s:
            section["examples_per_chip_second"] = round(
                examples / window_chip_s, 2
            )
        out["train"] = section
    if serve:
        last = serve[-1]
        window_s = sum(e.get("window_s", 0.0) for e in serve)
        requests = sum(e.get("requests", 0) for e in serve)
        n_chips = last.get("n_chips") or 1
        section = {
            "n_chips": n_chips,
            "chip_seconds_total": round(
                last.get("chip_seconds_total", 0.0), 3
            ),
            "requests": requests,
        }
        if window_s:
            section["rps_per_chip"] = round(
                requests / window_s / n_chips, 3
            )
            section["duty_cycle"] = round(
                sum(e.get("chip_seconds", 0.0) for e in serve)
                / (window_s * n_chips),
                4,
            )
        per_req = [
            e["chip_seconds_per_request"]
            for e in serve
            if "chip_seconds_per_request" in e
        ]
        if per_req:
            weights = [e.get("requests", 1) for e in serve if "chip_seconds_per_request" in e]
            total_w = sum(weights) or 1

            def merged(key: str) -> float:
                return sum(
                    s[key] * w for s, w in zip(per_req, weights)
                ) / total_w

            section["chip_seconds_per_request"] = {
                "mean": round(merged("mean"), 9),
                "p50": round(merged("p50"), 9),
                "p90": round(merged("p90"), 9),
                # percentile merging across windows is approximate everywhere
                # else in the report (step_time_ms) — worst window for p99
                "p99_worst_window": round(max(s["p99"] for s in per_req), 9),
            }
        out["serve"] = section
    return out


def aggregate_watermark_events(events: List[Dict]) -> Optional[Dict]:
    """``memory_watermark`` events as per-phase final peaks, the global peak
    and the last headroom fields; None when there are none (CPU runs)."""
    marks = [e for e in events if e.get("event") == WATERMARK_EVENT]
    if not marks:
        return None
    phases: Dict[str, Dict] = {}
    for e in marks:
        row = {"peak_bytes": e.get("peak_bytes", 0)}
        if e.get("step") is not None:
            row["step"] = e["step"]
        phases[e.get("phase", "unknown")] = row
    last = marks[-1]
    out: Dict = {"events": len(marks), "peak_bytes": max(e.get("peak_bytes", 0) for e in marks), "phases": phases}
    for key in ("bytes_limit", "headroom_frac", "predicted_bytes_per_device", "measured_minus_predicted_bytes"):
        if last.get(key) is not None:
            out[key] = last[key]
    return out
