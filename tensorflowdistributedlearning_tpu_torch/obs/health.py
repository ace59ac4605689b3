"""Online health monitors of the trainers and the serve tier (the port's
copy of the JAX package's ``obs/health.py``, same alerts and fields).

The trainers' monitors, run by :class:`HealthMonitor` over every emitted
``step_window`` (``Telemetry.window_event``):

- :class:`NanGuard`: a non-finite train loss; ``warn`` alerts and goes on,
  ``abort`` alerts, then raises :class:`HealthAbortError`;
- :class:`LossSpikeDetector`: rolling median + MAD over the loss stream;
- :class:`StepTimeRegressionDetector`: a clean window's mean step time
  against the median of the first clean windows;
- :class:`DataStarvedDetector`: ``data_wait`` dominating consecutive clean
  windows.

The serve tier's:

- :class:`HeadroomMonitor`: device-memory headroom from the watermark
  stream; low headroom, or a trend that reaches the limit within
  ``horizon_samples`` samples, degrades ``/healthz`` before an OOM.
- :class:`SloTracker`: a p99 latency target as a windowed error budget;
  with budget ``b``, "p99 <= target" is "at most ``b`` of the requests over
  the target", so one fraction drives both the alert and ``/healthz``.
  Deadline expiries count as violations.
- :class:`DriftMonitor`: total-variation distance between the window's
  served class histogram and the artifact manifest's ``drift_baseline``
  (``serve/quant_check.stamp_drift_baseline``); its own event kind,
  ``drift_alert``.

Each is a transition-disciplined host state machine: one alert on
ok -> degraded, one ``resolved: true`` on recovery. Alerts carry
``monitor`` and ``severity``; the server stamps ``alert_id``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import statistics
import threading
from typing import Deque, Dict, List, Optional

import numpy as np

from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib

HEALTH_ALERT_EVENT = "health_alert"
DRIFT_ALERT_EVENT = "drift_alert"

NAN_ACTIONS = ("warn", "abort", "off")


class HealthAbortError(RuntimeError):
    """Raised by the NaN guard under ``action='abort'`` after its alert is
    ledgered: the run stops at a recorded boundary."""


class NanGuard:
    """Non-finite loss detector. ``action``: "warn" | "abort" | "off"."""

    def __init__(self, action: str = "warn"):
        if action not in NAN_ACTIONS:
            raise ValueError(f"nan_guard action must be one of {NAN_ACTIONS}, got {action!r}")
        self.action = action
        self.fired = 0

    def check(self, step: int, loss: float) -> Optional[Dict]:
        if self.action == "off" or math.isfinite(loss):
            return None
        self.fired += 1
        return {
            "monitor": "nan_loss",
            "severity": "critical" if self.action == "abort" else "warn",
            "step": step,
            # str(): NaN and Infinity are not JSON numbers
            "loss": str(loss),
            "action": self.action,
        }


class LossSpikeDetector:
    """A finite loss above ``median + threshold * scale`` of the last
    ``window`` losses, ``scale = max(MAD, rel_floor * |median|,
    abs_floor)``; spikes join the history too, so a level shift stops
    alerting once the window rolls over."""

    def __init__(self, window: int = 32, min_history: int = 8, threshold: float = 8.0, rel_floor: float = 0.02,
                 abs_floor: float = 1e-6):
        self.window = int(window)
        self.min_history = max(2, int(min_history))
        self.threshold = float(threshold)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self._history: Deque[float] = collections.deque(maxlen=self.window)

    def check(self, step: int, loss: float) -> Optional[Dict]:
        if not math.isfinite(loss):
            return None  # the NaN guard owns non-finite values
        alert = None
        if len(self._history) >= self.min_history:
            med = statistics.median(self._history)
            mad = statistics.median(abs(x - med) for x in self._history)
            scale = max(mad, self.rel_floor * abs(med), self.abs_floor)
            if loss > med + self.threshold * scale:
                alert = {
                    "monitor": "loss_spike", "severity": "warn", "step": step, "loss": round(float(loss), 6),
                    "median": round(med, 6), "mad": round(mad, 6), "threshold": self.threshold,
                }
        self._history.append(float(loss))
        return alert


class StepTimeRegressionDetector:
    """Baseline: the median mean step time of the first
    ``baseline_windows`` clean windows; one alert when a clean window's
    mean exceeds ``factor`` x baseline, one ``resolved`` on the way back.
    Dirty windows (first runs, evals, checkpoints) are skipped."""

    def __init__(self, baseline_windows: int = 5, factor: float = 1.5):
        self.baseline_windows = max(1, int(baseline_windows))
        self.factor = float(factor)
        self._warmup: List[float] = []
        self.baseline_ms: Optional[float] = None
        self.degraded = False

    def check(self, step: int, mean_ms: float, dirty: bool = False) -> Optional[Dict]:
        if dirty or mean_ms <= 0:
            return None
        if self.baseline_ms is None:
            self._warmup.append(float(mean_ms))
            if len(self._warmup) >= self.baseline_windows:
                self.baseline_ms = statistics.median(self._warmup)
            return None
        regressed = mean_ms > self.factor * self.baseline_ms
        fields = {"monitor": "step_time", "severity": "warn", "step": step, "mean_ms": round(float(mean_ms), 3),
                  "baseline_ms": round(self.baseline_ms, 3)}
        if regressed and not self.degraded:
            self.degraded = True
            return dict(fields, factor=self.factor)
        if not regressed and self.degraded:
            self.degraded = False
            return dict(fields, resolved=True)
        return None


class DataStarvedDetector:
    """Input-bound training: ``data_wait_frac`` above ``threshold`` in
    ``consecutive`` clean windows (one alert), ``resolved`` on recovery."""

    def __init__(self, threshold: float = 0.5, consecutive: int = 2):
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"data_starved threshold must be in (0, 1), got {threshold}")
        self.threshold = float(threshold)
        self.consecutive = max(1, int(consecutive))
        self._over = 0
        self.degraded = False

    def check(self, step: int, data_wait_frac: float, dirty: bool = False) -> Optional[Dict]:
        if dirty:
            return None
        starved = data_wait_frac > self.threshold
        self._over = self._over + 1 if starved else 0
        fields = {"monitor": "data_starved", "severity": "warn", "step": step,
                  "data_wait_frac": round(float(data_wait_frac), 4), "threshold": self.threshold}
        if self._over >= self.consecutive and not self.degraded:
            self.degraded = True
            return fields
        if not starved and self.degraded:
            self.degraded = False
            fields["resolved"] = True
            return fields
        return None


class HeadroomMonitor:
    """HBM headroom: is this process about to OOM?

    Consumes the watermark stream (obs/capacity.py — ``memory_watermark``
    events carry ``peak_bytes``/``bytes_limit``) and alerts on the
    ok→degraded transition when either:

    - headroom drops below ``min_headroom_frac`` of the device limit (the
      absolute floor: past it any allocation spike — a bigger eval batch, a
      fresh compile's workspace — is an OOM); or
    - the watermark TREND projects the limit will be crossed within
      ``horizon_samples`` more watermark samples (the leak/fragmentation
      case: plenty of headroom today, none next week).

    Recovery (headroom restored — e.g. a resize or cache drop) writes a
    ``resolved`` alert: one alert per transition.
    Backends with no allocator query never feed this monitor, so it stays
    healthy on CPU builds by construction. ``degraded`` is the live state a
    ``/healthz`` endpoint folds in."""

    def __init__(
        self,
        min_headroom_frac: float = 0.05,
        horizon_samples: int = 50,
    ):
        if not 0.0 < min_headroom_frac < 1.0:
            raise ValueError(
                f"min_headroom_frac must be in (0, 1), got {min_headroom_frac}"
            )
        self.min_headroom_frac = float(min_headroom_frac)
        self.horizon_samples = max(1, int(horizon_samples))
        self.degraded = False
        self.last: Optional[Dict] = None

    def check(
        self,
        step: Optional[int],
        peak_bytes: int,
        bytes_limit: Optional[int],
        samples_to_limit: Optional[int] = None,
    ) -> Optional[Dict]:
        if not bytes_limit or peak_bytes <= 0:
            return None  # no limit reported = nothing to budget against
        headroom = max(0.0, 1.0 - peak_bytes / bytes_limit)
        low = headroom < self.min_headroom_frac
        trending_out = (
            samples_to_limit is not None
            and samples_to_limit <= self.horizon_samples
        )
        self.last = {
            "headroom_frac": round(headroom, 4),
            "peak_bytes": int(peak_bytes),
            "bytes_limit": int(bytes_limit),
        }
        at_risk = low or trending_out
        fields = {
            "monitor": "hbm_headroom",
            "severity": "critical" if low else "warn",
            "headroom_frac": round(headroom, 4),
            "min_headroom_frac": self.min_headroom_frac,
            "peak_bytes": int(peak_bytes),
            "bytes_limit": int(bytes_limit),
        }
        if step is not None:
            fields["step"] = step
        if samples_to_limit is not None:
            fields["samples_to_limit"] = int(samples_to_limit)
        if at_risk and not self.degraded:
            self.degraded = True
            fields["reason"] = "low_headroom" if low else "trend"
            return fields
        if not at_risk and self.degraded:
            self.degraded = False
            fields["severity"] = "warn"
            fields["resolved"] = True
            return fields
        return None


@dataclasses.dataclass
class SloWindow:
    """One evaluation window's SLO accounting (returned by ``evaluate``)."""

    requests: int
    violations: int
    p99_ms: Optional[float]


class SloTracker:
    """Serving SLO: p99 latency target + windowed error budget.

    ``observe(latency_s)`` per answered request; ``observe_violation()`` for
    requests that failed the latency contract without producing a sample
    (deadline-exceeded, result timeouts). ``evaluate()`` — called at each
    serve ledger window — drains the window and returns an alert dict on the
    healthy→degraded transition (and a ``resolved`` dict on recovery);
    ``healthy`` is the live state ``/healthz`` reports. Windows with fewer
    than ``min_requests`` observations are ignored (an idle replica is not
    degraded)."""

    # retained latency samples per window (p99 estimation only — the budget
    # math uses exact counters), so an unevaluated tracker (idle windows, a
    # server run with windows disabled) cannot grow host memory unboundedly
    MAX_WINDOW_SAMPLES = 4096

    def __init__(
        self,
        p99_target_ms: float,
        error_budget: float = 0.01,
        min_requests: int = 20,
    ):
        if p99_target_ms <= 0:
            raise ValueError(f"p99_target_ms must be > 0, got {p99_target_ms}")
        if not 0.0 < error_budget < 1.0:
            raise ValueError(
                f"error_budget must be in (0, 1), got {error_budget}"
            )
        self.p99_target_ms = float(p99_target_ms)
        self.error_budget = float(error_budget)
        self.min_requests = max(1, int(min_requests))
        self.healthy = True
        self.last_window: Optional[SloWindow] = None
        self._lock = threading.Lock()
        self._latencies: collections.deque = collections.deque(
            maxlen=self.MAX_WINDOW_SAMPLES
        )
        self._count = 0  # exact answered requests this window
        self._over = 0  # exact over-target (incl. violation) count

    def observe(self, latency_s: float) -> None:
        latency_s = float(latency_s)
        with self._lock:
            self._latencies.append(latency_s)
            self._count += 1
            if latency_s > self.p99_target_ms / 1000.0:
                self._over += 1

    def observe_violation(self) -> None:
        with self._lock:
            self._count += 1
            self._over += 1

    def evaluate(self) -> Optional[Dict]:
        with self._lock:
            latencies = list(self._latencies)
            n, over = self._count, self._over
            self._latencies.clear()
            self._count = 0
            self._over = 0
        p99_ms = None
        if latencies:
            s = sorted(latencies)
            p99_ms = round(s[min(len(s) - 1, int(0.99 * len(s)))] * 1000, 3)
        self.last_window = SloWindow(requests=n, violations=over, p99_ms=p99_ms)
        if n < self.min_requests:
            return None
        breached = over / n > self.error_budget
        fields = {
            "monitor": "slo",
            "severity": "critical" if breached else "warn",
            "p99_target_ms": self.p99_target_ms,
            "error_budget": self.error_budget,
            "window_requests": n,
            "window_violations": over,
            "violation_frac": round(over / n, 4),
        }
        if p99_ms is not None:
            fields["window_p99_ms"] = p99_ms
        if breached and self.healthy:
            self.healthy = False
            return fields
        if not breached and not self.healthy:
            self.healthy = True
            fields["severity"] = "warn"
            fields["resolved"] = True
            return fields
        return None

    def snapshot(self) -> Dict:
        """The live view ``/healthz`` and the serve windows embed."""
        out: Dict = {
            "p99_target_ms": self.p99_target_ms,
            "error_budget": self.error_budget,
            "healthy": self.healthy,
        }
        w = self.last_window
        if w is not None:
            out["window_requests"] = w.requests
            out["window_violations"] = w.violations
            if w.p99_ms is not None:
                out["window_p99_ms"] = w.p99_ms
        return out


class DriftMonitor:
    """Serving output-distribution drift vs the export-time baseline.

    The baseline is the artifact manifest's ``drift_baseline`` section —
    ``quant_check.summarize_output_distribution`` over the pinned eval
    batch, persisted at export time so no eval re-run is needed.
    The monitor tracks the first integer-valued output it names (fit's
    serving artifacts call it ``class``): ``observe`` folds each answered
    request's class ids into a histogram, ``evaluate`` (called at serve
    ledger windows) drains it and scores the shift as total-variation
    distance ``0.5 * sum|p - q|`` in [0, 1].

    Transition-disciplined like every monitor here: one ``drift_alert``
    on ok->drifted (after ``sustain_windows`` consecutive bad windows —
    one odd traffic window is not a distribution shift), one
    ``resolved: true`` on recovery. Windows under ``min_requests`` are
    ignored: an idle replica has no distribution to compare."""

    def __init__(
        self,
        baseline: Dict,
        *,
        threshold: float = 0.35,
        min_requests: int = 20,
        sustain_windows: int = 2,
    ):
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"threshold must be in (0, 1], got {threshold}")
        if sustain_windows < 1:
            raise ValueError("sustain_windows must be >= 1")
        outputs = baseline.get("outputs") or {}
        self.output_name = None
        hist = None
        for name in sorted(outputs):
            spec = outputs[name]
            if spec.get("kind") == "integer" and spec.get("hist"):
                self.output_name, hist = name, spec["hist"]
                break
        if hist is None:
            raise ValueError(
                "drift baseline has no integer output histogram — "
                "re-export the artifact (the exporter stamps drift_baseline); "
                f"baseline outputs: {sorted(outputs)}"
            )
        total = sum(float(v) for v in hist.values()) or 1.0
        self.baseline_hist = {
            int(k): float(v) / total for k, v in hist.items()
        }
        self.threshold = float(threshold)
        self.min_requests = max(1, int(min_requests))
        self.sustain_windows = int(sustain_windows)
        self.healthy = True
        self.last_score: Optional[float] = None
        self._bad_streak = 0
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._n = 0

    def observe(self, outputs: Dict) -> None:
        """Fold one answered request's outputs; cheap (a bincount over the
        batch's class ids) and silent on shape surprises — the monitor must
        never make a 200 into a 500."""
        arr = outputs.get(self.output_name)
        if arr is None:
            return
        try:
            flat = np.asarray(arr).reshape(-1)
            with self._lock:
                for cls, cnt in zip(*np.unique(flat, return_counts=True)):
                    self._counts[int(cls)] = (
                        self._counts.get(int(cls), 0) + int(cnt)
                    )
                self._n += int(flat.size)
        except (ValueError, TypeError):
            return

    def evaluate(self) -> Optional[Dict]:
        """Drain the window; alert dict on the ok->drifted transition (or
        the resolution), None otherwise — the server ledgers it as a
        ``drift_alert`` event."""
        with self._lock:
            counts, n = self._counts, self._n
            self._counts, self._n = {}, 0
        if n < self.min_requests:
            return None
        classes = set(self.baseline_hist) | set(counts)
        score = 0.5 * sum(
            abs(counts.get(c, 0) / n - self.baseline_hist.get(c, 0.0))
            for c in classes
        )
        self.last_score = round(score, 4)
        drifted = score > self.threshold
        self._bad_streak = self._bad_streak + 1 if drifted else 0
        fields = {
            "monitor": "drift",
            "output": self.output_name,
            "score": self.last_score,
            "threshold": self.threshold,
            "window_outputs": n,
            "severity": "critical" if drifted else "warn",
        }
        if drifted and self.healthy:
            if self._bad_streak < self.sustain_windows:
                return None
            self.healthy = False
            fields["sustained_windows"] = self._bad_streak
            return fields
        if not drifted and not self.healthy:
            self.healthy = True
            fields["severity"] = "warn"
            fields["resolved"] = True
            return fields
        return None

    def snapshot(self) -> Dict:
        """The live view serve windows embed (``drift`` sub-dict)."""
        out: Dict = {
            "output": self.output_name,
            "threshold": self.threshold,
            "healthy": self.healthy,
        }
        if self.last_score is not None:
            out["score"] = self.last_score
        return out


class HealthMonitor:
    """The trainers' monitors over the window stream (``Telemetry.
    window_event`` calls :meth:`observe_window` after writing the window):
    alerts append as ``health_alert`` events with a unique ``alert_id``,
    and the NaN guard's ``abort`` raises :class:`HealthAbortError` last.
    The loss consults the fault hook (``nan-loss@N``) first."""

    def __init__(self, *, nan_action: str = "warn", spike: Optional[LossSpikeDetector] = None,
                 step_time: Optional[StepTimeRegressionDetector] = None, headroom: Optional[HeadroomMonitor] = None,
                 data_starved: Optional[DataStarvedDetector] = None):
        self.nan_guard = NanGuard(nan_action)
        self.spike = spike if spike is not None else LossSpikeDetector()
        self.step_time = step_time if step_time is not None else StepTimeRegressionDetector()
        self.headroom = headroom if headroom is not None else HeadroomMonitor()
        self.data_starved = data_starved if data_starved is not None else DataStarvedDetector()
        self.alerts: List[Dict] = []

    @classmethod
    def from_train_config(cls, tcfg) -> Optional["HealthMonitor"]:
        """The monitor a trainer runs under ``tcfg``; None when disabled."""
        if not getattr(tcfg, "health_monitors", True):
            return None
        return cls(nan_action=getattr(tcfg, "nan_guard", "warn"))

    @property
    def status(self) -> str:
        degraded = self.step_time.degraded or self.headroom.degraded or self.data_starved.degraded
        return "degraded" if degraded else "ok"

    def reset(self) -> None:
        """A fresh training phase (a new fold): drop the loss history, the
        step-time baseline and the starvation streak; alerts and the guard's
        action persist."""
        sp, st, ds = self.spike, self.step_time, self.data_starved
        self.spike = LossSpikeDetector(window=sp.window, min_history=sp.min_history, threshold=sp.threshold,
                                       rel_floor=sp.rel_floor, abs_floor=sp.abs_floor)
        self.step_time = StepTimeRegressionDetector(baseline_windows=st.baseline_windows, factor=st.factor)
        self.data_starved = DataStarvedDetector(threshold=ds.threshold, consecutive=ds.consecutive)

    def _ledger(self, telemetry, alert: Dict) -> None:
        alert.setdefault("alert_id", trace_lib.new_id())
        self.alerts.append(alert)
        telemetry.event(HEALTH_ALERT_EVENT, **alert)

    def observe_memory(self, telemetry, step: Optional[int], watermark: Dict) -> Optional[Dict]:
        """The headroom monitor on one watermark sample."""
        alert = self.headroom.check(step, watermark.get("peak_bytes", 0), watermark.get("bytes_limit"),
                                    samples_to_limit=watermark.get("samples_to_limit"))
        if alert:
            self._ledger(telemetry, alert)
        return alert

    def observe_window(self, telemetry, step: int, scalars: Dict, fields: Dict) -> List[Dict]:
        """Every monitor on one emitted window; ledgers and returns the
        alerts, then raises :class:`HealthAbortError` after a NaN alert
        under ``abort``."""
        from tensorflowdistributedlearning_tpu_torch.resilience import faults as faults_lib

        alerts: List[Dict] = []
        loss = scalars.get("loss")
        if loss is not None:
            loss = float(loss)
            if faults_lib.poisoned(faults_lib.SITE_LOSS, step):
                loss = float("nan")
            nan_alert = self.nan_guard.check(step, loss)
            if nan_alert:
                alerts.append(nan_alert)
            else:
                spike = self.spike.check(step, loss)
                if spike:
                    alerts.append(spike)
        dirty = bool(fields.get("dirty"))
        mean_ms = (fields.get("step_time_ms") or {}).get("mean_ms")
        if mean_ms is not None:
            st = self.step_time.check(step, float(mean_ms), dirty=dirty)
            if st:
                alerts.append(st)
        frac = fields.get("data_wait_frac")
        if frac is not None:
            starved = self.data_starved.check(step, float(frac), dirty=dirty)
            if starved:
                alerts.append(starved)
        for alert in alerts:
            self._ledger(telemetry, alert)
        if any(a["monitor"] == "nan_loss" and a.get("action") == "abort" for a in alerts):
            raise HealthAbortError(
                f"non-finite train loss at step {step} (nan_guard='abort'; the health_alert ledger event precedes "
                "this exit)"
            )
        return alerts
