"""Stdlib HTTP front end (counterpart of the JAX package's ``serve/server.py``):

    POST /v1/predict   {"instances": [[...], ...], "deadline_ms": 250, "model": "name"}
                    -> {"predictions": {...}, "n": k}
    GET  /healthz      {"ok": true, "status": "ok|degraded|draining", "artifact": {...}, ...}
    GET  /metrics      live registry snapshot + bucket hits + queue depth (JSON;
                       Prometheus text under ``Accept: text/plain`` or
                       ``?format=prometheus``)
    GET  /admin/profile?seconds=N   a timed torch.profiler capture (202)

A ``ThreadingHTTPServer``: handler threads block on their request's future
while each model's micro-batcher worker runs it. Every ``/v1/predict``
answer, errors included, echoes ``x-request-id`` (the client's, or a minted
one), which is also the request's trace id. Errors are structured —
``{"error": {"code", "message", "request_id"}}`` with 400 malformed input,
404 unknown model, 413 over the largest bucket, 429 queue full (with
``Retry-After``), 503 draining, 504 deadline.

Multi-tenant: the constructor's engine and batcher are the primary model
(``model``, default :data:`~.registry.DEFAULT_MODEL`, which requests without
a ``"model"`` key resolve to); :meth:`ServingServer.add_model` mounts more,
each with its own metrics registry and SLO.

Observability, with the JAX package's event names and fields
(``docs/LEDGER_SCHEMA.md``): every ``window_secs`` (and at shutdown, with
``final: true`` and then ``run_end``) a ``serve_window`` event carries the
cumulative counters, that window's queue-wait / pad / compute / request
latency percentiles, the post-warmup first-run count, and per tenant the
same; with it a ``cost`` event (chip-seconds per request) and a
device-memory watermark sample that feeds the headroom monitor. With
``slo_p99_ms`` each tenant's latency feeds an SLO error budget: a breach
ledgers a ``health_alert``, degrades ``/healthz`` and triggers one
rate-limited postmortem profile. The capture and drift tees observe the
primary model's answered requests only.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
from tensorflowdistributedlearning_tpu_torch.obs import health as health_lib
from tensorflowdistributedlearning_tpu_torch.obs import ledger as ledger_lib
from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
from tensorflowdistributedlearning_tpu_torch.obs.metrics import SampleWindow, time_summary, window_count
from tensorflowdistributedlearning_tpu_torch.obs.profiler import ContinuousProfiler
from tensorflowdistributedlearning_tpu_torch.obs.telemetry import NULL_TELEMETRY
from tensorflowdistributedlearning_tpu_torch.resilience import faults as faults_lib
from tensorflowdistributedlearning_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
    RequestTooLargeError,
    ServerClosedError,
)
from tensorflowdistributedlearning_tpu_torch.serve.engine import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.serve.registry import DEFAULT_MODEL

logger = logging.getLogger(__name__)

# counters a serve_window carries (cumulative since the server started)
_WINDOW_COUNTERS = (
    "requests",
    "completed",
    "rejected_queue_full",
    "deadline_exceeded",
    "errors",
    "batches",
    "batched_examples",
)
# latency histograms drained each window; "request" is the handler's
# end-to-end latency, what the SLO budgets against
_WINDOW_HISTOGRAMS = ("queue_wait", "pad", "compute", "request")

# Retry-After bounds (seconds) and the default with no observed drain yet
_RETRY_AFTER_MIN_S = 1
_RETRY_AFTER_MAX_S = 30
_RETRY_AFTER_DEFAULT_S = 5


def bind_ephemeral(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Bind (without listening) a TCP socket; ``port=0`` picks a free port
    the caller can read back before building telemetry and the server
    around it."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.bind((host, port))
    except OSError:
        sock.close()
        raise
    return sock


class _ModelRuntime:
    """One tenant: its engine (and metrics registry), batcher, version and
    SLO tracker."""

    def __init__(
        self,
        name: str,
        engine: InferenceEngine,
        batcher: MicroBatcher,
        *,
        version: int = 1,
        slo: Optional[health_lib.SloTracker] = None,
    ):
        self.name = name
        self.engine = engine
        self.batcher = batcher
        self.version = int(version)
        self.slo = slo

    @property
    def status(self) -> str:
        if self.slo is not None and not self.slo.healthy:
            return "degraded"
        return "ok"


class ServingServer:
    """Engines + batchers behind a ThreadingHTTPServer, with ledger windows."""

    def __init__(
        self,
        engine: InferenceEngine,
        batcher: MicroBatcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        telemetry=None,
        window_secs: float = 30.0,
        result_timeout_s: float = 60.0,
        slo_p99_ms: Optional[float] = None,
        slo_error_budget: float = 0.01,
        replica_id: int = 0,
        sock: Optional[socket.socket] = None,
        model: str = DEFAULT_MODEL,
        registry_version: Optional[int] = None,
        capture=None,
        drift_monitor=None,
    ):
        self.engine = engine
        self.batcher = batcher
        self.capture = capture
        self.drift = drift_monitor
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.window_secs = float(window_secs)
        self.result_timeout_s = float(result_timeout_s)
        self.replica_id = int(replica_id)
        self.slo = health_lib.SloTracker(slo_p99_ms, error_budget=slo_error_budget) if slo_p99_ms is not None else None
        self._primary = _ModelRuntime(
            model, engine, batcher, version=registry_version if registry_version is not None else 1, slo=self.slo
        )
        self.models: Dict[str, _ModelRuntime] = collections.OrderedDict({model: self._primary})
        # spawned from a registry entry: /healthz identity carries model + version
        self._versioned = registry_version is not None
        self.headroom = health_lib.HeadroomMonitor()
        # a server on the disabled (process-global) telemetry keeps meters of
        # its own, so two such servers never share one window
        self.cost_meter = self.telemetry.cost if self.telemetry.enabled else capacity_lib.CostMeter()
        self.batcher.cost_meter = self.cost_meter
        self.watermarks = self.telemetry.watermarks if self.telemetry.enabled else capacity_lib.WatermarkTracker()
        self._count_devices()
        self._last_cost: Dict = {}
        self.profiler = ContinuousProfiler(self.telemetry)
        if self.telemetry.enabled:
            self.telemetry.set_profiler(self.profiler)
        if self.slo is not None and self.window_secs <= 0:
            logger.warning(
                "SLO tracking with window_secs=0: the error budget is evaluated only when a window is emitted "
                "(shutdown, or emit_window()); set a positive --window-secs for live health_alert events"
            )
        self.draining = False
        self._started_t = time.time()
        self._stop = threading.Event()  # stops the window ticker
        self._done = threading.Event()  # set once the drain has finished
        self._shutdown_lock = threading.Lock()
        self._shut_down = False
        # POSTs whose handler has not returned: a request's latency sample
        # and trace span land after its answer, and the final window waits
        # for them
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        # (monotonic_t, cumulative completed): the drain rate Retry-After uses
        self._drain_samples: Deque[Tuple[float, int]] = collections.deque(maxlen=64)
        self._drain_lock = threading.Lock()
        handler = type("Handler", (_Handler,), {"ctx": self})
        self._httpd = ThreadingHTTPServer((host, port), handler, bind_and_activate=False)
        self._httpd.request_queue_size = max(128, batcher.max_queue)
        if sock is not None:
            self._httpd.socket.close()
            self._httpd.socket = sock
            bound_host, bound_port = sock.getsockname()[:2]
            self._httpd.server_address = (bound_host, bound_port)
            self._httpd.server_name = socket.getfqdn(bound_host)
            self._httpd.server_port = bound_port
        else:
            self._httpd.allow_reuse_address = True
            self._httpd.server_bind()
        self._httpd.server_activate()
        self._httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None
        self._ticker: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._serve_thread.start()
        start_fields: Dict = {}
        if len(self.models) > 1 or self._versioned:
            start_fields["models"] = {name: rt.version for name, rt in self.models.items()}
        self.telemetry.event(
            "serve_start",
            endpoint=self.url,
            replica=self.replica_id,
            buckets=list(self.engine.buckets),
            max_batch_size=self.batcher.max_batch_size,
            max_wait_ms=self.batcher.max_wait_s * 1000,
            max_queue=self.batcher.max_queue,
            **start_fields,
        )
        if self.window_secs > 0:
            self._ticker = threading.Thread(target=self._tick, name="serve-window-ticker", daemon=True)
            self._ticker.start()
        logger.info("serving on %s (buckets %s)", self.url, self.engine.buckets)
        return self

    def wait(self) -> None:
        """Block until ``shutdown()`` has finished (the CLI foreground)."""
        self._done.wait()

    def install_signal_handlers(self, signals=None) -> None:
        """SIGTERM/SIGINT drain the server from a helper thread (the handler
        must return to the main thread's ``wait``). Chains with the handlers
        already installed: the ledger's flusher (``obs/ledger.py``) keeps its
        flush, here, and the call of the handler it replaced, but not its
        re-raise, which the drain replaces; any other handler still runs.
        Main thread only."""
        import signal as signal_lib

        for sig in signals or (signal_lib.SIGINT, signal_lib.SIGTERM):
            prev = signal_lib.getsignal(sig)
            if prev is ledger_lib.sigterm_flush:
                prev = ledger_lib.chained_sigterm()

            def handle(signum, frame, prev=prev):
                ledger_lib.flush_all_ledgers(blocking=False)
                threading.Thread(target=self.shutdown, name="serve-drain", daemon=True).start()
                if callable(prev) and prev is not signal_lib.default_int_handler:
                    prev(signum, frame)

            signal_lib.signal(sig, handle)

    def add_model(
        self,
        name: str,
        engine: InferenceEngine,
        batcher: MicroBatcher,
        *,
        version: int = 1,
        slo_p99_ms: Optional[float] = None,
        slo_error_budget: float = 0.01,
    ) -> _ModelRuntime:
        """Mount another tenant (before :meth:`start`); its engine must carry
        its own ``MetricsRegistry``."""
        if name in self.models:
            raise ValueError(f"model {name!r} already mounted")
        if engine.registry is self.engine.registry:
            raise ValueError(
                f"model {name!r}: each tenant needs its own MetricsRegistry "
                "(shared instruments cross-contaminate per-model windows)"
            )
        slo = health_lib.SloTracker(slo_p99_ms, error_budget=slo_error_budget) if slo_p99_ms is not None else None
        runtime = _ModelRuntime(name, engine, batcher, version=version, slo=slo)
        # chip-seconds belong to the chips: one meter per replica
        batcher.cost_meter = self.cost_meter
        self.models[name] = runtime
        self._count_devices()
        return runtime

    def _count_devices(self) -> None:
        """Cost and watermarks count the cards the tenants' engines run on,
        not every card the process sees."""
        devices = [rt.engine.device for rt in self.models.values() if rt.engine.device is not None]
        self.cost_meter.set_devices(devices)
        self.watermarks.devices = devices or None

    def model_runtime(self, name: Optional[str]) -> Optional[_ModelRuntime]:
        """A request's model: absent -> the primary, unknown -> None."""
        if name is None:
            return self._primary
        return self.models.get(name)

    def queue_depth_total(self) -> int:
        return sum(rt.engine.registry.gauge("serve/queue_depth").value or 0 for rt in self.models.values())

    def _counter_total(self, name: str) -> int:
        return sum(rt.engine.registry.counter(f"serve/{name}").value for rt in self.models.values())

    @property
    def health_status(self) -> str:
        """"draining" > "degraded" (any tenant's SLO budget blown, or
        device-memory headroom at risk) > "ok"."""
        if self.draining:
            return "draining"
        if any(rt.slo is not None and not rt.slo.healthy for rt in self.models.values()):
            return "degraded"
        if self.headroom.degraded:
            return "degraded"
        return "ok"

    def artifact_identity(self) -> Optional[Dict]:
        """What this replica serves: the manifest's dtype and source
        fingerprint, plus model and registry version when spawned from a
        registry entry; None for a raw closure."""
        q = self.engine.quantization
        identity: Dict = {}
        if q is not None:
            identity = {"dtype": q.get("dtype"), "source_fingerprint": q.get("source_fingerprint")}
        if self._versioned:
            identity["model"] = self._primary.name
            identity["registry_version"] = self._primary.version
        return identity or None

    def note_drain_progress(self) -> None:
        """Sample the completed counter (at most ~5 Hz) for Retry-After."""
        now = time.monotonic()
        with self._drain_lock:
            if self._drain_samples and now - self._drain_samples[-1][0] < 0.2:
                return
            self._drain_samples.append((now, self._counter_total("completed")))

    def retry_after_s(self) -> int:
        """Queue depth / the drain rate of the last ~10 s, clamped to
        [1, 30] s; a default when nothing has drained yet."""
        depth = self.queue_depth_total()
        now = time.monotonic()
        completed = self._counter_total("completed")
        rate = 0.0
        with self._drain_lock:
            while self._drain_samples and now - self._drain_samples[0][0] > 10.0:
                self._drain_samples.popleft()
            if self._drain_samples:
                t0, c0 = self._drain_samples[0]
                if now - t0 >= 0.05 and completed > c0:
                    rate = (completed - c0) / (now - t0)
        if rate <= 0.0:
            return _RETRY_AFTER_DEFAULT_S
        return int(min(max(math.ceil(depth / rate), _RETRY_AFTER_MIN_S), _RETRY_AFTER_MAX_S))

    def models_snapshot(self) -> Dict[str, Dict]:
        """Per-tenant live view: version, status, backlog, counters, p99."""
        out: Dict[str, Dict] = {}
        for name, rt in self.models.items():
            reg = rt.engine.registry
            row: Dict = {
                "version": rt.version,
                "status": rt.status,
                "queue_depth": reg.gauge("serve/queue_depth").value or 0,
                "requests": reg.counter("serve/requests").value,
                "completed": reg.counter("serve/completed").value,
                "rejected_queue_full": reg.counter("serve/rejected_queue_full").value,
            }
            hist = reg.histogram("serve/request")
            if len(hist):
                row["p99_ms"] = round(hist.summary().get("p99_s", 0.0) * 1000, 3)
            if rt.slo is not None:
                row["slo"] = rt.slo.snapshot()
            if rt.engine.quantization is not None:
                row["serving_dtype"] = rt.engine.quantization.get("dtype")
            out[name] = row
        return out

    def metrics_snapshot(self) -> Dict:
        """The JSON ``/metrics`` body."""
        reg = self.engine.registry
        snapshot = {
            "uptime_s": round(time.time() - self._started_t, 3),
            "draining": self.draining,
            "status": self.health_status,
            "buckets": {str(b): n for b, n in self.engine.bucket_hits.items()},
            "padding_waste": {str(b): w for b, w in self.engine.padding_waste.items()},
            "queue_depth": self.queue_depth_total(),
            # histograms here are "since the last ledger window"
            "registry": reg.snapshot(),
            "models": self.models_snapshot(),
        }
        if self.slo is not None:
            snapshot["slo"] = self.slo.snapshot()
        if self.engine.quantization is not None:
            snapshot["serving_dtype"] = self.engine.quantization.get("dtype")
        snapshot["artifact"] = self.artifact_identity()
        snapshot["cost"] = self.cost_meter.snapshot()
        if self._last_cost:
            snapshot["cost"]["last_window"] = self._last_cost
        memory = self.watermarks.snapshot()
        if memory.get("peak_bytes"):
            snapshot["memory"] = memory
        return snapshot

    def prometheus_text(self) -> str:
        """The Prometheus ``/metrics`` body: the primary registry rendered
        with server state refreshed into gauges first, then per-tenant
        series labelled ``{model=, version=}``."""
        reg = self.engine.registry
        reg.gauge("serve/uptime_s").set(time.time() - self._started_t)
        reg.gauge("serve/draining").set(1.0 if self.draining else 0.0)
        reg.gauge("serve/healthy").set(1.0 if self.health_status == "ok" else 0.0)
        if self.slo is not None:
            reg.gauge("serve/slo_p99_target_ms").set(self.slo.p99_target_ms)
        cost = self.cost_meter.snapshot()
        reg.gauge("serve/chip_seconds_total").set(cost.get("chip_seconds_total", 0.0))
        # an idle window overwrites the last busy window's rates with zero
        reg.gauge("serve/rps_per_chip").set(self._last_cost.get("rps_per_chip", 0.0))
        reg.gauge("serve/cost_duty_cycle").set(self._last_cost.get("duty_cycle", 0.0))
        per_req = self._last_cost.get("chip_seconds_per_request") or {}
        reg.gauge("serve/chip_seconds_per_request_p99").set(per_req.get("p99", 0.0))
        memory = self.watermarks.snapshot()
        if memory.get("peak_bytes"):
            reg.gauge("serve/hbm_peak_bytes").set(memory["peak_bytes"])
            headroom = memory.get("headroom") or {}
            if headroom.get("headroom_frac") is not None:
                reg.gauge("serve/hbm_headroom_frac").set(headroom["headroom_frac"])
            if memory.get("bytes_limit"):
                reg.gauge("serve/hbm_bytes_limit").set(memory["bytes_limit"])
        return reg.render_prometheus() + self._prometheus_model_text()

    _MODEL_PROM_COUNTERS = ("requests", "completed", "rejected_queue_full", "deadline_exceeded", "errors")

    def _prometheus_model_text(self) -> str:
        lines = []
        labeled = [(f'model="{name}",version="{rt.version}"', rt) for name, rt in self.models.items()]
        for metric in self._MODEL_PROM_COUNTERS:
            pname = f"tfdl_serve_model_{metric}_total"
            lines.append(f"# TYPE {pname} counter")
            for labels, rt in labeled:
                lines.append(f"{pname}{{{labels}}} {rt.engine.registry.counter(f'serve/{metric}').value}")
        lines.append("# TYPE tfdl_serve_model_queue_depth gauge")
        for labels, rt in labeled:
            depth = rt.engine.registry.gauge("serve/queue_depth").value or 0
            lines.append(f"tfdl_serve_model_queue_depth{{{labels}}} {depth}")
        lines.append("# TYPE tfdl_serve_model_request_seconds summary")
        for labels, rt in labeled:
            hist = rt.engine.registry.histogram("serve/request")
            if not len(hist):
                continue
            summary = hist.summary()
            for q, key in ((0.5, "p50_s"), (0.9, "p90_s"), (0.99, "p99_s")):
                if key in summary:
                    lines.append(f'tfdl_serve_model_request_seconds{{{labels},quantile="{q}"}} {summary[key]:.10g}')
        return "\n".join(lines) + "\n"

    @staticmethod
    def _latency_row(samples) -> Dict:
        summary = time_summary(samples)
        row = {k[:-2] + "_ms": round(v * 1000, 3) for k, v in summary.items() if k.endswith("_s") and k != "total_s"}
        row["count"] = float(window_count(samples))
        return row

    def emit_window(self, final: bool = False) -> Dict:
        """One ``serve_window`` event: the counters summed over the tenants,
        this window's latency split, the post-warmup first-run count, and a
        ``models`` row per tenant when there are several. Each tenant's SLO
        budget is evaluated on its own window; a breach ledgers a
        ``health_alert`` and triggers one postmortem capture."""
        fields: Dict = {k: self._counter_total(k) for k in _WINDOW_COUNTERS}
        fields["replica"] = self.replica_id
        fields["queue_depth"] = self.queue_depth_total()
        fields["bucket_hits"] = {str(b): n for b, n in self.engine.bucket_hits.items()}
        waste = self.engine.padding_waste
        if waste:
            fields["padding_waste"] = {str(b): w for b, w in waste.items()}
        if self.engine.quantization is not None:
            fields["serving_dtype"] = self.engine.quantization.get("dtype")
        combined: Dict[str, list] = {}
        models_field: Dict[str, Dict] = {}
        multi = len(self.models) > 1
        for name, rt in self.models.items():
            reg = rt.engine.registry
            mrow: Dict = {"version": rt.version, **{k: reg.counter(f"serve/{k}").value for k in _WINDOW_COUNTERS}}
            mrow["queue_depth"] = reg.gauge("serve/queue_depth").value or 0
            mlat: Dict = {}
            for hname in _WINDOW_HISTOGRAMS:
                samples = reg.histogram(f"serve/{hname}").drain()
                if samples:
                    combined.setdefault(hname, []).append(samples)
                    mlat[hname] = self._latency_row(samples)
            if mlat:
                mrow["latency_ms"] = mlat
            if rt.slo is not None:
                verdict = rt.slo.evaluate()
                if verdict is not None:
                    verdict.setdefault("alert_id", trace_lib.new_id())
                    if multi:
                        verdict.setdefault("model", name)
                    self.telemetry.event(health_lib.HEALTH_ALERT_EVENT, **verdict)
                    if not verdict.get("resolved"):
                        self.profiler.trigger(verdict, seconds=2.0)
                mrow["slo"] = rt.slo.snapshot()
            if rt.engine.quantization is not None:
                mrow["serving_dtype"] = rt.engine.quantization.get("dtype")
            models_field[name] = mrow
        latency: Dict = {}
        for hname, windows in combined.items():
            merged = windows[0] if len(windows) == 1 else SampleWindow(
                [s for w in windows for s in w],
                sum(window_count(w) for w in windows),
                sum(getattr(w, "total_s", 0.0) for w in windows),
            )
            latency[hname] = self._latency_row(merged)
        if latency:
            fields["latency_ms"] = latency
        detector = self.telemetry.detector
        if detector is not None:
            fields["recompiles_post_warmup"] = detector.post_warmup_count
        if self.slo is not None:
            fields["slo"] = self.slo.snapshot()
        if self.capture is not None:
            # capture loss is never silent: the drop count rides every window
            fields["tee_dropped"] = self.capture.total_dropped
            if self.capture.active() or final:
                from tensorflowdistributedlearning_tpu_torch.loop.capture import CAPTURE_WINDOW_EVENT

                snap = self.capture.window_snapshot()
                if final:
                    snap["final"] = True
                self.telemetry.event(CAPTURE_WINDOW_EVENT, replica=self.replica_id, **snap)
        if self.drift is not None:
            verdict = self.drift.evaluate()
            if verdict is not None:
                verdict.setdefault("alert_id", trace_lib.new_id())
                verdict["replica"] = self.replica_id
                self.telemetry.event(health_lib.DRIFT_ALERT_EVENT, **verdict)
            fields["drift"] = self.drift.snapshot()
        if multi:
            fields["models"] = models_field
        elif self._versioned:
            fields["model"] = self._primary.name
            fields["model_version"] = self._primary.version
        if final:
            fields["final"] = True
        self.telemetry.event("serve_window", **fields)
        self._emit_capacity_window()
        return fields

    def _emit_capacity_window(self) -> None:
        """A device-memory watermark sample (fed to the headroom monitor)
        and one ``cost`` event draining the window's chip-seconds."""
        if self.telemetry.enabled:
            self.telemetry.sample_watermark(capacity_lib.PHASE_INFER)
        else:
            self.watermarks.sample(capacity_lib.PHASE_INFER)
        headroom = self.watermarks.headroom()
        if headroom and headroom.get("bytes_limit"):
            alert = self.headroom.check(
                None, headroom["peak_bytes"], headroom["bytes_limit"], samples_to_limit=headroom.get("samples_to_limit")
            )
            if alert:
                alert["replica"] = self.replica_id
                self.telemetry.event(health_lib.HEALTH_ALERT_EVENT, **alert)
        cost = self.cost_meter.serve_window()
        if cost:
            cost["replica"] = self.replica_id
            self._last_cost = cost
            self.telemetry.event(capacity_lib.COST_EVENT, **cost)
        else:
            self._last_cost = {}  # an idle window's rates are zero, not the last busy window's

    def _tick(self) -> None:
        while not self._stop.wait(self.window_secs):
            try:
                self.emit_window()
            except Exception:  # noqa: BLE001 — telemetry never kills serving
                logger.exception("serve window emission failed")

    def shutdown(self) -> None:
        """Graceful drain: refuse new work, finish accepted requests, seal the
        capture, write the final window and ``run_end``, stop the listener.
        Idempotent; a second call waits for the first to finish."""
        with self._shutdown_lock:
            first = not self._shut_down
            self._shut_down = True
        if not first:
            self._done.wait()
            return
        self.draining = True
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5)
        for rt in self.models.values():
            rt.batcher.close(drain=True)
        with self._inflight_cond:
            self._inflight_cond.wait_for(lambda: self._inflight == 0, timeout=30)
        if self.capture is not None:
            try:
                self.capture.close()
            except Exception:  # noqa: BLE001
                logger.warning("capture tee close failed", exc_info=True)
        try:
            final = self.emit_window(final=True)
        except Exception:  # noqa: BLE001
            logger.exception("final serve window emission failed")
            final = {}
        try:
            self.profiler.close()
        except Exception:  # noqa: BLE001
            logger.warning("profiler close failed", exc_info=True)
        self.telemetry.close(
            kind="serve",
            requests=final.get("requests"),
            completed=final.get("completed"),
            rejected_queue_full=final.get("rejected_queue_full"),
            deadline_exceeded=final.get("deadline_exceeded"),
        )
        # BaseServer.shutdown() waits on an event only serve_forever sets
        if self._serve_thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        self._done.set()
        logger.info("serving stopped (drained)")


class _Handler(BaseHTTPRequestHandler):
    ctx: ServingServer  # bound by ServingServer via a subclass attribute
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    _request_id: Optional[str] = None
    # the tenant the in-flight POST resolved to (a connection's requests are
    # sequential, so an instance attribute is safe)
    _runtime = None

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _json(self, status: int, payload: Dict, extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._request_id:
            self.send_header("x-request-id", self._request_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, status: int, body: str, content_type: str) -> None:
        raw = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _error(self, status: int, code: str, message: str, retry_after: Optional[int] = None) -> int:
        error: Dict = {"code": code, "message": message}
        if self._request_id:
            error["request_id"] = self._request_id
        headers = None
        if retry_after is not None:
            error["retry_after_s"] = int(retry_after)
            headers = {"Retry-After": str(int(retry_after))}
        self._json(status, {"error": error}, extra_headers=headers)
        return status

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        # keep-alive reuses handlers: a GET must not echo an earlier POST's id
        self._request_id = None
        parsed = urllib.parse.urlparse(self.path)
        ctx = self.ctx
        if parsed.path == "/healthz":
            server_status = ctx.health_status
            body = {
                "ok": server_status == "ok",
                "status": server_status,
                "replica": ctx.replica_id,
                "draining": ctx.draining,
                "uptime_s": round(time.time() - ctx._started_t, 3),
                "buckets": list(ctx.engine.buckets),
                "artifact": ctx.artifact_identity(),
            }
            if ctx.slo is not None:
                body["slo"] = ctx.slo.snapshot()
            if len(ctx.models) > 1 or ctx._versioned:
                body["models"] = {name: {"version": rt.version, "status": rt.status} for name, rt in ctx.models.items()}
            if ctx.headroom.last is not None:
                body["memory"] = dict(ctx.headroom.last, degraded=ctx.headroom.degraded)
            self._json(503 if ctx.draining else 200, body)
        elif parsed.path == "/metrics":
            query = urllib.parse.parse_qs(parsed.query)
            accept = self.headers.get("Accept", "")
            if query.get("format", [""])[0] == "prometheus" or "text/plain" in accept or "openmetrics" in accept:
                self._text(200, ctx.prometheus_text(), "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._json(200, ctx.metrics_snapshot())
        elif parsed.path == "/admin/profile":
            # 202 at once; the roofline lands in the ledger when the capture
            # ends; 409 while another capture runs
            query = urllib.parse.parse_qs(parsed.query)
            try:
                seconds = float(query.get("seconds", ["1"])[0])
            except ValueError:
                self._error(400, "bad_request", "seconds must be a number")
                return
            if not 0 < seconds <= 60:
                self._error(400, "bad_request", "seconds must be in (0, 60]")
                return
            if ctx.profiler.logdir is None:
                self._error(503, "profiling_unavailable", "no telemetry workdir to write captures into")
                return
            started = ctx.profiler.capture_timed(seconds, reason="admin")
            if started is None:
                self._error(409, "capture_in_flight", "a profile capture is already running on this replica")
                return
            started["replica"] = ctx.replica_id
            self._json(202, started)
        else:
            self._error(404, "not_found", f"no route for GET {self.path}")

    def do_POST(self):  # noqa: N802
        ctx = self.ctx
        with ctx._inflight_cond:
            ctx._inflight += 1
        try:
            self._post()
        finally:
            with ctx._inflight_cond:
                ctx._inflight -= 1
                ctx._inflight_cond.notify_all()

    def _post(self) -> None:
        # the id first, so that even a 404 echoes this request's own id
        self._request_id = self.headers.get("x-request-id") or trace_lib.new_id()
        if self.path != "/v1/predict":
            self._error(404, "not_found", f"no route for POST {self.path}")
            return
        tracer = self.ctx.telemetry.tracer
        t0 = time.perf_counter()
        if tracer.enabled:
            with tracer.span(trace_lib.SPAN_REQUEST, trace_id=self._request_id) as span:
                status = self._predict(span)
                span.attrs["status"] = status
        else:
            status = self._predict(None)
        self._account_latency(status, time.perf_counter() - t0)
        self.ctx.note_drain_progress()
        # the drill seam: `serve --inject-fault sigkill@N` kills the replica
        # after its Nth answered request
        faults_lib.fire(faults_lib.SITE_REQUEST)

    def _account_latency(self, status: int, dt: float) -> None:
        """Answered requests feed their model's ``request`` histogram and
        SLO; deadline expiries count as SLO violations."""
        runtime = self._runtime or self.ctx._primary
        slo = runtime.slo
        if status == 200:
            runtime.engine.registry.histogram("serve/request").record(dt)
            if slo is not None:
                slo.observe(dt)
        elif status == 504 and slo is not None:
            slo.observe_violation()

    def _predict(self, span) -> int:
        """The /v1/predict body; returns the HTTP status it answered with.
        ``span`` is the open request span (None untraced): its context rides
        the batcher request."""
        self._runtime = None
        ctx = self.ctx
        if ctx.draining:
            return self._error(503, "draining", "server is draining; retry elsewhere", retry_after=ctx.retry_after_s())
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            instances = payload["instances"]
        except (ValueError, KeyError, TypeError) as e:
            return self._error(400, "bad_request", f"expected JSON {{'instances': [...]}}: {e}")
        model_name = payload.get("model")
        if model_name is not None and not isinstance(model_name, str):
            return self._error(400, "bad_request", "'model' must be a string")
        runtime = ctx.model_runtime(model_name)
        if runtime is None:
            return self._error(
                404, "model_unknown", f"model {model_name!r} is not served here; available: {sorted(ctx.models)}"
            )
        self._runtime = runtime
        try:
            x = np.asarray(instances, runtime.engine.input_dtype)
        except (ValueError, TypeError) as e:
            return self._error(400, "bad_request", f"instances not array-like: {e}")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None and (isinstance(deadline_ms, bool) or not isinstance(deadline_ms, (int, float))):
            return self._error(400, "bad_request", f"deadline_ms must be a number, got {deadline_ms!r}")
        try:
            request = runtime.batcher.submit(
                x, deadline_ms=deadline_ms, trace=span.context if span is not None else None
            )
            out = request.result(timeout=ctx.result_timeout_s)
        except QueueFullError as e:
            return self._error(429, "queue_full", str(e), retry_after=ctx.retry_after_s())
        except RequestTooLargeError as e:
            return self._error(413, "request_too_large", str(e))
        except ServerClosedError as e:
            return self._error(503, "draining", str(e), retry_after=ctx.retry_after_s())
        except DeadlineExceededError as e:
            return self._error(504, "deadline_exceeded", str(e))
        except TimeoutError as e:
            return self._error(504, "result_timeout", str(e))
        except ValueError as e:  # wrong example shape
            return self._error(400, "bad_request", str(e))
        except Exception as e:  # noqa: BLE001 — engine failures still answer structurally
            logger.exception("inference failed")
            return self._error(500, "internal", f"{type(e).__name__}: {e}")
        predictions = {k: np.asarray(v).tolist() for k, v in out.items()}
        self._json(200, {"predictions": predictions, "n": request.n})
        if (ctx.capture is not None or ctx.drift is not None) and runtime is ctx._primary:
            # the tees run after the answer and never turn a 200 into an error
            try:
                raw = {k: np.asarray(v) for k, v in out.items()}
                if ctx.drift is not None:
                    ctx.drift.observe(raw)
                if ctx.capture is not None:
                    ctx.capture.maybe_capture(x, raw)
            except Exception:  # noqa: BLE001
                logger.exception("capture/drift tee failed")
        return 200
