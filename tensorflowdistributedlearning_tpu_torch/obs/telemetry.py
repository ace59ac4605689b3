"""The ``Telemetry`` façade of the serve tier (the port's copy of the parts
of the JAX package's ``obs/telemetry.py`` that the server uses): a ledger
with its ``run_header`` and ``run_end``, a metrics registry, the request
tracer, the capacity and cost meters, the profiler hook and a count of the
engine's first runs. The trainers' step windows and goodput are queue A 13.

``NULL_TELEMETRY`` is the disabled instance: no workdir, no ledger, spans
near-free, so callers never branch on None.

First runs: in the JAX package each bucket is an XLA executable, and its
recompile detector counts compiles, flagging those after warmup. Eager
PyTorch compiles nothing per shape; the event that compiles in JAX is a
bucket's first run (it loads the kernels, settles cuDNN's algorithm choice
and grows the caching allocator). :class:`FirstRunDetector` counts those
under the JAX event name ``compile`` and field names, so the run's
``recompiles_post_warmup`` is the number of buckets first run after the
warm mark: 0 after a full warmup, one per cold bucket hit after
``serve --prewarm-buckets K``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Optional

from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
from tensorflowdistributedlearning_tpu_torch.obs.ledger import RunLedger, per_process_filename
from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry

logger = logging.getLogger(__name__)

COMPILE_EVENT = "compile"


def run_fingerprint(device=None) -> Dict:
    """What hardware produced this ledger: ``platform`` ``"gpu"`` with the
    card's name on CUDA (``"cpu"`` when ``device`` is the CPU or there is no
    card), the device count and ``torch_version``."""
    import torch

    on_gpu = torch.cuda.is_available() and str(device or "cuda").split(":")[0] == "cuda"
    return {
        "platform": "gpu" if on_gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "n_devices": torch.cuda.device_count() if on_gpu else 1,
        "process_index": 0,
        "process_count": 1,
        "torch_version": torch.__version__,
    }


class FirstRunDetector:
    """Counts bucket first runs (see the module docstring); ``on_event``
    gets ``(duration_s, post_warmup)`` for each."""

    def __init__(self, on_event=None):
        self._on_event = on_event
        self._lock = threading.Lock()
        self.warm = False
        self.compile_count = 0
        self.post_warmup_count = 0
        self.compile_total_s = 0.0

    def mark_warm(self) -> None:
        self.warm = True

    def note(self, duration_s: float) -> None:
        with self._lock:
            post_warmup = self.warm
            self.compile_count += 1
            self.compile_total_s += float(duration_s)
            if post_warmup:
                self.post_warmup_count += 1
        if self._on_event is not None:
            self._on_event(float(duration_s), post_warmup)


class Telemetry:
    """Per-run telemetry of one serving replica."""

    def __init__(
        self,
        workdir: Optional[str],
        *,
        run_info: Optional[Dict] = None,
        enabled: bool = True,
        trace_sample_rate: float = 0.0,
        process_index: Optional[int] = None,
        device=None,
    ):
        self.enabled = enabled and workdir is not None
        self.workdir = workdir if self.enabled else None
        self.profiler = None
        self.watermarks = capacity_lib.WatermarkTracker()
        if device is not None:
            self.watermarks.devices = [device]
        self.cost = capacity_lib.CostMeter()
        self.registry = MetricsRegistry()
        self._span_stack = []
        self._closed = False
        self.ledger: Optional[RunLedger] = None
        self.detector: Optional[FirstRunDetector] = None
        # sampled spans persist as buffered `trace` events (no flush per span)
        self.tracer = trace_lib.Tracer(
            emit=self._trace_event if self.enabled else None,
            sample_rate=trace_sample_rate if self.enabled else 0.0,
        )
        if not self.enabled:
            return
        header: Dict = {"schema_version": 1, "process_index": int(process_index or 0)}
        if process_index is None:
            # one process; an explicit index (a serve replica's id) leaves
            # the fleet size unknown and unwritten
            header["process_count"] = 1
        self.ledger = RunLedger(workdir, filename=per_process_filename(header["process_index"]))
        try:
            header["fingerprint"] = run_fingerprint(device)
        except Exception as e:  # noqa: BLE001 — the probe is best-effort
            header["fingerprint"] = {"error": str(e)[:200]}
        if run_info:
            header.update(run_info)
        self.ledger.event("run_header", **header)
        self.detector = FirstRunDetector(on_event=self._on_first_run)

    # -- spans -------------------------------------------------------------

    @property
    def current_span(self) -> str:
        return self._span_stack[-1] if self._span_stack else ""

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a named host-side phase into ``span/{name}``; also a
        ``torch.profiler`` annotation ``obs/{name}``, and a traced span when
        tracing is on."""
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        self._span_stack.append(name)
        t0 = time.perf_counter()
        try:
            with record_function(f"obs/{name}"):
                if self.tracer.enabled:
                    with self.tracer.span(name):
                        yield
                else:
                    yield
        finally:
            self.registry.histogram(f"span/{name}").record(time.perf_counter() - t0)
            self._span_stack.pop()

    # -- events ------------------------------------------------------------

    def set_profiler(self, profiler) -> None:
        """Attach a ``ContinuousProfiler``; ``close()`` finishes its capture."""
        self.profiler = profiler

    def _event(self, kind: str, /, **fields) -> None:
        if self.ledger is not None:
            self.ledger.event(kind, **fields)

    def _trace_event(self, fields: Dict) -> None:
        if self.ledger is not None:
            self.ledger.event_buffered(trace_lib.TRACE_EVENT, **fields)

    def flush(self) -> None:
        if self.ledger is not None:
            self.ledger.flush()

    def event(self, kind: str, /, **fields) -> None:
        """Append an event under this run's header."""
        self._event(kind, **fields)

    def sample_watermark(self, phase: str, step: Optional[int] = None, stats: Optional[Dict] = None) -> Optional[Dict]:
        """One allocator query attributed to ``phase``; ledgers a
        ``memory_watermark`` event when the peak advanced."""
        if not self.enabled:
            return None
        fields = self.watermarks.sample(phase, step=step, stats=stats)
        if fields:
            self._event(capacity_lib.WATERMARK_EVENT, **fields)
        return fields

    def mark_warm(self) -> None:
        """Steady state: a bucket's first run from now on is counted as a
        post-warmup recompile."""
        if self.detector is not None:
            self.detector.mark_warm()

    def _on_first_run(self, duration_s: float, post_warmup: bool) -> None:
        self._event(COMPILE_EVENT, duration_s=round(duration_s, 6), phase=self.current_span, post_warmup=post_warmup)
        if post_warmup:
            logger.warning(
                "post-warmup first run of a bucket #%d (%.3f s): a cold bucket paid its first-run cost on a request",
                self.detector.post_warmup_count, duration_s,
            )

    def close(self, **final_fields) -> None:
        """One ``run_end`` event (with the first-run counts), then close the
        ledger. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if not self.enabled:
            return
        if self.profiler is not None:
            try:
                self.profiler.close()
            except Exception:  # noqa: BLE001
                logger.warning("profiler close failed", exc_info=True)
        if self.detector is not None:
            final_fields.setdefault("recompiles_post_warmup", self.detector.post_warmup_count)
            final_fields.setdefault("compiles", self.detector.compile_count)
            final_fields.setdefault("compile_total_s", round(self.detector.compile_total_s, 3))
        self._event("run_end", **final_fields)
        if self.ledger is not None:
            self.ledger.close()


NULL_TELEMETRY = Telemetry(None, enabled=False)
